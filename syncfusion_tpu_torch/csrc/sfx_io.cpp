// sfx_io: the data path's native host side: tar member iteration, WAV
// decode and polyphase resampling, driven from Python through ctypes
// (syncfusion_tpu_torch/data/native.py), which releases the interpreter lock
// while a call runs, so reader threads overlap with the card's work.
//
// Build: g++ -O3 -shared -fPIC sfx_io.cpp -o libsfx_io.so
// (done at first use by syncfusion_tpu_torch/data/native.py, into
// syncfusion_tpu_torch/_build/).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// tar streaming
// ---------------------------------------------------------------------------

struct SfxTar {
  FILE* f;
};

SfxTar* sfx_tar_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  SfxTar* t = new SfxTar{f};
  return t;
}

static int64_t parse_octal(const char* p, int n) {
  int64_t v = 0;
  for (int i = 0; i < n && p[i]; ++i) {
    if (p[i] >= '0' && p[i] <= '7') v = v * 8 + (p[i] - '0');
  }
  return v;
}

// Returns 1 on success (caller frees *data with sfx_free), 0 on EOF, -1 err.
int sfx_tar_next(SfxTar* t, char* name_out, int name_cap, uint8_t** data,
                 int64_t* size_out) {
  char header[512];
  for (;;) {
    size_t got = fread(header, 1, 512, t->f);
    if (got < 512) return 0;
    // two zero blocks = end of archive
    bool all_zero = true;
    for (int i = 0; i < 512; ++i)
      if (header[i]) { all_zero = false; break; }
    if (all_zero) return 0;

    char typeflag = header[156];
    int64_t size = parse_octal(header + 124, 12);

    // full member name: prefix (POSIX ustar) + '/' + name
    char name[512];
    name[0] = 0;
    if (header[345]) {
      strncat(name, header + 345, 155);
      strncat(name, "/", 2);
    }
    strncat(name, header, 100);

    int64_t padded = (size + 511) & ~511LL;
    if (typeflag != '0' && typeflag != 0) {  // skip non-regular members
      if (fseek(t->f, (long)padded, SEEK_CUR)) return -1;
      continue;
    }
    uint8_t* buf = (uint8_t*)malloc(size > 0 ? size : 1);
    if (!buf) return -1;
    if (size > 0 && fread(buf, 1, (size_t)size, t->f) != (size_t)size) {
      free(buf);
      return -1;
    }
    if (padded > size) fseek(t->f, (long)(padded - size), SEEK_CUR);
    snprintf(name_out, name_cap, "%s", name);
    *data = buf;
    *size_out = size;
    return 1;
  }
}

void sfx_tar_close(SfxTar* t) {
  if (t) {
    fclose(t->f);
    delete t;
  }
}

void sfx_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// WAV decode (PCM16/24/32 + float32) → float32 interleaved
// ---------------------------------------------------------------------------

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)(p[0] | (p[1] << 8));
}

// Returns 0 ok, -1 error. *out is malloc'd interleaved float32.
int sfx_wav_decode(const uint8_t* bytes, int64_t n, float** out,
                   int64_t* n_frames, int* channels, int* sample_rate) {
  if (n < 44 || memcmp(bytes, "RIFF", 4) || memcmp(bytes + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  int fmt = 0, chans = 0, sr = 0, bits = 0;
  const uint8_t* data = nullptr;
  int64_t data_len = 0;
  while (pos + 8 <= n) {
    uint32_t chunk_size = rd_u32(bytes + pos + 4);
    const uint8_t* body = bytes + pos + 8;
    if (!memcmp(bytes + pos, "fmt ", 4)) {
      fmt = rd_u16(body);
      chans = rd_u16(body + 2);
      sr = (int)rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt == 0xFFFE) fmt = (bits == 32) ? 3 : 1;
    } else if (!memcmp(bytes + pos, "data", 4)) {
      data = body;
      data_len = chunk_size;
      if (pos + 8 + data_len > n) data_len = n - pos - 8;
    }
    pos += 8 + chunk_size + (chunk_size & 1);
  }
  if (!data || !chans || !bits) return -1;

  int64_t total;
  if (fmt == 3 && bits == 32)
    total = data_len / 4;
  else if (fmt == 1 && bits == 16)
    total = data_len / 2;
  else if (fmt == 1 && bits == 24)
    total = data_len / 3;
  else if (fmt == 1 && bits == 32)
    total = data_len / 4;
  else
    return -1;

  float* buf = (float*)malloc(sizeof(float) * (total > 0 ? total : 1));
  if (!buf) return -1;
  if (fmt == 3) {
    memcpy(buf, data, total * 4);
  } else if (bits == 16) {
    const int16_t* s = (const int16_t*)data;
    for (int64_t i = 0; i < total; ++i) buf[i] = s[i] / 32768.0f;
  } else if (bits == 24) {
    for (int64_t i = 0; i < total; ++i) {
      int32_t v = data[3 * i] | (data[3 * i + 1] << 8) | (data[3 * i + 2] << 16);
      if (v & 0x800000) v -= 0x1000000;
      buf[i] = v / 8388608.0f;
    }
  } else {  // PCM32
    const int32_t* s = (const int32_t*)data;
    for (int64_t i = 0; i < total; ++i) buf[i] = (float)(s[i] / 2147483648.0);
  }
  *out = buf;
  *n_frames = total / chans;
  *channels = chans;
  *sample_rate = sr;
  return 0;
}

// ---------------------------------------------------------------------------
// Polyphase resampling with a caller-provided kernel bank
// (kernels built in Python: syncfusion_tpu_torch/ops/resample.py — ONE source of
// truth for the filter; C++ only does the strided dot products).
// ---------------------------------------------------------------------------

// in: (n_in) mono. kernels: (n_phases, k_size). Output length must be
// ceil(n_in * n_phases / stride_in). Matches ops/resample.py exactly.
int sfx_resample(const float* in, int64_t n_in, int stride_in, int n_phases,
                 const float* kernels, int k_size, int width, float* out,
                 int64_t n_out) {
  int64_t num_frames = n_in / stride_in + 1;
  int64_t padded_len = n_in + 2 * width + stride_in;
  float* padded = (float*)calloc(padded_len, sizeof(float));
  if (!padded) return -1;
  memcpy(padded + width, in, n_in * sizeof(float));

  int64_t o = 0;
  for (int64_t f = 0; f < num_frames && o < n_out; ++f) {
    const float* frame = padded + f * stride_in;
    for (int p = 0; p < n_phases && o < n_out; ++p, ++o) {
      const float* k = kernels + (int64_t)p * k_size;
      float acc = 0.0f;
      for (int i = 0; i < k_size; ++i) acc += frame[i] * k[i];
      out[o] = acc;
    }
  }
  free(padded);
  return 0;
}

}  // extern "C"
