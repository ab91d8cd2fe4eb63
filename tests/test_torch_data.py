"""The port's data pipeline against the JAX package's.

The same numpy code with the same seeds: batches from one shard written by
the JAX package's shard writer are bit-equal (train settings with shift
augmentation, shard and reservoir shuffle; val settings; a shard at another
sample rate, which goes through ``resample``).  ``read_wav``, ``resample``
and the int16 wire format are bit-equal to the JAX package's numpy code.
"""

import importlib
import struct
import threading

import numpy as np
import pytest
import torch

from syncfusion_tpu.data import sfx_dataset as jds
from syncfusion_tpu.data import shards as jshards
from syncfusion_tpu.ops import quantize as jquant
from syncfusion_tpu.ops import wav as jwav
from syncfusion_tpu_torch.data import sfx_dataset as tds
from syncfusion_tpu_torch.data import shards as tshards
from syncfusion_tpu_torch.data.prefetch import device_prefetch, to_device
from syncfusion_tpu_torch.ops import quantize as tquant
from syncfusion_tpu_torch.ops import resample as tres
from syncfusion_tpu_torch.ops import wav as twav
from torch_port_helpers import make_shard

# the JAX package's ops/__init__ exports a function of the same name
jres = importlib.import_module("syncfusion_tpu.ops.resample")

SETTINGS = {
    "train": dict(shift_augment=True, shardshuffle=True, one_chunk_per_track=False),
    "val": dict(shift_augment=False, shardshuffle=False, one_chunk_per_track=False),
    "one_chunk": dict(shift_augment=True, shardshuffle=False, one_chunk_per_track=True),
}


def _batches(mod, path, sr, settings, seed, shuffle_size):
    items = mod.create_sfx_dataset(path, sample_rate=sr, chunk_size=256,
                                   cut_prefix=True, seed=seed, **settings)
    return list(mod.batched(items, batch_size=3, drop_last=False,
                            shuffle_size=shuffle_size, seed=seed))


@pytest.mark.parametrize("shard_sr", [48000, 44100])
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_batches_bit_equal_to_jax(tmp_path, name, shard_sr):
    path = make_shard(tmp_path, n_tracks=4, seconds=0.05, sr=shard_sr, seed=1)
    want = _batches(jds, path, 48000, SETTINGS[name], seed=7, shuffle_size=5)
    got = _batches(tds, path, 48000, SETTINGS[name], seed=7, shuffle_size=5)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in ("wav", "onsets", "cond"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])
        assert g["text"] == w["text"] and g["filename"] == w["filename"]


def test_tar_samples_equal_jax(tmp_path):
    path = make_shard(tmp_path, n_tracks=3, seconds=0.01)
    want = list(jshards.iter_tar_samples(path, native=False))
    got = list(tshards.iter_tar_samples(path))
    assert got == want and len(got) == 3
    csv = got[0]["times.csv"]
    assert tshards.decode_times_csv(csv) == jshards.decode_times_csv(csv)


@pytest.mark.parametrize("pattern", ["a/shard_{1..3}.tar", "one.tar",
                                     ["x.tar", "y_{0..1}.tar"]])
def test_expand_shards_equal_jax(pattern):
    assert tshards.expand_shards(pattern) == jshards.expand_shards(pattern)


def test_track_shorter_than_a_chunk_raises(tmp_path):
    path = make_shard(tmp_path, n_tracks=1, seconds=0.01, onset_every=1.0)
    with pytest.raises(ValueError, match="shorter than chunk"):
        list(tds.create_sfx_dataset(path, sample_rate=48000, chunk_size=4800))


def _pcm24(x: np.ndarray, sr: int) -> bytes:
    v = np.clip(np.round(x * 8388608.0), -8388608, 8388607).astype(np.int32)
    body = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], -1)
    body = body.astype(np.uint8).tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sr, sr * 3, 3, 24)
    return (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE" + b"fmt "
            + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(body))
            + body)


@pytest.mark.parametrize("fmt", ["f32", "pcm16", "pcm24"])
def test_read_wav_equals_jax(tmp_path, fmt):
    x = np.random.default_rng(2).uniform(-0.9, 0.9, (2, 1000)).astype(np.float32)
    path = tmp_path / "a.wav"
    if fmt == "pcm24":
        path.write_bytes(_pcm24(x[0], 22050))
    else:
        twav.write_wav(path, x, 22050, fmt=fmt)
    got, sr = twav.read_wav(path)
    want, want_sr = jwav.read_wav(path.read_bytes())
    assert sr == want_sr == 22050
    np.testing.assert_array_equal(got, want)
    if fmt == "f32":
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("orig,new", [(44100, 48000), (16000, 48000),
                                      (48000, 22050), (48000, 48000)])
def test_resample_equals_jax(orig, new):
    x = np.random.default_rng(3).standard_normal((2, 3001)).astype(np.float32)
    np.testing.assert_array_equal(tres.resample(x, orig, new),
                                  jres.resample(x, orig, new))


def test_int16_wire_format_equals_jax():
    x = np.linspace(-1.5, 1.5, 1001, dtype=np.float32)
    got = tquant.float32_to_int16(x)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, jquant.float32_to_int16(x))


def test_prefetch_yields_device_tensors_in_order():
    batches = [{"wav": np.full((2, 3), i, np.float32), "text": [str(i)]}
               for i in range(5)]
    got = list(device_prefetch(iter(batches), torch.device("cpu")))
    assert [int(b["wav"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["wav"], torch.Tensor) and b["text"] == [str(i)]
               for i, b in enumerate(got))
    assert to_device({"x": np.zeros(2, np.uint8)}, torch.device("cpu"))["x"].dtype == torch.uint8


def test_prefetch_raises_the_pipeline_error():
    def broken():
        yield {"wav": np.zeros(1)}
        raise OSError("bad shard")

    stream = device_prefetch(broken(), torch.device("cpu"))
    next(stream)
    with pytest.raises(OSError, match="bad shard"):
        next(stream)


def test_prefetch_close_stops_the_thread():
    def endless():
        i = 0
        while True:
            yield {"wav": np.full(1, i)}
            i += 1

    before = threading.active_count()
    stream = device_prefetch(endless(), torch.device("cpu"), buffer_size=1)
    assert int(next(stream)["wav"][0]) == 0
    stream.close()
    assert threading.active_count() == before
