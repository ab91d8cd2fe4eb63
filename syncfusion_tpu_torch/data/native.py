"""ctypes bindings of the native I/O library ``csrc/sfx_io.cpp`` (port of
``syncfusion_tpu/data/native.py``): tar member iteration, WAV decode and
polyphase resampling.

The library is built with ``g++ -O3 -shared -fPIC`` at first use into the
git-ignored ``syncfusion_tpu_torch/_build/``, under a name that carries a
hash of the source and the flags (an edited source is rebuilt, a stale
library never loaded); the build writes a temporary file and renames it, so
processes that build at once never load a partial one.  ``available()``
says whether it built; the functions raise ``RuntimeError`` when it did
not.  ctypes releases the interpreter lock during each call.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import math
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from syncfusion_tpu_torch.ops.resample import _kernel

log = logging.getLogger(__name__)

PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE / "csrc" / "sfx_io.cpp"
BUILD = PACKAGE / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD / f"libsfx_io_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    """Compile the source into ``target``; raises with g++'s output."""
    BUILD.mkdir(exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
        tmp.replace(target)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed: {e.stderr.strip()}") from e
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    lib.sfx_tar_open.restype = ctypes.c_void_p
    lib.sfx_tar_open.argtypes = [ctypes.c_char_p]
    lib.sfx_tar_next.restype = ctypes.c_int
    lib.sfx_tar_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int64)]
    lib.sfx_tar_close.restype = None
    lib.sfx_tar_close.argtypes = [ctypes.c_void_p]
    lib.sfx_free.restype = None
    lib.sfx_free.argtypes = [ctypes.c_void_p]
    lib.sfx_wav_decode.restype = ctypes.c_int
    lib.sfx_wav_decode.argtypes = [u8p, ctypes.c_int64, ctypes.POINTER(f32p),
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.sfx_resample.restype = ctypes.c_int
    lib.sfx_resample.argtypes = [f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                 f32p, ctypes.c_int, ctypes.c_int, f32p,
                                 ctypes.c_int64]
    return lib


def load_library() -> ctypes.CDLL:
    """The library, built if needed; raises ``RuntimeError`` when it cannot
    be built (the first failure is remembered)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(f"native sfx_io unavailable: {_build_error}")
        target = library_path()
        try:
            if not target.exists():
                _build(target)
            _lib = _bind(ctypes.CDLL(str(target)))
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            log.warning("native sfx_io build failed (%s)", e)
            raise RuntimeError(f"native sfx_io unavailable: {e}") from e
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def iter_tar_members(path: str) -> Iterator[tuple[str, bytes]]:
    """Yield (member name, bytes) of a tar file's regular files."""
    lib = load_library()
    handle = lib.sfx_tar_open(str(path).encode())
    if not handle:
        raise FileNotFoundError(path)
    name_buf = ctypes.create_string_buffer(512)
    try:
        while True:
            data_ptr = ctypes.POINTER(ctypes.c_uint8)()
            size = ctypes.c_int64()
            rc = lib.sfx_tar_next(handle, name_buf, 512, ctypes.byref(data_ptr),
                                  ctypes.byref(size))
            if rc == 0:
                return
            if rc < 0:
                raise OSError(f"tar read error in {path}")
            try:
                data = ctypes.string_at(data_ptr, size.value)
            finally:
                lib.sfx_free(data_ptr)
            yield name_buf.value.decode(), data
    finally:
        lib.sfx_tar_close(handle)


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> ((channels, frames) float32, sample rate)."""
    lib = load_library()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out_ptr = ctypes.POINTER(ctypes.c_float)()
    n_frames, channels, sr = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    rc = lib.sfx_wav_decode(buf, len(data), ctypes.byref(out_ptr),
                            ctypes.byref(n_frames), ctypes.byref(channels),
                            ctypes.byref(sr))
    if rc != 0:
        raise ValueError("wav decode failed")
    total = n_frames.value * channels.value
    try:
        flat = np.ctypeslib.as_array(out_ptr, shape=(total,)).copy()
    finally:
        lib.sfx_free(out_ptr)
    return flat.reshape(n_frames.value, channels.value).T.copy(), sr.value


def resample_native(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Polyphase resample of mono (T,) float32 with ``ops/resample.py``'s
    kernel bank (one source of the filter)."""
    lib = load_library()
    kernels, width, orig, new = _kernel(orig_freq, new_freq)
    kernels = np.ascontiguousarray(kernels)
    x = np.ascontiguousarray(x, np.float32)
    n_out = int(math.ceil(new * len(x) / orig))  # as ops/resample.resample
    out = np.empty(n_out, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.sfx_resample(x.ctypes.data_as(f32p), len(x), orig, new,
                          kernels.ctypes.data_as(f32p), kernels.shape[1], width,
                          out.ctypes.data_as(f32p), n_out)
    if rc != 0:
        raise RuntimeError("native resample failed")
    return out
