"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` source becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` into ``syncfusion_tpu_torch/_build/`` at
first use (a git-ignored directory).  The library's name carries a hash of
its source, of every ``csrc/*.cuh`` header (the sources share them) and of
the flags, so an edited source or header is rebuilt and a stale library is
never loaded.  All sources compile at once, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else the toolkit's default
    location, else ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library is missing; returns
    ``{source stem: library path}``.  Raises with nvcc's output on failure.
    The compiler's report (``-Xptxas=-v``: registers, shared memory,
    spills) is kept beside each library as ``<library>.log``."""
    BUILD.mkdir(exist_ok=True)
    libs = {src.stem: _target(src) for src in sorted(CSRC.glob("*.cu"))}
    jobs = {}
    for src_stem, so in libs.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{src_stem}.cu")]
        jobs[src_stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp)
    failures = []
    for src_stem, (proc, tmp) in jobs.items():
        out, _ = proc.communicate()
        so = libs[src_stem]
        if proc.returncode != 0:
            failures.append(f"{src_stem}.cu:\n{out}")
            continue
        so.with_suffix(".so.log").write_text(out)
        tmp.replace(so)  # atomic: a half-written library is never loaded
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return libs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build()[name]))
