"""Builds a CUDA source of ``syncfusion_tpu_torch/csrc`` for the CPU against
``tests/cuda_shim``: the shim's models in place of ``ptx.cuh`` and
``sm90.cuh``, each ``kernel<<<grid, threads, smem, stream>>>(...)`` launch
rewritten as a call that runs the grid block by block (a cluster launch
goes through ``launch_cluster`` of ``sm90.cuh``, whose model runs the
blocks of each cluster together), and each kernel's ``extern __shared__``
array pointed at the shim's shared window; compiled by g++ into a shared
library that ctypes loads."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from syncfusion_tpu_torch.ops import attention as ta

SHIM = Path(__file__).resolve().parent / "cuda_shim"
CSRC = Path(ta.__file__).resolve().parent.parent / "csrc"


def build(out: Path, source: str, launches: int, kernels: int | None = None) -> Path:
    """``csrc/<source>`` built for the CPU in ``out``; ``launches`` is the
    number of ``<<<...>>>`` launches the source holds and ``kernels`` the
    number of kernels with dynamic shared memory (by default as many)."""
    work = out / "csrc"
    shutil.copytree(CSRC, work)
    shutil.copy(SHIM / "ptx_model.cuh", work / "ptx.cuh")
    shutil.copy(SHIM / "sm90_model.cuh", work / "sm90.cuh")
    src = (work / source).read_text()
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"shim_launch(\2, [&] { \1(\3); });",
                     src, flags=re.S)
    assert n == launches
    src, n = re.subn(r"extern __shared__ [^;]*?(\w+)\[\];",
                     r"unsigned char* \1 = shim_dynamic_smem();", src)
    assert n == (launches if kernels is None else kernels)
    (work / source).write_text(src)
    lib = out / f"lib{Path(source).stem}_shim.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-x",
                    "c++", "-include", str(SHIM / "shim.h"), "-I", str(SHIM), "-I",
                    str(work), "-o", str(lib), str(work / source)],
                   check=True, capture_output=True, text=True)
    return lib


def load(tmp_path_factory, source: str, launches: int,
         kernels: int | None = None) -> ctypes.CDLL:
    """The shim build of ``source`` loaded, or a skip where there is no g++."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp(Path(source).stem + "_shim")
    return ctypes.CDLL(str(build(out, source, launches, kernels)))
