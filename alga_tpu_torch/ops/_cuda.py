"""Build and load the hand-written CUDA kernels (alga_tpu_torch/csrc/*.cu).

On first use nvcc compiles the sources for sm_90a into a shared library
with a plain C interface, which ctypes loads: banded_dp.cu once,
banded_lcs.cu once per band half-width 0..MAX_E and banded_lcs_wide.cu
once per cells-per-lane of WIDE_CELLS, all at once, one nvcc process
each, then one link.  The
library goes into alga_tpu_torch/_build/ (listed in .gitignore) under a
name that carries a hash of the sources, so an edited source is
rebuilt.  Nothing is built when the module is imported: the CPU tests
import it without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

_lib = None
# filled by the build: seconds nvcc took and what ptxas reported
BUILD_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("alga_tpu_torch: nvcc not found (set CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def _run(cmd: list) -> str:
    """stderr of a successful nvcc run; raises with its output otherwise."""
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"alga_tpu_torch: nvcc failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}\n{res.stderr}")
    return res.stderr


def build() -> Path:
    """Path of the kernel library, compiling it first when missing."""
    from alga_tpu_torch.ops.banded_dp import MAX_E, WIDE_CELLS
    srcs = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(
        b"".join(p.name.encode() + p.read_bytes() for p in srcs)).hexdigest()
    so = _BUILD / f"libalga_kernels_{digest[:16]}.so"
    if so.exists():
        return so
    objdir = _BUILD / f"obj_{digest[:16]}_{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    units = [(_CSRC / "banded_dp.cu", [], objdir / "banded_dp.o")]
    units += [(_CSRC / "banded_lcs.cu", [f"-DALGA_LCS_E={e}"],
               objdir / f"banded_lcs_{e}.o") for e in range(MAX_E + 1)]
    units += [(_CSRC / "banded_lcs_wide.cu", [f"-DALGA_LCS_WIDE_K={k}"],
               objdir / f"banded_lcs_wide_{k}.o") for k in WIDE_CELLS]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        ptxas = list(pool.map(lambda u: _run(
            [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-c",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", *u[1], "-o", str(u[2]),
             str(u[0])]), units))
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    _run([nvcc, "-shared", "-o", str(tmp), *(str(u[2]) for u in units)])
    os.replace(tmp, so)
    shutil.rmtree(objdir, ignore_errors=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      ptxas="\n".join(ptxas))
    return so


def lib():
    """The loaded kernel library, with its C signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    L = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    L.alga_gather_planes.restype = i32
    L.alga_gather_planes.argtypes = [p, p, i64, i32, p, i64, p, p]
    L.alga_banded_lcs.restype = i32
    L.alga_banded_lcs.argtypes = [p, p, i32, i64, p, p, p, i32, i32, i32,
                                  p, p]
    L.alga_cuda_error_string.restype = ctypes.c_char_p
    L.alga_cuda_error_string.argtypes = [i32]
    _lib = L
    return L


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib().alga_cuda_error_string(rc).decode()
        raise RuntimeError(f"alga_tpu_torch: {what} launch failed: "
                           f"CUDA error {rc} ({msg})")
