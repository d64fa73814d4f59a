"""Build and bind the CUDA kernels in satnerf_tpu_torch/csrc/.

nvcc compiles every csrc/*.cu into one shared library with a plain C
interface, for sm_90a, into build/satnerf_tpu_torch/ at the repository root.
The file name carries a hash of the sources and flags, so an edit rebuilds
and an unchanged tree reuses the library. It is loaded with ctypes; each C
entry returns cudaGetLastError() after its launch.

Nothing here runs at import: the CPU tests import this module on machines
without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "satnerf_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # dtype, X, K, W, bias, rays, z, S, extra_mode, extra_off, n_extra, C,
    # w0, act, Y, P, N, stream
    "satnerf_siren_dense": [_I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                            _F, _I, _P, _I, _I, _P],
    # dtype, h, F, r, s2, bh, skyh, Fh, Wn, bn, z, R, S, rgb_padding, out,
    # weights, stream
    "satnerf_heads_composite": [_I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                                _I, _I, _F, _P, _P, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libsatnerf_torch_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile csrc/ unless the library for these sources exists.
    Returns (path, seconds spent compiling; 0.0 when reused)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels; argtypes declared."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
