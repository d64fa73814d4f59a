"""Build and bind the CUDA kernels in satnerf_tpu_torch/csrc/.

nvcc compiles every csrc/*.cu to an object, one nvcc per source and all
started together, and links them into one shared library with a plain C
interface, for sm_90a, in build/satnerf_tpu_torch/ at the repository root.
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
              "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # dtype, X, K, W, bias, rays, z, S, extra_mode, extra_off, n_extra, C,
    # w0, act, Y, save, P, N, mainloop, stream
    "satnerf_siren_dense": [_I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                            _F, _I, _P, _P, _I, _I, _I, _P],
    # dtype, h, F, r, s2, bh, skyh, Fh, Wn, bn, z, noise, R, S, rgb_padding,
    # out, weights, stream
    "satnerf_heads_composite": [_I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                                _P, _I, _I, _F, _P, _P, _P],
    # dtype, dY, slope, W, dX, accumulate, P, N, K, mainloop, stream
    "satnerf_siren_dense_dgrad": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, X, K, dY, slope, rays, z, S, extra_mode, extra_off, n_extra, C,
    # dW, db, dC, dE, P, N, mainloop, split, small, stream
    "satnerf_siren_dense_wgrad": [_I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, h, F, r, s2, bh, skyh, Fh, Wn, bn, z, noise, gt, R, S,
    # rgb_padding, beta_min, wmix, loss_sums, weights, d_h, d_r, d_s2, d_bh,
    # d_skyh, dWn, dbn, stream
    "satnerf_composite_loss_bwd": [_I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                                   _P, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P,
                                   _P, _P, _P, _P, _P, _P],
    # dtype, h, F, r, s2, bh, skyh, Fh, Wn, bn, z, noise, g, R, S,
    # rgb_padding, d_h, d_r, d_s2, d_bh, d_skyh, dWn, dbn, stream
    "satnerf_composite_bwd": [_I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                              _P, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P, _P],
    # dtype, h, F, s2, Fh, Wn, bn, z, noise, R, S, scale, sums, d_s2, dWn,
    # dbn, stream
    "satnerf_sc_loss_bwd": [_I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _F,
                            _P, _P, _P, _P, _P],
    # dtype, h, F, r, s2, bh, skyh, Fh, Wn, bn, P, S, rgb_padding, out, stream
    "satnerf_field_heads": [_I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _F,
                            _P, _P],
    # dtype, h, F, r, s2, bh, skyh, Fh, Wn, bn, g, P, S, rgb_padding, d_h, d_r,
    # d_s2, d_bh, d_skyh, dWn, dbn, stream
    "satnerf_field_heads_bwd": [_I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I,
                                _I, _F, _P, _P, _P, _P, _P, _P, _P, _P],
    # dtype, X, K, W, bias, rays8, z, S, enc_mode, n_freq, e_rows, C, act, Y,
    # P, N, stream
    "satnerf_nerf_dense": [_I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I,
                           _P, _I, _I, _P],
    # dtype, dY, Ymask, W, dX, accumulate, P, N, K, mainloop, stream
    "satnerf_nerf_dense_dgrad": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, X, K, dY, Ymask, rays8, z, S, enc_mode, n_freq, e_rows, dW, db,
    # dC, P, N, mainloop, split, bias, stream
    "satnerf_nerf_dense_wgrad": [_I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, h, F, r, Fh, Wn, bn, z, noise, R, S, rgb_padding, out, weights,
    # stream
    "satnerf_nerf_heads_composite": [_I, _P, _I, _P, _I, _P, _P, _P, _P, _I,
                                     _I, _F, _P, _P, _P],
    # dtype, h, F, r, Fh, Wn, bn, z, noise, gt, R, S, rgb_padding, loss_sum,
    # d_h, d_r, dWn, dbn, stream
    "satnerf_nerf_composite_loss_bwd": [_I, _P, _I, _P, _I, _P, _P, _P, _P, _P,
                                        _I, _I, _F, _P, _P, _P, _P, _P, _P],
    # dtype, h, F, r, Fh, Wn, bn, P, rgb_padding, out, stream
    "satnerf_nerf_field_heads": [_I, _P, _I, _P, _I, _P, _P, _I, _F, _P, _P],
    # dtype, h, F, r, Fh, Wn, bn, g, P, rgb_padding, d_h, d_r, dWn, dbn, stream
    "satnerf_nerf_field_heads_bwd": [_I, _P, _I, _P, _I, _P, _P, _P, _I, _F,
                                     _P, _P, _P, _P, _P],
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
    nvcc, tag = _nvcc(), f"{os.path.basename(path)}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{tag}.{os.path.basename(src)}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    tmp = os.path.join(BUILD_DIR, f"{tag}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *[o for _, o, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
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
