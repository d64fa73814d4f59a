"""ctypes bindings for the native C++ host-side kernels (native/).

Auto-builds libsatnerf_native.so with `make` on first use if a toolchain is
available; every entry point has a pure-Python/numpy fallback, so the package
works without a compiler. `available()` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsatnerf_native.so")

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and os.path.exists(
        os.path.join(_NATIVE_DIR, "Makefile")
    ):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.lzw_decode.restype = ctypes.c_int64
    lib.lzw_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.splat_dsm.restype = None
    lib.splat_dsm.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.ncc_shift.restype = ctypes.c_double
    lib.ncc_shift.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ncc_search.restype = None
    lib.ncc_search.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def lzw_decode(data: bytes, expected_size: int) -> Optional[bytes]:
    """Native TIFF LZW decode; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    # LZW can expand beyond the tile size estimate; give slack
    cap = max(expected_size, len(data) * 3) + 4096
    dst = np.empty(cap, dtype=np.uint8)
    n = lib.lzw_decode(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(src),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    if n < 0:
        return None
    return dst[:n].tobytes()


def splat_dsm(cloud: np.ndarray, xoff: float, yoff: float, resolution: float,
              xsize: int, ysize: int, radius: int, sigma: float):
    """Native scatter accumulation. Returns (acc, wacc) or None."""
    lib = _load()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(cloud, dtype=np.float64)
    acc = np.zeros(ysize * xsize, dtype=np.float64)
    wacc = np.zeros(ysize * xsize, dtype=np.float64)
    lib.splat_dsm(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), xyz.shape[0],
        xoff, yoff, resolution, xsize, ysize, radius, sigma,
        acc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        wacc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return acc, wacc


def ncc_search(u: np.ndarray, v: np.ndarray, irange: int, initdx: int,
               initdy: int):
    """Native exhaustive NCC shift search. Returns (dx, dy) or None."""
    lib = _load()
    if lib is None:
        return None
    uu = np.ascontiguousarray(u, dtype=np.float64)
    vv = np.ascontiguousarray(v, dtype=np.float64)
    h, w = uu.shape[-2], uu.shape[-1]
    out = np.zeros(2, dtype=np.int32)
    lib.ncc_search(
        uu.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        vv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        h, w, irange, initdx, initdy,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return int(out[0]), int(out[1])
