"""DSM registration: multiscale NCC alignment of a predicted DSM to lidar GT.

Vectorized numpy replacement for the reference's numba-JIT dsmr.py (the only
native-compiled code in the reference repo): nan-aware 2x downsampling
pyramid, exhaustive +-irange integer-shift NCC search per level, and an
affine z-mapping z -> a*z + b. Whole-array slicing replaces the per-pixel
loops; an 800^2 DSM registers in milliseconds.
"""

from __future__ import annotations

import numpy as np


def downsample2x(u: np.ndarray) -> np.ndarray:
    """Nan-aware 2x block-mean downsample of (C, H, W) (dsmr.py:16-46)."""
    c, h, w = u.shape
    ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    pad = np.full((c, ph, pw), np.nan)
    pad[:, :h, :w] = u
    blocks = pad.reshape(c, ph // 2, 2, pw // 2, 2)
    with np.errstate(invalid="ignore"):
        out = np.nanmean(blocks, axis=(2, 4))
    return out


def _overlap(u: np.ndarray, v: np.ndarray, dx: int, dy: int):
    """Aligned flat views of u and v shifted by (dx, dy), finite-both mask.

    v is sampled at (i+dx, j+dy) for u's (i, j) (dsmr.py:50-88 convention).
    """
    h, w = u.shape[-2], u.shape[-1]
    u0x, u1x = max(0, -dx), min(w, w - dx)
    u0y, u1y = max(0, -dy), min(h, h - dy)
    if u1x <= u0x or u1y <= u0y:
        return None, None
    uu = u[0, u0y:u1y, u0x:u1x].ravel()
    vv = v[0, u0y + dy : u1y + dy, u0x + dx : u1x + dx].ravel()
    m = np.isfinite(uu) & np.isfinite(vv)
    return uu[m], vv[m]


def mean_std(u: np.ndarray, v: np.ndarray, dx: int = 0, dy: int = 0):
    """(mu_u, mu_v, sig_u, sig_v, xcorr) over the finite overlap
    (dsmr.py:50-88; population std, cross-covariance)."""
    uu, vv = _overlap(u, v, dx, dy)
    if uu is None or uu.size == 0:
        return np.nan, np.nan, np.nan, np.nan, np.nan
    muu, muv = uu.mean(), vv.mean()
    du, dv = uu - muu, vv - muv
    sigu = np.sqrt(np.mean(du * du))
    sigv = np.sqrt(np.mean(dv * dv))
    xcorr = np.mean(du * dv)
    return muu, muv, sigu, sigv, xcorr


def ncc(u: np.ndarray, v: np.ndarray, dx: int = 0, dy: int = 0) -> float:
    _, _, sigu, sigv, xcorr = mean_std(u, v, dx, dy)
    return xcorr / (sigu * sigv)


def compute_ncc(u, v, irange: int, initdx: int, initdy: int):
    """Best (dx, dy) within (initdx, initdy) +- irange (dsmr.py:102-117).
    Uses the native C++ search (satnerf_tpu_torch/native.py) when available."""
    from satnerf_tpu_torch import native

    if native.available():
        out = native.ncc_search(u[0] if u.ndim == 3 else u,
                                v[0] if v.ndim == 3 else v,
                                irange, initdx, initdy)
        if out is not None:
            return out

    best = (initdx, initdy)
    maxv = -np.inf
    for y in range(initdy - irange, initdy + irange + 1):
        for x in range(initdx - irange, initdx + irange + 1):
            corr = ncc(u, v, x, y)
            if np.isfinite(corr) and corr > maxv:
                best = (x, y)
                maxv = corr
    return best


def recursive_ncc(u, v, irange: int = 5, dx: int = 0, dy: int = 0):
    """Coarse-to-fine NCC (dsmr.py:120-135): halve until <=100 px, then refine
    the doubled coarse shift at each level."""
    if min(u.shape[-1], u.shape[-2]) > 100:
        dx, dy = recursive_ncc(downsample2x(u), downsample2x(v), irange,
                               dx // 2, dy // 2)
        dx, dy = dx * 2, dy * 2
    return compute_ncc(u, v, irange, dx, dy)


def compute_shift_arrays(u: np.ndarray, v: np.ndarray, scaling: bool = True):
    """(dx, dy, a, b) registering v onto u: v_registered(z) = a*z + b sampled
    at the shifted grid (dsmr.py:163-190)."""
    if u.ndim == 2:
        u = u[None]
    if v.ndim == 2:
        v = v[None]
    dx, dy = recursive_ncc(u, v)
    muu, muv, sigu, sigv, _ = mean_std(u, v, dx, dy)
    a = sigu / sigv if scaling else 1.0
    b = muu - muv * a
    return dx, dy, a, b


def apply_shift_arrays(v: np.ndarray, dx: int = 0, dy: int = 0, a: float = 1.0,
                       b: float = 0.0) -> np.ndarray:
    """out[j, i] = a * v[j+dy, i+dx] + b, nan outside (dsmr.py:138-149)."""
    if v.ndim == 2:
        v = v[None]
    c, h, w = v.shape
    out = np.full_like(v, np.nan, dtype=np.float64)
    s0x, s1x = max(0, -dx), min(w, w - dx)
    s0y, s1y = max(0, -dy), min(h, h - dy)
    if s1x > s0x and s1y > s0y:
        out[:, s0y:s1y, s0x:s1x] = (
            a * v[:, s0y + dy : s1y + dy, s0x + dx : s1x + dx] + b
        )
    return out


# ----------------------------------------------------------- file interfaces


def compute_shift(dsm_ref_path: str, dsm_sec_path: str, scaling: bool = True):
    """File-level interface matching dsmr.compute_shift (dsmr.py:163-190)."""
    from satnerf_tpu_torch.geo.geotiff import read_geotiff

    u = read_geotiff(dsm_ref_path).data.astype(np.float64)
    v = read_geotiff(dsm_sec_path).data.astype(np.float64)
    return compute_shift_arrays(u, v, scaling)


def apply_shift(in_dsm: str, out_dsm: str, dx=0, dy=0, a=1, b=0):
    """File-level interface matching dsmr.apply_shift (dsmr.py:193-215)."""
    from satnerf_tpu_torch.geo.geotiff import read_geotiff, write_geotiff

    g = read_geotiff(in_dsm)
    out = apply_shift_arrays(g.data.astype(np.float64), dx, dy, a, b)
    prof = g.profile.copy()
    prof.dtype = "float64"
    write_geotiff(out_dsm, out, prof)
