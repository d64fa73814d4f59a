"""Point-cloud -> DSM rasterization (the plyflatten replacement).

The reference splats the NeRF depth point cloud into a UTM grid with the C
`plyflatten` library (datasets/satellite.py:310-317, radius=1, sigma=inf).
Here: vectorized numpy scatter-mean — each point contributes its altitude to
every cell within `radius` cells of its own, optionally gaussian-weighted by
the distance between the point and the cell center; empty cells are NaN.
"""

from __future__ import annotations

import numpy as np


def raster_dsm(cloud: np.ndarray, xoff: float, yoff: float, resolution: float,
               xsize: int, ysize: int, radius: int = 1,
               sigma: float = float("inf")) -> np.ndarray:
    """cloud: (N, 3) [east, north, alt]. Returns (ysize, xsize, 1) float64 DSM.

    Grid cell (row j, col i) covers
      x in [xoff + i*res, xoff + (i+1)*res),  y in (yoff - (j+1)*res, yoff - j*res]
    matching plyflatten's (xoff upper-left, y decreasing) convention.
    """
    from satnerf_tpu_torch import native

    if native.available():
        res = native.splat_dsm(cloud, xoff, yoff, resolution, xsize, ysize,
                               radius, sigma)
        if res is not None:
            acc, wacc = res
            out = np.full(ysize * xsize, np.nan)
            nz = wacc > 0
            out[nz] = acc[nz] / wacc[nz]
            return out.reshape(ysize, xsize, 1)

    x, y, z = cloud[:, 0], cloud[:, 1], cloud[:, 2]
    good = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    x, y, z = x[good], y[good], z[good]

    ci = np.floor((x - xoff) / resolution).astype(np.int64)
    cj = np.floor((yoff - y) / resolution).astype(np.int64)

    acc = np.zeros(ysize * xsize, dtype=np.float64)
    wacc = np.zeros(ysize * xsize, dtype=np.float64)

    use_gauss = np.isfinite(sigma)
    for dj in range(-radius, radius + 1):
        for di in range(-radius, radius + 1):
            jj = cj + dj
            ii = ci + di
            m = (ii >= 0) & (ii < xsize) & (jj >= 0) & (jj < ysize)
            if not np.any(m):
                continue
            idx = jj[m] * xsize + ii[m]
            if use_gauss:
                # distance from point to target cell center
                cxc = xoff + (ii[m] + 0.5) * resolution
                cyc = yoff - (jj[m] + 0.5) * resolution
                d2 = (x[m] - cxc) ** 2 + (y[m] - cyc) ** 2
                w = np.exp(-d2 / (2.0 * sigma * sigma))
            else:
                w = np.ones(idx.shape[0])
            np.add.at(acc, idx, w * z[m])
            np.add.at(wacc, idx, w)

    out = np.full(ysize * xsize, np.nan)
    nz = wacc > 0
    out[nz] = acc[nz] / wacc[nz]
    return out.reshape(ysize, xsize, 1)
