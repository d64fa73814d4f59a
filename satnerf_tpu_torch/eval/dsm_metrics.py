"""DSM accuracy metrics: crop to the lidar ROI, mask water, register with
NCC, report the altitude error raster and MAE.

Replaces sat_utils.py:114-223 (dsm_pointwise_diff / compute_mae_and_save_dsm_diff)
without GDAL: the projwin crop uses our GeoTIFF window reader, registration is
ops/dsm_registration (z-scaling disabled like the reference call at
sat_utils.py:174).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from satnerf_tpu_torch.geo.geotiff import Profile, read_geotiff, write_geotiff
from satnerf_tpu_torch.ops.dsm_registration import (
    apply_shift_arrays,
    compute_shift_arrays,
)


def _crop_to_roi(dsm_path: str, xoff, yoff, xsize, ysize, resolution):
    """Window the predicted DSM to the GT ROI grid (sat_utils.py:128-139).

    When the prediction's grid resolution differs from the GT's (the reference
    silently assumes they match, which holds for DFC2019's 0.5 m products),
    the prediction is resampled onto the ROI grid by scatter-mean of its
    finite cells — grids of any resolution compare correctly.
    """
    g = read_geotiff(dsm_path)
    t = g.profile.transform
    uly = yoff + ysize * resolution
    h, w = g.data.shape[1:]

    if abs(abs(t.a) - resolution) < 1e-9:
        # matched grids: pixel-aligned window (reference fast path)
        col0 = int(round((xoff - t.c) / t.a))
        row0 = int(round((uly - t.f) / t.e))
        out = np.full((ysize, xsize), np.nan)
        r0, r1 = max(row0, 0), min(row0 + ysize, h)
        c0, c1 = max(col0, 0), min(col0 + xsize, w)
        if r1 > r0 and c1 > c0:
            out[r0 - row0 : r1 - row0, c0 - col0 : c1 - col0] = (
                g.data[0, r0:r1, c0:c1]
            )
    else:
        # mismatched grids: splat finite pred cells into the ROI grid
        from satnerf_tpu_torch.ops.dsm_raster import raster_dsm

        vals = g.data[0].astype(np.float64)
        rows, cols = np.nonzero(np.isfinite(vals))
        x = t.c + (cols + 0.5) * t.a
        y = t.f + (rows + 0.5) * t.e
        cloud = np.stack([x, y, vals[rows, cols]], axis=-1)
        out = raster_dsm(cloud, xoff, uly, resolution, xsize, ysize,
                         radius=0)[:, :, 0]

    prof = g.profile.copy()
    prof.width, prof.height = xsize, ysize
    prof.transform = type(t)(resolution, t.b, xoff, t.d, -resolution, uly)
    prof.nodata = float("nan")
    prof.dtype = "float64"
    return out, prof


def dsm_pointwise_diff(in_dsm_path: str, gt_dsm_path: str, dsm_metadata,
                       gt_mask_path: Optional[str] = None,
                       out_rdsm_path: Optional[str] = None,
                       out_err_path: Optional[str] = None) -> np.ndarray:
    """Registered altitude-error raster pred - gt (sat_utils.py:114-195).

    dsm_metadata: (xoff, yoff, size, resolution) from the {AOI}_DSM.txt file.
    Water pixels (GT CLS class 9) are masked to NaN before registration.
    """
    xoff, yoff = dsm_metadata[0], dsm_metadata[1]
    xsize = ysize = int(dsm_metadata[2])
    resolution = dsm_metadata[3]

    pred_dsm, prof = _crop_to_roi(in_dsm_path, xoff, yoff, xsize, ysize, resolution)

    if gt_mask_path is not None:
        mask = read_geotiff(gt_mask_path).data[0]
        water = mask == 9
        if water.shape == pred_dsm.shape:
            pred_dsm[water] = np.nan

    gt_dsm = read_geotiff(gt_dsm_path).data[0].astype(np.float64)

    dx, dy, a, b = compute_shift_arrays(gt_dsm, pred_dsm, scaling=False)
    pred_rdsm = apply_shift_arrays(pred_dsm, dx, dy, a, b)[0]
    err = pred_rdsm - gt_dsm

    if out_rdsm_path is not None:
        os.makedirs(os.path.dirname(out_rdsm_path) or ".", exist_ok=True)
        write_geotiff(out_rdsm_path, pred_rdsm[None], prof)
    if out_err_path is not None:
        os.makedirs(os.path.dirname(out_err_path) or ".", exist_ok=True)
        write_geotiff(out_err_path, err[None], prof)
    return err


def dsm_mae(in_dsm_path: str, gt_dsm_path: str, dsm_metadata,
            gt_mask_path: Optional[str] = None) -> float:
    """nanmean absolute registered error (sat_utils.py:221-223)."""
    diff = dsm_pointwise_diff(in_dsm_path, gt_dsm_path, dsm_metadata,
                              gt_mask_path=gt_mask_path)
    return float(np.nanmean(np.abs(diff.ravel())))


def compute_mae_and_save_dsm_diff(pred_dsm_path: str, src_id: str, gt_dir: str,
                                  out_dir: str, epoch_number: int,
                                  save: bool = True) -> float:
    """MAE against the AOI's lidar DSM with water masking
    (sat_utils.py:197-219). Expects {AOI}_DSM.tif/.txt and {AOI}_CLS[_v2].tif
    in gt_dir, AOI = first 7 chars of src_id."""
    aoi_id = src_id[:7]
    gt_dsm_path = os.path.join(gt_dir, f"{aoi_id}_DSM.tif")
    gt_roi_path = os.path.join(gt_dir, f"{aoi_id}_DSM.txt")
    if aoi_id in ("JAX_004", "JAX_260"):
        gt_seg_path = os.path.join(gt_dir, f"{aoi_id}_CLS_v2.tif")
    else:
        gt_seg_path = os.path.join(gt_dir, f"{aoi_id}_CLS.tif")
    assert os.path.exists(gt_roi_path), f"{gt_roi_path} not found"
    assert os.path.exists(gt_dsm_path), f"{gt_dsm_path} not found"
    gt_seg = gt_seg_path if os.path.exists(gt_seg_path) else None

    meta = np.loadtxt(gt_roi_path)
    rdsm_diff_path = os.path.join(out_dir, f"{src_id}_rdsm_diff_epoch{epoch_number}.tif")
    rdsm_path = os.path.join(out_dir, f"{src_id}_rdsm_epoch{epoch_number}.tif")
    diff = dsm_pointwise_diff(pred_dsm_path, gt_dsm_path, meta,
                              gt_mask_path=gt_seg,
                              out_rdsm_path=rdsm_path,
                              out_err_path=rdsm_diff_path)
    if not save:
        for p in (rdsm_diff_path, rdsm_path):
            if os.path.exists(p):
                os.remove(p)
    return float(np.nanmean(np.abs(diff.ravel())))
