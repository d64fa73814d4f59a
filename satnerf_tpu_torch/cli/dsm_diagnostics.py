#!/usr/bin/env python
"""DSM quality diagnostics on the PyTorch port: tools/dsm_diagnostics.py over
the port's own geo/, data/ and eval/ modules. The product-chain oracle floor
and the error structure of a predicted DSM:

  oracle     march each val ray against the GT DSM surface itself (bilinear
             sample in UTM, first below-surface crossing, linear depth
             interpolation), then push that perfect depth through the
             product chain (depth -> lat/lon/alt -> UTM -> splat ->
             register -> MAE). The MAE is the floor the chain itself
             imposes: a trained model cannot beat it.

  errstruct  decompose pred-vs-GT DSM error on the GT grid: raw MAE / bias /
             std (the registered MAE eval reports removes the bias),
             altitude and slope correlations, a planar-ramp fit (RPC
             miscalibration shows up here), and the spatial scale of the
             residual via block-mean stds.

Host-side float64 geodesy throughout; no model and no device.

  python -m satnerf_tpu_torch.cli.dsm_diagnostics oracle --root_dir DATA \
      --gt_dir GT [--cache_dir CACHE]
  python -m satnerf_tpu_torch.cli.dsm_diagnostics errstruct \
      --pred logs/<run>/val/dsm/<img>_epoch31.tif --gt gt/SYN_000_DSM.tif
"""

import argparse
import os
import sys

import numpy as np


def _bilinear_on_grid(grid: np.ndarray, transform, E: np.ndarray,
                      N: np.ndarray):
    """Sample a (H, W) UTM raster at easting/northing points; nan outside."""
    gx = (E - transform.c) / transform.a - 0.5
    gy = (N - transform.f) / transform.e - 0.5
    x0 = np.floor(gx).astype(int)
    y0 = np.floor(gy).astype(int)
    fx, fy = gx - x0, gy - y0
    ok = ((x0 >= 0) & (x0 < grid.shape[1] - 1)
          & (y0 >= 0) & (y0 < grid.shape[0] - 1))
    x0c = np.clip(x0, 0, grid.shape[1] - 2)
    y0c = np.clip(y0, 0, grid.shape[0] - 2)
    v = (grid[y0c, x0c] * (1 - fx) * (1 - fy)
         + grid[y0c, x0c + 1] * fx * (1 - fy)
         + grid[y0c + 1, x0c] * (1 - fx) * fy
         + grid[y0c + 1, x0c + 1] * fx * fy)
    return np.where(ok, v, np.nan)


def cmd_oracle(args):
    from satnerf_tpu_torch.data.satellite import SatelliteScene
    from satnerf_tpu_torch.eval.dsm_metrics import compute_mae_and_save_dsm_diff
    from satnerf_tpu_torch.geo.ellipsoid import latlon_from_ecef
    from satnerf_tpu_torch.geo.geotiff import read_geotiff
    from satnerf_tpu_torch.geo.utm import utm_from_latlon

    ds = SatelliteScene(args.root_dir, split=args.split,
                        cache_dir=args.cache_dir)
    sample = ds.load_image(args.idx)
    rays = sample["rays"].astype(np.float64)
    aoi_id = sample["src_id"][:7]
    gt_t = read_geotiff(os.path.join(args.gt_dir, f"{aoi_id}_DSM.tif"))
    gt = gt_t.data.squeeze().astype(np.float64)

    o, d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6], rays[:, 7]
    K = args.samples
    depth = np.zeros(len(rays))
    lin = np.linspace(0.0, 1.0, K)
    for lo in range(0, len(rays), 8192):
        hi = min(lo + 8192, len(rays))
        t = near[lo:hi, None] + (far - near)[lo:hi, None] * lin[None]
        pts = o[lo:hi, None, :] + d[lo:hi, None, :] * t[..., None]
        ecef = ds.scene.denormalize_points(pts.reshape(-1, 3))
        lat, lon, alt = latlon_from_ecef(ecef[:, 0], ecef[:, 1], ecef[:, 2])
        E, N = utm_from_latlon(lat, lon)
        surf = _bilinear_on_grid(gt, gt_t.profile.transform, E, N)
        diff = (alt - surf).reshape(hi - lo, K)
        diff = np.where(np.isnan(diff), 1e9, diff)  # outside GT: stay above
        below = diff <= 0
        k = np.argmax(below, axis=1)  # first below-surface sample
        k = np.clip(k, 1, K - 1)
        idx = np.arange(hi - lo)
        d0, d1 = diff[idx, k - 1], diff[idx, k]
        frac = np.where(d0 - d1 != 0, d0 / (d0 - d1), 0.0)
        depth[lo:hi] = t[idx, k - 1] + frac * (t[idx, k] - t[idx, k - 1])

    out = args.out_dir
    os.makedirs(os.path.join(out, "dsm"), exist_ok=True)
    p = os.path.join(out, "dsm", "oracle.tif")
    ds.dsm_from_prediction(sample["rays"], depth.astype(np.float32),
                           dsm_path=p)
    mae = compute_mae_and_save_dsm_diff(p, sample["src_id"], args.gt_dir,
                                        out, 0, save=False)
    print(f"oracle chain floor: MAE {mae:.4f} m "
          f"({args.split}[{args.idx}] = {sample['src_id']}, K={K})")
    return mae


def cmd_errstruct(args):
    from satnerf_tpu_torch.geo.geotiff import read_geotiff

    pred_t = read_geotiff(args.pred)
    gt_t = read_geotiff(args.gt)
    pred = pred_t.data.squeeze().astype(np.float64)
    gt = gt_t.data.squeeze().astype(np.float64)
    tp, tg = pred_t.profile.transform, gt_t.profile.transform

    yy, xx = np.mgrid[0 : pred.shape[0], 0 : pred.shape[1]]
    E = tp.c + tp.a * (xx + 0.5)
    N = tp.f + tp.e * (yy + 0.5)
    g = _bilinear_on_grid(gt, tg, E.ravel(), N.ravel()).reshape(pred.shape)
    d = pred - g
    m = ~np.isnan(d)
    if not m.any():
        sys.exit("no overlapping valid pixels between pred and gt")
    print(f"raw MAE {np.abs(d[m]).mean():.3f} m | bias {d[m].mean():+.3f} m "
          f"| std {d[m].std():.3f} m")
    print(f"  (the registered MAE eval reports removes the bias: "
          f"zero-mean residual MAE = "
          f"{np.abs(d[m] - d[m].mean()).mean():.3f} m)")
    print(f"corr(err, alt) = {np.corrcoef(d[m], g[m])[0, 1]:+.3f}")
    A = np.stack([g[m], np.ones(m.sum())], 1)
    ca, *_ = np.linalg.lstsq(A, d[m], rcond=None)
    print(f"err ~ a*alt+b: a={ca[0]:+.4f} b={ca[1]:+.3f}  "
          f"resid MAE {np.abs(d[m] - A @ ca).mean():.3f} m")
    B = np.stack([yy[m].astype(float), xx[m].astype(float),
                  np.ones(m.sum())], 1)
    cb, *_ = np.linalg.lstsq(B, d[m], rcond=None)
    print(f"err ~ plane: dN={cb[0]:+.5f}/px dE={cb[1]:+.5f}/px  "
          f"resid MAE {np.abs(d[m] - B @ cb).mean():.3f} m "
          f"(a big planar ramp = geo miscalibration, not field noise)")
    gyg, gxg = np.gradient(np.where(np.isnan(g), 0.0, g))
    print(f"corr(err, slope): dN {np.corrcoef(d[m], gyg[m])[0, 1]:+.3f}  "
          f"dE {np.corrcoef(d[m], gxg[m])[0, 1]:+.3f}")
    r = d - np.nanmean(d)
    res = abs(tp.a)
    print("residual spatial scale (std of block means):")
    import warnings

    for bs in (4, 16, 64):
        h2 = (pred.shape[0] // bs) * bs
        w2 = (pred.shape[1] // bs) * bs
        if h2 == 0 or w2 == 0:
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-nan blocks
            blocks = np.nanmean(
                r[:h2, :w2].reshape(h2 // bs, bs, w2 // bs, bs), axis=(1, 3))
        print(f"  {bs:3d}px ({bs * res:6.1f} m): {np.nanstd(blocks):.3f} m")
    print(f"  per-px: {np.nanstd(r):.3f} m")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    o = sub.add_parser("oracle", help="product-chain MAE floor from GT-DSM "
                                      "ray marching")
    o.add_argument("--root_dir", required=True)
    o.add_argument("--gt_dir", required=True)
    o.add_argument("--cache_dir", default=None)
    o.add_argument("--split", default="val")
    o.add_argument("--idx", type=int, default=0)
    o.add_argument("--samples", type=int, default=512,
                   help="uniform march samples per ray")
    o.add_argument("--out_dir", required=True)
    o.set_defaults(fn=cmd_oracle)

    e = sub.add_parser("errstruct", help="error decomposition of a predicted "
                                         "DSM vs the GT raster")
    e.add_argument("--pred", required=True, help="predicted DSM GeoTIFF")
    e.add_argument("--gt", required=True, help="GT DSM GeoTIFF")
    e.set_defaults(fn=cmd_errstruct)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
