"""DSM extraction on the PyTorch port — create_dsm.py's flow and flags.

Render the most-nadir view under the most-nadir sun direction, rasterize the
depth into a UTM DSM, register it against the lidar GT and report the
altitude MAE (the reference's create_satnerf_dsm.py). The weights come from
the port's PL-style checkpoint through satnerf_tpu_torch.eval.loader; the
view renders on the cards `render_ranks` gives there (opts.json's n_devices,
one where the view is too small to repay starting ranks), and rank 0 alone
writes and prints.

Usage:
  python -m satnerf_tpu_torch.cli.create_dsm --run_id RUN --logs_dir logs \
      --output_dir out --epoch_number 28 [--checkpoints_dir ckpts] \
      [--root_dir ...] [--img_dir ...] [--gt_dir ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil

import numpy as np


def create_pretty_dsm(run_id: str, logs_dir: str, output_dir: str,
                      epoch_number: int, checkpoints_dir: str | None = None,
                      root_dir: str | None = None, img_dir: str | None = None,
                      gt_dir: str | None = None, device: str = "cuda"):
    """Rank 0's altitude MAE (None without a gt_dir, and on the other
    ranks)."""
    from satnerf_tpu_torch.eval.loader import run_on_devices
    from satnerf_tpu_torch.utils.sort import \
        sort_by_increasing_view_incidence_angle

    return run_on_devices(_create_pretty_dsm,
                          (run_id, logs_dir, output_dir, epoch_number,
                           checkpoints_dir, root_dir, img_dir, gt_dir, device),
                          logs_dir, run_id, device, root_dir,
                          lambda root: sort_by_increasing_view_incidence_angle(
                              root)[:1])


def _create_pretty_dsm(run_id, logs_dir, output_dir, epoch_number,
                       checkpoints_dir, root_dir, img_dir, gt_dir, device):
    from satnerf_tpu_torch.data.rays import sun_direction
    from satnerf_tpu_torch.data.satellite import SatelliteScene
    from satnerf_tpu_torch.utils.sort import (
        sort_by_increasing_solar_incidence_angle,
        sort_by_increasing_view_incidence_angle,
    )
    from satnerf_tpu_torch.eval import (compute_mae_and_save_dsm_diff,
                                        predefined_val_ts, read_geotiff,
                                        save_nerf_output_to_images,
                                        write_geotiff)
    from satnerf_tpu_torch.eval.loader import load_run
    from satnerf_tpu_torch.parallel import distributed as D

    cfg, system, params = load_run(run_id, logs_dir, epoch_number,
                                   checkpoints_dir, root_dir, img_dir, gt_dir,
                                   device)

    # reference view: min view incidence; sun: min solar incidence
    # (create_satnerf_dsm.py:46-51)
    reference_image = sort_by_increasing_view_incidence_angle(cfg.root_dir)[0]
    with open(sort_by_increasing_solar_incidence_angle(cfg.root_dir)[0]) as f:
        d = json.load(f)
    sun_d = sun_direction(float(d["sun_elevation"]), float(d["sun_azimuth"]))

    dataset = SatelliteScene(cfg.root_dir, cfg.img_dir, split="val",
                             img_downscale=cfg.img_downscale,
                             cache_dir=cfg.cache_dir)
    dataset.records = [dataset._record(reference_image, 0)]
    sample = dataset.load_image(0)
    src_id = sample["src_id"]
    if D.is_main():
        print(f"using image {src_id}...")

    ts = None
    if cfg.model == "sat-nerf":
        with open(os.path.join(cfg.root_dir, "train.txt")) as f:
            train_files = [os.path.join(cfg.root_dir, s)
                           for s in f.read().split("\n") if s.strip()]
        if reference_image in train_files:
            t = train_files.index(reference_image)
        else:
            t = predefined_val_ts(src_id) or 0
        ts = np.full(sample["rays"].shape[0], t, dtype=np.int32)

    # override the sun direction columns (create_satnerf_dsm.py:76-77)
    rays = sample["rays"].copy()
    rays[:, 8:11] = sun_d.astype(np.float32)
    sample["rays"] = rays

    results = system.render_image(params, rays, ts)
    if not D.is_main():
        return None

    out_dir = os.path.join(output_dir, run_id, "tmp")
    os.makedirs(out_dir, exist_ok=True)
    save_nerf_output_to_images(dataset, sample, results, out_dir, epoch_number)

    run_out = os.path.join(output_dir, run_id)
    tmp_dsm = glob.glob(os.path.join(out_dir, "dsm/*.tif"))[0]
    tmp_gt_rgb = glob.glob(os.path.join(out_dir, "gt_rgb/*.tif"))[0]
    pred_dsm_path = os.path.join(run_out, f"{src_id}_dsm_epoch{epoch_number}.tif")
    shutil.copyfile(tmp_dsm, pred_dsm_path)
    shutil.copyfile(tmp_gt_rgb, os.path.join(run_out, f"{src_id}_gt_rgb.tif"))
    shutil.rmtree(out_dir)

    if cfg.gt_dir is None:
        return None
    mae = compute_mae_and_save_dsm_diff(pred_dsm_path, src_id, cfg.gt_dir,
                                        run_out, epoch_number)
    print(f"Path to output NeRF DSM: {pred_dsm_path}")
    print(f"Altitude MAE: {mae}")
    rdsm_tmp = os.path.join(run_out, f"{src_id}_rdsm_epoch{epoch_number}.tif")
    if os.path.exists(rdsm_tmp):
        shutil.copyfile(rdsm_tmp, rdsm_tmp.replace(".tif", f"_{mae:.3f}.tif"))
        os.remove(rdsm_tmp)

    # water-masked copy of the GT DSM for visual comparison
    # (create_satnerf_dsm.py:112-131)
    aoi_id = src_id[:7]
    gt_dsm_path = os.path.join(cfg.gt_dir, f"{aoi_id}_DSM.tif")
    cls = "CLS_v2" if aoi_id in ("JAX_004", "JAX_260") else "CLS"
    gt_seg_path = os.path.join(cfg.gt_dir, f"{aoi_id}_{cls}.tif")
    if os.path.exists(gt_seg_path):
        mask = read_geotiff(gt_seg_path).data[0]
        g = read_geotiff(gt_dsm_path)
        gt_dsm = g.data[0].astype(np.float64)
        gt_dsm[mask == 9] = np.nan
        prof = g.profile.copy()
        prof.dtype = "float64"
        write_geotiff(os.path.join(run_out, "tmp_gt.tif"), gt_dsm[None], prof)
    return mae


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run_id", required=True)
    ap.add_argument("--logs_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--epoch_number", type=int, required=True)
    ap.add_argument("--checkpoints_dir", default=None)
    ap.add_argument("--root_dir", default=None)
    ap.add_argument("--img_dir", default=None)
    ap.add_argument("--gt_dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda or cpu)")
    create_pretty_dsm(**vars(ap.parse_args()))


if __name__ == "__main__":
    main()
