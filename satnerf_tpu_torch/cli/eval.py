"""Novel-view-synthesis evaluation on the PyTorch port — eval.py's eval_aoi.

Render every test image of a trained run, dump the GeoTIFF product set and
report mean PSNR / SSIM / DSM MAE (the reference's eval_satnerf.py). The
weights come from the port's PL-style checkpoint.

Usage:
  python -m satnerf_tpu_torch.cli.eval eval_aoi --run_id RUN --logs_dir logs \
      --output_dir out --epoch_number 28 --split val [--checkpoints_dir ckpts] \
      [--root_dir ...] [--img_dir ...] [--gt_dir ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil

import numpy as np


def eval_aoi(run_id: str, logs_dir: str, output_dir: str, epoch_number: int,
             split: str = "val", checkpoints_dir: str | None = None,
             root_dir: str | None = None, img_dir: str | None = None,
             gt_dir: str | None = None, device: str = "cuda"):
    from satnerf_tpu.data.satellite import SatelliteScene
    from satnerf_tpu.ops.ssim import psnr as psnr_np
    from satnerf_tpu.ops.ssim import ssim as ssim_np
    from satnerf_tpu_torch.eval import (compute_mae_and_save_dsm_diff,
                                        find_best_embedding_for_val_image,
                                        predefined_val_ts,
                                        save_nerf_output_to_images)
    from satnerf_tpu_torch.eval.loader import load_run

    cfg, system, params = load_run(run_id, logs_dir, epoch_number,
                                   checkpoints_dir, root_dir, img_dir, gt_dir,
                                   device)

    dataset = SatelliteScene(cfg.root_dir, cfg.img_dir,
                             split="eval_train" if split == "train" else "val",
                             img_downscale=cfg.img_downscale,
                             cache_dir=cfg.cache_dir)
    first = 0 if split == "train" else 1
    psnr, ssim, mae = [], [], []
    for i in range(first, len(dataset.records)):
        sample = dataset.load_image(i)
        rays, rgbs = sample["rays"], sample["rgbs"]
        src_id = sample["src_id"]
        h, w = int(sample["h"]), int(sample["w"])

        ts = None
        if cfg.model == "sat-nerf":
            if split == "val":
                t = predefined_val_ts(src_id)
                if t is None:
                    n_search = min(dataset.n_train, cfg.t_embbeding_vocab)
                    t = find_best_embedding_for_val_image(
                        system, params, rays, rgbs,
                        train_indices=range(n_search))
                    print(f"  (searched embedding for {src_id}: t={t})")
                ts = np.full(rays.shape[0], t, dtype=np.int32)
            else:
                ts = sample["ts"]

        results = system.render_image(params, rays, ts)

        out_dir = os.path.join(output_dir, run_id, split)
        os.makedirs(out_dir, exist_ok=True)
        save_nerf_output_to_images(dataset, sample, results, out_dir,
                                   epoch_number)

        typ = "fine" if "rgb_fine" in results else "coarse"
        psnr_ = psnr_np(results[f"rgb_{typ}"], rgbs)
        psnr.append(psnr_)
        pred_chw = np.moveaxis(results[f"rgb_{typ}"].reshape(h, w, 3), -1, 0)
        gt_chw = np.moveaxis(rgbs.reshape(h, w, 3), -1, 0)
        ssim_ = ssim_np(pred_chw, gt_chw)
        ssim.append(ssim_)

        mae_ = float("nan")
        if cfg.gt_dir is not None:
            pred_dsm_path = f"{out_dir}/dsm/{src_id}_epoch{epoch_number}.tif"
            try:
                mae_ = compute_mae_and_save_dsm_diff(
                    pred_dsm_path, src_id, cfg.gt_dir, out_dir, epoch_number)
            except (AssertionError, FileNotFoundError) as e:
                print(f"  (no DSM GT for {src_id}: {e})")
        mae.append(mae_)
        print(f"{src_id}: psnr {psnr_:.3f} / ssim {ssim_:.3f} / mae {mae_:.3f}")

        # tuck registered DSMs into subdirs (eval_satnerf.py:300-309)
        for pat, sub in (("*rdsm_epoch*.tif", "rdsm"),
                         ("*rdsm_diff_epoch*.tif", "rdsm_diff")):
            for in_tmp in glob.glob(os.path.join(out_dir, pat)):
                out_tmp = os.path.join(out_dir, sub, os.path.basename(in_tmp))
                os.makedirs(os.path.dirname(out_tmp), exist_ok=True)
                shutil.copyfile(in_tmp, out_tmp)
                os.remove(in_tmp)

    print(f"\nMean PSNR: {np.mean(psnr):.3f}")
    print(f"Mean SSIM: {np.mean(ssim):.3f}")
    print(f"Mean MAE: {np.nanmean(mae):.3f}\n")
    return {"psnr": float(np.mean(psnr)), "ssim": float(np.mean(ssim)),
            "mae": float(np.nanmean(mae))}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("eval_aoi")
    e.add_argument("--run_id", required=True)
    e.add_argument("--logs_dir", required=True)
    e.add_argument("--output_dir", required=True)
    e.add_argument("--epoch_number", type=int, required=True)
    e.add_argument("--split", default="val")
    e.add_argument("--checkpoints_dir", default=None)
    e.add_argument("--root_dir", default=None)
    e.add_argument("--img_dir", default=None)
    e.add_argument("--gt_dir", default=None)
    e.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda or cpu)")
    kw = vars(ap.parse_args())
    kw.pop("cmd")
    eval_aoi(**kw)


if __name__ == "__main__":
    main()
