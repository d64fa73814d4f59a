#!/usr/bin/env python3
"""The reference-parity protocol through the port (counterpart of
tools/parity_report.py).

One command that takes a prepared DFC2019-style dataset and a checkpoint,
renders the val split through the port's eval (`cli/eval.py` `eval_aoi`, on
the card unless `--device cpu`, on the cards eval/loader.py's
`render_ranks` gives)
and writes a side-by-side parity report (PSNR / SSIM / DSM MAE): the
reference's eval protocol (eval_satnerf.py:213-313) as a single unit. With
SATNERF_COORDINATOR set every process runs the tool as its rank, and rank 0
alone writes.

Usage:
  python tools/parity_report_torch.py --ckpt /path/epoch=27.ckpt \\
      --root_dir DATASET_DIR [--img_dir ...] --gt_dir TRUTH_DIR \\
      --output_dir OUT [--device cuda|cpu] \\
      [--opts /path/ref_run/opts.json]            # reference run config
      [--model sat-nerf --fc_layers 8 --fc_units 512 ...]  # or explicit
      [--expected_psnr X --expected_ssim Y --expected_mae Z]

The checkpoint is any the port's loader reads (train/checkpoints.py
`load_checkpoint`): a PL-style torch .ckpt (the reference's, or the port's
own) or a msgpack .ckpt of the JAX package. Writes
{output_dir}/parity_report.json with the JAX tool's keys and prints the
same table.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN_ID = "parity"
MODEL_KEYS = ("model", "fc_layers", "fc_units", "n_samples", "n_importance",
              "t_embbeding_vocab", "t_embbeding_tau", "img_downscale",
              "chunk")


def build_config(args):
    from satnerf_tpu_torch.config import Config

    fields = Config.__dataclass_fields__
    base = {}
    if args.opts:
        with open(args.opts) as f:
            base = {k: v for k, v in json.load(f).items() if k in fields}
    for k in MODEL_KEYS:
        v = getattr(args, k, None)
        if v is not None:
            base[k] = v
    base["root_dir"] = args.root_dir
    base["img_dir"] = args.img_dir or args.root_dir
    base["gt_dir"] = args.gt_dir
    base["cache_dir"] = args.cache_dir
    base["exp_name"] = RUN_ID
    base["logs_dir"] = os.path.join(args.output_dir, "logs")
    base["ckpts_dir"] = os.path.join(args.output_dir, "ckpts")
    return Config(**base)


def _evaluate(cfg, args, epoch: int):
    """Rank 0 writes a run directory the eval surface reads
    ({logs}/parity/opts.json + {ckpts}/parity/epoch={N}.ckpt) before any
    rank reads it; then eval_aoi's scores (None on the other ranks)."""
    from satnerf_tpu_torch.cli.eval import eval_aoi
    from satnerf_tpu_torch.parallel import distributed as D
    from satnerf_tpu_torch.train.checkpoints import checkpoint_path

    if D.is_main():
        cfg.dump()
        dst = checkpoint_path(cfg.ckpts_dir, RUN_ID, epoch)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(args.ckpt, dst)
    D.barrier()
    return eval_aoi(run_id=RUN_ID, logs_dir=cfg.logs_dir,
                    output_dir=args.output_dir, epoch_number=epoch,
                    split="val", checkpoints_dir=cfg.ckpts_dir,
                    root_dir=cfg.root_dir, img_dir=cfg.img_dir,
                    gt_dir=cfg.gt_dir, device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="PL-style torch .ckpt or the JAX package's msgpack "
                         ".ckpt")
    ap.add_argument("--root_dir", required=True)
    ap.add_argument("--img_dir", default=None)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--cache_dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda or cpu)")
    ap.add_argument("--opts", default=None,
                    help="reference run opts.json (model spec)")
    ap.add_argument("--model", default=None)
    for k in ("fc_layers", "fc_units", "n_samples", "n_importance",
              "t_embbeding_vocab", "t_embbeding_tau", "chunk"):
        ap.add_argument(f"--{k}", type=int, default=None)
    ap.add_argument("--img_downscale", type=float, default=None)
    for k in ("psnr", "ssim", "mae"):
        ap.add_argument(f"--expected_{k}", type=float, default=None)
    args = ap.parse_args(argv)

    import torch

    from satnerf_tpu_torch.parallel import distributed as D

    cfg = build_config(args)
    m = re.search(r"epoch=(\d+)", os.path.basename(args.ckpt))
    epoch = int(m.group(1)) if m else 0
    # as a rank of SATNERF_COORDINATOR's group, or alone; eval_aoi then
    # renders on the ranks the run's n_devices and views call for
    ours = D.run_in_group(_evaluate, (cfg, args, epoch), 1,
                          torch.device(args.device).type)
    if ours is None:  # a rank other than 0
        return None

    expected = {"psnr": args.expected_psnr, "ssim": args.expected_ssim,
                "mae": args.expected_mae}
    report = {"checkpoint": os.path.abspath(args.ckpt), "epoch": epoch,
              "root_dir": os.path.abspath(cfg.root_dir),
              "ours": ours, "reference": expected,
              "delta": {k: (ours[k] - expected[k]
                            if expected[k] is not None else None)
                        for k in ours}}
    out_path = os.path.join(args.output_dir, "parity_report.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)

    print(f"\nparity report -> {out_path}")
    print(f"{'metric':>8} | {'ours':>10} | {'reference':>10} | {'delta':>10}")
    for k in ("psnr", "ssim", "mae"):
        ref = expected[k]
        print(f"{k:>8} | {ours[k]:>10.4f} | "
              f"{(f'{ref:.4f}' if ref is not None else '—'):>10} | "
              f"{(f'{ours[k] - ref:+.4f}' if ref is not None else '—'):>10}")
    return report


if __name__ == "__main__":
    main()
