#!/usr/bin/env python
"""Convergence of the PyTorch port seed by seed against the JAX package's
recorded runs (CONVERGENCE_r05.json).

It trains the configuration of CONVERGENCE_r05.json (sat-nerf 8 x 64, 32
samples, batch 1024, 3,000 steps, solar correction 0.05) through the port's
`cli.train` at each seed and scores the final checkpoint through its
`cli.eval` (mean PSNR / SSIM / DSM MAE over the test view), on the AOI that
file was made on: `tools/make_synthetic_aoi.py --size 128 --n_train 8
--n_test 1`, built here by satnerf_tpu_torch.data.synthetic (the same
bytes). The training options are those the JAX harness gave its own runs
(tools/train_reference_torch.py `_configs`: `--sampling shuffle`, float32,
no noise, no validation during training). JAX is not run again: the report
sets each of the port's figures beside the file's `ours` (the JAX package)
and `torch_reference` of the same seed.

Two arms, each at every seed:
  torch  the port's own initial weights (torch.Generator at the seed);
  jax    the JAX package's initial weights of that seed, the checkpoint its
         `fit` starts from (tests/data/jax_init_sat-nerf_8x64_seed{N}.ckpt,
         through `--ckpt_path`), so that only the ray draws differ.

Each per-seed difference from `ours` is held against CONVERGED_BAND
(tests/test_convergence_parity.py's cap for a port-against-JAX figure).

  python tools/convergence_torch.py WORKDIR [--seeds 0 1 2] \\
      [--init_dir tests/data] [--device cuda|cpu] [--preset full|smoke] \\
      [--out CONVERGENCE-torch.json]

The committed report is CONVERGENCE-torch.json: a name outside
tests/test_convergence_parity.py's CONVERGENCE_*.json, whose reports hold
the JAX package against the torch reference trainer in another schema.

`--preset smoke` keeps the width (the fixtures' 8 x 64) and cuts the AOI,
the batch, the samples and the steps, for a run on the CPU in seconds.
Everything a preset builds lies under WORKDIR/<preset>/, and runs already
scored there are not run again.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from run_capability_experiments_torch import _card  # noqa: E402

REFERENCE = os.path.join(REPO, "CONVERGENCE_r05.json")
METRICS = ("psnr", "ssim", "mae")
# tests/test_convergence_parity.py:41, the cap on a port-against-JAX figure
CONVERGED_BAND = {"psnr": 1.5, "ssim": 0.05, "mae": 1.5}
# the AOI and the config are the reference file's; smoke cuts what its name
# says and nothing of the model
PRESETS = {
    "full": {"aoi": dict(size=128, n_train=8, n_test=1), "cfg": {}},
    "smoke": {"aoi": dict(size=16, n_train=8, n_test=1),
              "cfg": dict(batch_size=64, n_samples=8, max_train_steps=4)},
}
ARMS = {"torch": "torch_init", "jax": "jax_init"}


def reference() -> dict:
    with open(REFERENCE) as f:
        return json.load(f)


def run_config(preset: str) -> dict:
    """CONVERGENCE_r05.json's config (seed aside), cut by the preset."""
    cfg = {k: v for k, v in reference()["config"].items() if k != "seed"}
    cfg.update(PRESETS[preset]["cfg"])
    return cfg


def train_argv(cfg: dict, aoi: str, workdir: str, name: str, seed: int,
               device: str, ckpt_path: str | None) -> list:
    """cli.train's flags for one run: the config, and the options the JAX
    harness trained its own runs with (train_reference_torch.py _configs)."""
    argv = ["--root_dir", os.path.join(aoi, "data"),
            "--gt_dir", os.path.join(aoi, "gt"),
            "--cache_dir", os.path.join(aoi, "cache"),
            "--logs_dir", os.path.join(workdir, "logs"),
            "--ckpts_dir", os.path.join(workdir, "ckpts"),
            "--exp_name", name, "--seed", str(seed), "--device", device,
            "--sampling", "shuffle", "--precision", "float32",
            "--save_every_n_epochs", str(10 ** 6),
            "--val_every_n_epochs", str(10 ** 6),
            "--num_sanity_val_steps", "0"]
    for k, v in cfg.items():
        if isinstance(v, bool):
            argv += [f"--{k}"] if v else []
        else:
            argv += [f"--{k}", str(v)]
    if ckpt_path is not None:
        argv += ["--ckpt_path", ckpt_path]
    return argv


def _final_checkpoint(ckpts_dir: str, name: str):
    """(run id, epoch) of the last checkpoint of the run named `name` (the
    run id is cli.train's time-stamped name), or None."""
    found = []
    for p in glob.glob(os.path.join(ckpts_dir, f"*_{name}", "epoch=*.ckpt")):
        epoch = int(re.search(r"epoch=(\d+)\.ckpt$", p).group(1))
        found.append((os.path.basename(os.path.dirname(p)), epoch))
    return max(found, key=lambda r: (r[1], r[0])) if found else None


def run_one(args, workdir: str, cfg: dict, aoi: str, arm: str,
            seed: int) -> dict:
    """Train and score one (arm, seed) in `workdir`; the metrics and the
    run's timing."""
    from satnerf_tpu_torch.cli import train
    from satnerf_tpu_torch.cli.eval import eval_aoi
    from satnerf_tpu_torch.train.checkpoints import jax_init_path

    name = f"{ARMS[arm]}_seed{seed}"
    path = os.path.join(workdir, "metrics", f"{name}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    ckpt = (jax_init_path(args.init_dir, cfg["model"], cfg["fc_layers"],
                          cfg["fc_units"], seed) if arm == "jax" else None)
    ckpts_dir = os.path.join(workdir, "ckpts")
    t0 = time.time()
    train.main(train_argv(cfg, aoi, workdir, name, seed, args.device, ckpt))
    seconds = time.time() - t0
    run_id, epoch = _final_checkpoint(ckpts_dir, name)
    metrics = eval_aoi(run_id, os.path.join(workdir, "logs"),
                       os.path.join(workdir, "eval"), epoch,
                       split="val", checkpoints_dir=ckpts_dir,
                       device=args.device)
    result = {"val": metrics, "run_id": run_id, "epoch": epoch,
              "train_seconds": seconds,
              "steps_per_sec": cfg["max_train_steps"] / seconds,
              "init_checkpoint": (os.path.relpath(ckpt, REPO)
                                  if ckpt else None)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def _summary(values: list) -> dict:
    return {"per_seed": values, "mean": float(np.mean(values)),
            "std": float(np.std(values, ddof=1)) if len(values) > 1 else None}


def compare(runs: dict, seeds: list, ref: dict) -> list:
    """Per seed: each arm's metrics beside the reference file's `ours` and
    `torch_reference` of the same seed, each arm's difference from `ours`
    (port minus JAX) and whether it lies within CONVERGED_BAND."""
    rows = []
    for seed in seeds:
        i = ref["seeds"].index(seed)
        row = {"seed": seed,
               "ours": {k: ref["ours"][k]["per_seed"][i] for k in METRICS},
               "torch_reference": {k: ref["torch_reference"][k]["per_seed"][i]
                                   for k in METRICS},
               "diff_vs_ours": {}, "within_band": {}}
        for arm, by_seed in runs.items():
            m = by_seed[seed]["val"]
            row[arm] = {k: m[k] for k in METRICS}
            diff = {k: m[k] - row["ours"][k] for k in METRICS}
            row["diff_vs_ours"][arm] = diff
            row["within_band"][arm] = {
                k: bool(abs(diff[k]) <= CONVERGED_BAND[k]) for k in METRICS}
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--init_dir", default=os.path.join(REPO, "tests", "data"),
                    help="where the jax arm's initial checkpoints are")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--preset", default="full", choices=sorted(PRESETS))
    ap.add_argument("--out", default=None,
                    help="also write the report here (CONVERGENCE-torch.json)")
    args = ap.parse_args(argv)

    from satnerf_tpu_torch.data import synthetic
    from satnerf_tpu_torch.train.checkpoints import jax_init_path

    ref = reference()
    cfg = run_config(args.preset)
    for seed in args.seeds:  # every fixture is found before anything trains
        jax_init_path(args.init_dir, cfg["model"], cfg["fc_layers"],
                      cfg["fc_units"], seed)
    aoi_kw = PRESETS[args.preset]["aoi"]
    aoi_flags = [f"--{k}={v}" for k, v in aoi_kw.items()]
    # a preset's runs never read another's: each has a directory of its own
    workdir = os.path.join(args.workdir, args.preset)
    aoi = os.path.join(workdir, "aoi")
    if not os.path.isdir(os.path.join(aoi, "data")):
        synthetic.main([aoi] + aoi_flags)

    t_all = time.time()
    runs = {ARMS[arm]: {seed: run_one(args, workdir, cfg, aoi, arm, seed)
                        for seed in args.seeds} for arm in ARMS}
    report = {
        "preset": args.preset,
        "config": {**cfg, "seed": ref["config"]["seed"]},
        "steps": cfg["max_train_steps"],
        "seeds": list(args.seeds),
        "band": CONVERGED_BAND,
        "arms": {arm: {k: _summary([by_seed[s]["val"][k]
                                    for s in args.seeds]) for k in METRICS}
                 for arm, by_seed in runs.items()},
        "per_seed": compare(runs, args.seeds, ref),
        "runs": {arm: {str(s): r for s, r in by_seed.items()}
                 for arm, by_seed in runs.items()},
        "device": _card(args.device),
        "provenance": {
            "generator": "tools/convergence_torch.py --preset "
                         f"{args.preset} --device {args.device} --seeds "
                         + " ".join(map(str, args.seeds)),
            "aoi": "satnerf_tpu_torch.data.synthetic " + " ".join(aoi_flags),
            "reference": os.path.relpath(REFERENCE, REPO),
            "seconds": time.time() - t_all,
        },
    }
    path = os.path.join(workdir, "convergence_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")
    print(f"wrote {path}")
    print(json.dumps([{k: row[k] for k in ("seed", "diff_vs_ours")}
                      for row in report["per_seed"]], indent=2))
    return report


if __name__ == "__main__":
    main()
