#!/usr/bin/env python
"""The capability experiments on the PyTorch port: the counterpart of
tools/run_capability_experiments.py, which trains through the JAX package.

It trains A/B model pairs on synthetic AOIs that contain the phenomena the
Sat-NeRF mechanisms exist for, and reports whether each mechanism learns:

  shadow     a shaded AOI (a sun a view, Lambert shading and cast shadows):
             nerf against s-nerf against s-nerf with solar correction. The
             irradiance models should beat nerf on novel views, and the
             rendered sun_v maps should follow the analytic ones
             (correlation and shadow IoU).
  solar      the solar-interpolation study on a shaded AOI of low suns: an
             s-nerf with solar correction 0.1 for 12,000 steps, then a sweep
             of 10 interpolated suns whose sun maps should move.
  transient  an AOI whose train views after the first carry painted boxes:
             s-nerf against sat-nerf. The beta head should recover
             clean-view PSNR and its map should mark the painted pixels.
  ba         the same imagery with true and with mis-registered RPCs, and
             tie points: BA against noBA against noBA with depth
             supervision. The RPC noise should cost DSM MAE and the depth
             supervision win some of it back.

The presets, the experiment table, the training overrides (float32,
cosine learning rate), the sidecar statistics, the report's keys and the
gates are those of the JAX tool. Each run trains through
satnerf_tpu_torch.train.loop.fit and is evaluated through
satnerf_tpu_torch.cli.eval.eval_aoi, each phase (train, eval, sweep) in a
child process (`--in_process`: in this one); the AOIs come from
satnerf_tpu_torch.data.synthetic. Beside
each run's metrics the report keeps its training's wall seconds and steps a
second, and under "device" the card's name and power limit. Runs already
done in WORKDIR are not run again.

`--init_dir DIR` starts every run from the JAX package's initial
checkpoint for its variant, width and seed (train/checkpoints.jax_init_name,
through `ckpt_path`): the weights of the port's own draw, which is the JAX
package's (utils/jax_prng.py), read from a file; the report names the files
under "provenance". A run with no such file stops the tool before anything
trains. tests/data holds them for the full preset at seeds 0 and 1
(tests/test_torch_jax_init.py writes them).

  python tools/run_capability_experiments_torch.py WORKDIR \\
      [--preset full|smoke] [--device cuda|cpu] \\
      [--experiments shadow solar transient ba] [--out CAPABILITY_torch.json]
      [--seed 0] [--fused auto|rays|on|off] [--init_dir tests/data]
      [--in_process]

The full preset runs on the card (the default device); `--preset smoke
--experiments transient --device cpu` drives the transient chain on the CPU
in about a minute.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PRESETS = {
    "full": dict(size=64, n_train=10, n_test=2, fc_units=96, fc_layers=8,
                 n_samples=24, batch_size=2048, max_train_steps=4000,
                 lr=5e-4),
    "smoke": dict(size=32, n_train=4, n_test=1, fc_units=32, fc_layers=4,
                  n_samples=8, batch_size=512, max_train_steps=200,
                  lr=1e-3),
}

# gate -> (">=" or "<=", limit): tests/test_capabilities.py, which holds the
# JAX package's committed report to them; the shadow PSNR gate is a bool
GATES = {
    "shadow_snerf_beats_nerf_psnr": ("is", True),
    "shadow_sun_corr_sc05": (">=", 0.20),
    "shadow_sun_iou_sc05": (">=", 0.055),
    "transient_satnerf_psnr_gain": (">=", 0.30),
    "transient_beta_ratio": (">=", 1.50),
    "ba_noise_degrades_mae": (">=", 1.50),
    "ba_ds_recovers_mae": (">=", 0.50),
    "solar_sweep_corr_extremes": ("<=", 0.97),
    "solar_sweep_shadow_iou_extremes": ("<=", 0.85),
    "solar_sweep_rel_std": (">=", 0.030),
}


def experiment_table(p):
    """experiment -> {"aoi": {key: synthetic AOI flags}, "runs": [(run,
    aoi key, config overrides)][, "sweep": [run]]}, as the JAX tool's."""
    # view_spread 0.25: the geometry anchor's parallax
    common_aoi = ["--size", str(p["size"]), "--n_train", str(p["n_train"]),
                  "--n_test", str(p["n_test"]), "--alt_bounds", "terrain",
                  "--view_spread", "0.25", "--checker", "8"]
    # smooth terrain and low suns for long cast shadows
    shaded_aoi = common_aoi + ["--shading", "--terrain", "smooth",
                               "--checker", "8", "--sun_el", "25", "50"]
    return {
        "shadow": {
            "aoi": {"shaded": shaded_aoi},
            "runs": [
                ("nerf", "shaded", dict(model="nerf", sc_lambda=0.0)),
                ("snerf_sc00", "shaded", dict(model="s-nerf", sc_lambda=0.0)),
                ("snerf_sc05", "shaded", dict(model="s-nerf",
                                              sc_lambda=0.05)),
            ],
        },
        "solar": {
            # its own AOI (suns at 15-40 degrees), three times the steps and
            # the stronger solar correction weight
            "aoi": {"shaded_low": common_aoi + [
                "--shading", "--terrain", "smooth", "--checker", "8",
                "--sun_el", "15", "40"]},
            "runs": [
                ("snerf_sc10", "shaded_low", dict(model="s-nerf",
                                                  sc_lambda=0.1,
                                                  max_train_steps=12000)),
            ],
            "sweep": ["snerf_sc10"],
        },
        "transient": {
            # every train view after the first gets 3 painted boxes
            "aoi": {"transient": common_aoi + ["--transient_frac", "1.0",
                                               "--transient_size", "12",
                                               "--n_transients", "3"]},
            "runs": [
                ("snerf", "transient", dict(model="s-nerf", sc_lambda=0.0)),
                ("satnerf", "transient", dict(model="sat-nerf",
                                              sc_lambda=0.0)),
            ],
        },
        "ba": {
            "aoi": {
                "ba_clean": common_aoi + ["--terrain", "smooth",
                                          "--keypoints", "300"],
                "ba_noisy": common_aoi + ["--terrain", "smooth",
                                          "--keypoints", "300",
                                          "--rpc_noise", "2.5"],
            },
            "runs": [
                ("ba", "ba_clean", dict(model="sat-nerf", sc_lambda=0.0)),
                ("noba", "ba_noisy", dict(model="sat-nerf", sc_lambda=0.0)),
                ("noba_ds", "ba_noisy", dict(model="sat-nerf", sc_lambda=0.0,
                                             ds_lambda=1000.0)),
            ],
        },
    }


# ------------------------------------------------------------ child phases


def _phase_train(args):
    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.train.loop import fit

    spec = json.loads(args._spec)
    aoi = os.path.join(args.workdir, "aoi", spec["aoi"])
    cfg = Config(
        exp_name=spec["name"], root_dir=os.path.join(aoi, "data"),
        gt_dir=os.path.join(aoi, "gt"), cache_dir=os.path.join(aoi, "cache"),
        logs_dir=os.path.join(args.workdir, "logs"),
        ckpts_dir=os.path.join(args.workdir, "ckpts"),
        save_every_n_epochs=10 ** 6, val_every_n_epochs=10 ** 6,
        num_sanity_val_steps=0, noise_std=0.0, precision="float32",
        # tiny AOIs make tiny epochs: StepLR's 0.9 an epoch would freeze the
        # runs' ~200 epochs early; cosine keeps them learning to the end
        lr_scheduler="cosine", device=args.device, fused=args.fused,
        **spec["overrides"])
    t0 = time.time()
    fit(cfg)
    seconds = time.time() - t0
    with open(os.path.join(cfg.logs_dir, cfg.exp_name, "metrics.jsonl")) as f:
        rates = [r["train/rays_per_sec"] for r in map(json.loads, f)
                 if "train/rays_per_sec" in r]
    timing = {"train_seconds": seconds,
              "steps_per_sec": cfg.max_train_steps / seconds,
              "logged_steps_per_sec_median":
                  (float(np.median(rates)) / cfg.batch_size if rates
                   else None)}
    path = os.path.join(args.workdir, "timing", f"{spec['name']}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(timing, f, indent=2)


def _final_epoch(workdir, name):
    ckpts = glob.glob(os.path.join(workdir, "ckpts", name, "epoch=*.ckpt"))
    return max(int(re.search(r"epoch=(\d+)\.ckpt$", p).group(1))
               for p in ckpts)


def _phase_eval(args):
    from satnerf_tpu_torch.cli.eval import eval_aoi

    spec = json.loads(args._spec)
    name = spec["name"]
    aoi = os.path.join(args.workdir, "aoi", spec["aoi"])
    epoch = _final_epoch(args.workdir, name)
    out_dir = os.path.join(args.workdir, "eval")
    logs = os.path.join(args.workdir, "logs")
    t0 = time.time()
    metrics = eval_aoi(name, logs, out_dir, epoch, split="val",
                       device=args.device)
    result = {"val": metrics, "epoch": epoch}

    if spec.get("train_maps"):
        eval_aoi(name, logs, out_dir, epoch, split="train", device=args.device)
        data_dir = os.path.join(aoi, "data")
        train_out = os.path.join(out_dir, name, "train")
        sun = _sun_agreement(data_dir, train_out, epoch)
        if sun:
            result["sun"] = sun
        beta = _beta_localization(data_dir, train_out, epoch)
        if beta:
            result["beta"] = beta
    timing = os.path.join(args.workdir, "timing", f"{name}.json")
    if os.path.exists(timing):
        with open(timing) as f:
            result.update(json.load(f))
    result["eval_seconds"] = time.time() - t0

    path = os.path.join(args.workdir, "metrics", f"{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"[{name}] {json.dumps(result)}")


def _read(path):
    from satnerf_tpu_torch.geo.geotiff import read_geotiff

    return np.asarray(read_geotiff(path).data, np.float64).ravel()


def _sidecars(train_out, product, epoch, data_dir, suffix):
    """(rendered map, sidecar array) pairs of the train views that have the
    sidecar {src}{suffix}.npy."""
    pairs = []
    for p in sorted(glob.glob(os.path.join(train_out, product,
                                           f"*_epoch{epoch}.tif"))):
        src = re.sub(rf"_epoch{epoch}\.tif$", "", os.path.basename(p))
        side = os.path.join(data_dir, f"{src}{suffix}.npy")
        if os.path.exists(side):
            pairs.append((_read(p), np.load(side).ravel()))
    return pairs


def _sun_agreement(data_dir, train_out, epoch):
    """Pearson correlation of each rendered (composited) sun_v map with the
    AOI's analytic sun map, and the shadow-mask IoU with the predicted mask
    thresholded relative to the image's own bright level (0.5 x P90) and the
    analytic one at sun_term < 0.3: the composited map is not normalized by
    the weights' sum, so the comparison is scale-free."""
    corrs, ious = [], []
    for pred, ana in _sidecars(train_out, "sun", epoch, data_dir, "_SUN"):
        corrs.append(float(np.corrcoef(pred, ana)[0, 1]))
        sm = ana < 0.3
        pm = pred < 0.5 * np.percentile(pred, 90)
        ious.append(float((sm & pm).sum() / max((sm | pm).sum(), 1)))
    if not corrs:
        return None
    return {"corr_mean": float(np.mean(corrs)),
            "shadow_iou_mean": float(np.mean(ious)),
            "per_image_corr": corrs, "per_image_iou": ious}


def _beta_localization(data_dir, train_out, epoch):
    """Mean rendered beta inside and outside each view's transient mask."""
    inside, outside = [], []
    for beta, mask in _sidecars(train_out, "beta", epoch, data_dir,
                                "_TRANSIENT"):
        inside.append(float(beta[mask].mean()))
        outside.append(float(beta[~mask].mean()))
    if not inside:
        return None
    return {"beta_in_mask": float(np.mean(inside)),
            "beta_off_mask": float(np.mean(outside)),
            "ratio": float(np.mean(inside) / max(np.mean(outside), 1e-9))}


def _phase_sweep(args):
    """The port's sun_interp on the trained checkpoint, then how far the
    sweep's sun maps move (_sweep_stats)."""
    from satnerf_tpu_torch.cli.study_solar_interpolation import sun_interp

    spec = json.loads(args._spec)
    name = spec["name"]
    epoch = _final_epoch(args.workdir, name)
    out_dir = os.path.join(args.workdir, "solar")
    sun_interp(name, os.path.join(args.workdir, "logs"), out_dir, epoch,
               n_interp=10, device=args.device)
    stats = _sweep_stats(os.path.join(out_dir, name, "sun"))

    mpath = os.path.join(args.workdir, "metrics", f"{name}.json")
    with open(mpath) as f:
        result = json.load(f)
    result["sweep"] = stats
    with open(mpath, "w") as f:
        json.dump(result, f, indent=2)
    print(f"[{name}] sweep {json.dumps(stats)}")


def _sweep_stats(sun_dir):
    """Across the sweep's sun maps, sorted by solar incidence angle: the
    correlation and shadow-mask IoU of the two extreme suns, the mean
    per-pixel std over all angles relative to the mean level, and each
    angle's shadow fraction (masks as in _sun_agreement)."""
    paths = []
    for p in glob.glob(os.path.join(sun_dir, "*deg.tif")):
        m = re.search(r"solar_incidence_angle_([0-9.]+)deg", p)
        if m:
            paths.append((float(m.group(1)), p))
    paths.sort()
    maps = [_read(p) for _, p in paths]
    stack = np.stack(maps)
    lo, hi = stack[0], stack[-1]
    masks = [m < 0.5 * np.percentile(m, 90) for m in (lo, hi)]
    return {
        "n_interp": len(maps),
        "angles_deg": [a for a, _ in paths],
        "corr_extremes": float(np.corrcoef(lo, hi)[0, 1]),
        "shadow_iou_extremes": float((masks[0] & masks[1]).sum()
                                     / max((masks[0] | masks[1]).sum(), 1)),
        "rel_std": float(stack.std(axis=0).mean() / max(stack.mean(), 1e-9)),
        "shadow_frac_per_angle": [
            float((m < 0.5 * np.percentile(m, 90)).mean()) for m in maps],
    }


# ----------------------------------------------------------------- parent


def _child(args, spec, phase):
    """Run one phase of one run in a child process, or in this one with
    --in_process."""
    t0 = time.time()
    if args.in_process:
        PHASES[phase](argparse.Namespace(**{**vars(args),
                                            "_spec": json.dumps(spec)}))
    else:
        cmd = [sys.executable, "-u", os.path.abspath(__file__), args.workdir,
               "--preset", args.preset, "--device", args.device,
               "--fused", args.fused, "--_phase", phase,
               "--_spec", json.dumps(spec)]
        r = subprocess.run(cmd, cwd=REPO)
        if r.returncode != 0:
            raise RuntimeError(
                f"{spec['name']} phase {phase} failed ({r.returncode})")
    print(f"[{spec['name']}:{phase}] done in {time.time() - t0:.0f}s")


PHASES = {"train": _phase_train, "eval": _phase_eval, "sweep": _phase_sweep}


def run_specs(p: dict, experiments, seed: int, init_dir=None) -> list:
    """(experiment, run, spec) for every run of `experiments` in order, the
    spec as the train / eval / sweep phases take it. With `init_dir` each
    run's ckpt_path is the JAX initial checkpoint of its variant, width and
    seed (FileNotFoundError for the first run without one)."""
    from satnerf_tpu_torch.train.checkpoints import jax_init_path

    table = experiment_table(p)
    out = []
    for exp_name in experiments:
        for run_name, aoi_key, overrides in table[exp_name]["runs"]:
            preset_keys = {k: p[k] for k in ("fc_units", "fc_layers",
                                             "n_samples", "batch_size",
                                             "max_train_steps", "lr")}
            overrides = dict(preset_keys, **overrides)  # run overrides win
            overrides["seed"] = seed
            if init_dir is not None:
                overrides["ckpt_path"] = os.path.abspath(jax_init_path(
                    init_dir, overrides["model"], overrides["fc_layers"],
                    overrides["fc_units"], seed))
            out.append((exp_name, run_name, {
                "name": f"{exp_name}_{run_name}", "aoi": aoi_key,
                "overrides": overrides,
                "train_maps": exp_name in ("shadow", "transient")}))
    return out


def _sha256(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def compute_gates(experiments: dict) -> dict:
    """The report's gate values from its experiments, as the JAX tool
    computes them."""
    gates = {}
    if "shadow" in experiments:
        s = experiments["shadow"]
        gates["shadow_snerf_beats_nerf_psnr"] = (
            s["snerf_sc05"]["val"]["psnr"] > s["nerf"]["val"]["psnr"])
        gates["shadow_sun_corr_sc05"] = s["snerf_sc05"].get(
            "sun", {}).get("corr_mean")
        gates["shadow_sun_iou_sc05"] = s["snerf_sc05"].get(
            "sun", {}).get("shadow_iou_mean")
    if "solar" in experiments:
        sw = experiments["solar"]["snerf_sc10"].get("sweep", {})
        gates["solar_sweep_corr_extremes"] = sw.get("corr_extremes")
        gates["solar_sweep_shadow_iou_extremes"] = sw.get(
            "shadow_iou_extremes")
        gates["solar_sweep_rel_std"] = sw.get("rel_std")
    if "transient" in experiments:
        t = experiments["transient"]
        gates["transient_satnerf_psnr_gain"] = (
            t["satnerf"]["val"]["psnr"] - t["snerf"]["val"]["psnr"])
        gates["transient_beta_ratio"] = t["satnerf"].get(
            "beta", {}).get("ratio")
    if "ba" in experiments:
        b = experiments["ba"]
        gates["ba_noise_degrades_mae"] = (
            b["noba"]["val"]["mae"] - b["ba"]["val"]["mae"])
        gates["ba_ds_recovers_mae"] = (
            b["noba"]["val"]["mae"] - b["noba_ds"]["val"]["mae"])
    return gates


def gate_verdicts(gates: dict) -> dict:
    """gate -> {"value", "op", "limit", "met"} for every gate reported."""
    out = {}
    for name, value in gates.items():
        op, limit = GATES[name]
        if value is None:
            met = False
        elif op == "is":
            met = value is limit
        elif op == ">=":
            met = value >= limit
        else:
            met = value <= limit
        out[name] = {"value": value, "op": op, "limit": limit,
                     "met": bool(met)}
    return out


def _card(device: str):
    """The card's name and power limit as nvidia-smi gives them."""
    if device != "cuda":
        return {"platform": "cpu"}
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.stdout.strip().splitlines()[:1]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir")
    ap.add_argument("--preset", default="full", choices=sorted(PRESETS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--experiments", nargs="+",
                    default=["shadow", "solar", "transient", "ba"])
    ap.add_argument("--out", default=None,
                    help="also write the report here (CAPABILITY_torch.json)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused", default="auto",
                    choices=("auto", "rays", "on", "off"),
                    help="the runs' --fused (auto: the kernels on the card; "
                         "off: plain PyTorch, to tell a kernel's fault from "
                         "the training's)")
    ap.add_argument("--init_dir", default=None,
                    help="start each run from the JAX package's initial "
                         "checkpoint of its variant, width and seed in this "
                         "directory (tests/data); a run without one stops "
                         "the tool")
    ap.add_argument("--in_process", action="store_true",
                    help="run the phases in this process, not in children")
    ap.add_argument("--_phase", default=None,
                    choices=("train", "eval", "sweep"), help=argparse.SUPPRESS)
    ap.add_argument("--_spec", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args._phase is not None:
        return PHASES[args._phase](args)

    from satnerf_tpu_torch.data import synthetic

    p = PRESETS[args.preset]
    table = experiment_table(p)
    # every fixture is found (or the tool stops) before anything trains
    specs = run_specs(p, args.experiments, args.seed, args.init_dir)
    report = {"preset": args.preset, "config": p, "experiments": {}}
    t_all = time.time()
    for exp_name in args.experiments:
        exp = table[exp_name]
        for aoi_key, flags in exp["aoi"].items():
            aoi = os.path.join(args.workdir, "aoi", aoi_key)
            if not os.path.isdir(os.path.join(aoi, "data")):
                synthetic.main([aoi, "--seed", str(args.seed)] + flags)
        results = {}
        for _, run_name, spec in (s for s in specs if s[0] == exp_name):
            name = spec["name"]
            mpath = os.path.join(args.workdir, "metrics", f"{name}.json")
            if not os.path.exists(mpath):
                ckpt_dir = os.path.join(args.workdir, "ckpts", name)
                if not glob.glob(os.path.join(ckpt_dir, "epoch=*.ckpt")):
                    _child(args, spec, "train")
                _child(args, spec, "eval")
            if run_name in exp.get("sweep", ()):
                with open(mpath) as f:
                    if "sweep" not in json.load(f):
                        _child(args, spec, "sweep")
            with open(mpath) as f:
                results[run_name] = json.load(f)
        report["experiments"][exp_name] = results

    report["gates"] = compute_gates(report["experiments"])
    report["gate_verdicts"] = gate_verdicts(report["gates"])
    report["device"] = _card(args.device)
    report["provenance"] = {
        "generator": "tools/run_capability_experiments_torch.py --preset "
                     f"{args.preset} --device {args.device} --seed "
                     f"{args.seed} --fused {args.fused} --experiments "
                     + " ".join(args.experiments),
        "seconds": time.time() - t_all,
    }
    if args.init_dir is not None:
        report["provenance"]["generator"] += f" --init_dir {args.init_dir}"
        report["provenance"]["init_checkpoints"] = {
            spec["name"]: {
                "file": os.path.relpath(spec["overrides"]["ckpt_path"], REPO),
                "sha256": _sha256(spec["overrides"]["ckpt_path"])}
            for _, _, spec in specs}

    path = os.path.join(args.workdir, "capability_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")
    print(f"wrote {path}")
    print(json.dumps(report["gate_verdicts"], indent=2))
    return report


if __name__ == "__main__":
    main()
