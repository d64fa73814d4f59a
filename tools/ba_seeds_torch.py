#!/usr/bin/env python
"""The BA capability experiment seed by seed, and the JAX package's own
reading of it on the CPU, gathered into one report
(CAPABILITY_torch_ba_seeds.json).

  seeds    runs tools/run_capability_experiments_torch.py --experiments ba
           (the port, on the card by default) at each seed, each into
           WORK/seed<N>, several seeds side by side (`--parallel`);
  cpu      trains the BA experiment's noisy runs (noba, noba_ds) at one
           seed on the CPU, side by side: `--side jax` the JAX package
           through its own tool's train and eval phases
           (tools/run_capability_experiments.py, its AOI builder, preset
           and overrides), into WORK/jax; `--side torch` the port through
           the port's tool's phases (the same AOI, byte for byte, the same
           overrides), into WORK/torch;
  collect  writes the report: for each seed the three MAEs and both BA
           gates, then their min, median and max, and the CPU readings
           under "jax_cpu" and "torch_cpu" where WORK holds them.

  python tools/ba_seeds_torch.py seeds WORK --seeds 0 1 2 --parallel 3
  python tools/ba_seeds_torch.py cpu WORK --side jax --seed 0
  python tools/ba_seeds_torch.py collect WORK  # writes the report

The port's runs import nothing of JAX; `--side jax` runs the JAX package in
child processes of its own tool.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATES = {"ba_noise_degrades_mae": 1.5, "ba_ds_recovers_mae": 0.5}


def _run_seeds(args):
    procs, todo = [], list(args.seeds)
    t0 = time.time()
    failed = []
    while todo or procs:
        while todo and len(procs) < args.parallel:
            s = todo.pop(0)
            work = os.path.join(args.workdir, f"seed{s}")
            os.makedirs(work, exist_ok=True)
            log = open(os.path.join(work, "log.txt"), "a")
            cmd = [sys.executable, "-u", os.path.join(
                REPO, "tools", "run_capability_experiments_torch.py"), work,
                   "--preset", args.preset, "--device", args.device,
                   "--experiments", "ba", "--seed", str(s)]
            procs.append((s, log, subprocess.Popen(
                cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)))
        time.sleep(2)
        for item in list(procs):
            s, log, p = item
            if p.poll() is not None:
                log.close()
                procs.remove(item)
                print(f"seed {s}: rc {p.returncode} at "
                      f"{time.time() - t0:.0f}s", flush=True)
                if p.returncode != 0:
                    failed.append(s)
    if failed:
        raise SystemExit(f"seeds {failed} failed: see WORK/seed<N>/log.txt")


def _run_cpu(args):
    jax = args.side == "jax"
    tool = os.path.join(REPO, "tools", "run_capability_experiments" +
                        ("" if jax else "_torch") + ".py")
    work = os.path.join(args.workdir, args.side)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from run_capability_experiments_torch import PRESETS, experiment_table

    p = PRESETS[args.preset]
    exp = experiment_table(p)["ba"]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    aoi = os.path.join(work, "aoi", "ba_noisy")
    if not os.path.isdir(os.path.join(aoi, "data")):
        builder = (["tools/make_synthetic_aoi.py"] if jax else
                   ["-m", "satnerf_tpu_torch.data.synthetic"])
        subprocess.run([sys.executable, *builder, aoi, "--seed",
                        str(args.seed)] + exp["aoi"]["ba_noisy"],
                       check=True, cwd=REPO, env=env)
    specs = []
    for run_name, aoi_key, overrides in exp["runs"]:
        if run_name not in args.runs:
            continue
        preset_keys = {k: p[k] for k in ("fc_units", "fc_layers",
                                         "n_samples", "batch_size",
                                         "max_train_steps", "lr")}
        overrides = dict(preset_keys, **overrides, seed=args.seed)
        specs.append({"name": f"ba_{run_name}", "aoi": aoi_key,
                      "overrides": overrides, "train_maps": False})

    def child(spec, phase):
        cmd = [sys.executable, "-u"]
        if jax:
            cmd += [os.path.join(REPO, "tools", "cpu_mesh_run.py"), "-n", "1",
                    tool, work, "--preset", args.preset, "--platform", "cpu"]
        else:
            cmd += [tool, work, "--preset", args.preset, "--device", "cpu"]
        cmd += ["--_phase", phase, "--_spec", json.dumps(spec)]
        log = open(os.path.join(work, f"{spec['name']}_{phase}.log"), "a")
        return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)

    t0 = time.time()
    # the runs train side by side; each is evaluated when it ends
    procs = {s["name"]: child(s, "train") for s in specs}
    seconds = {}
    for s in specs:
        if procs[s["name"]].wait() != 0:
            raise SystemExit(f"{s['name']} train failed")
        seconds[s["name"]] = time.time() - t0
        if child(s, "eval").wait() != 0:
            raise SystemExit(f"{s['name']} eval failed")
    out = {}
    for s in specs:
        with open(os.path.join(work, "metrics", f"{s['name']}.json")) as f:
            out[s["name"]] = json.load(f)
        out[s["name"]]["train_and_wait_seconds"] = seconds[s["name"]]
    with open(os.path.join(work, f"{args.side}_cpu.json"), "w") as f:
        json.dump({"seed": args.seed, "preset": args.preset,
                   "generator": f"tools/ba_seeds_torch.py cpu --side "
                                f"{args.side} --seed {args.seed} --preset "
                                f"{args.preset}",
                   "cpu_cores": len(os.sched_getaffinity(0)),
                   "runs": out}, f, indent=2)


def _spread(values):
    return {"min": min(values), "median": statistics.median(values),
            "max": max(values)}


def _collect(args):
    seeds = {}
    for name in sorted(os.listdir(args.workdir)):
        path = os.path.join(args.workdir, name, "capability_report.json")
        if not (name.startswith("seed") and os.path.exists(path)):
            continue
        with open(path) as f:
            rep = json.load(f)
        b = rep["experiments"]["ba"]
        seeds[int(name[4:])] = {
            "mae": {k: b[k]["val"]["mae"] for k in ("ba", "noba", "noba_ds")},
            "gates": {k: {"value": rep["gates"][k], "limit": lim,
                          "met": rep["gates"][k] >= lim}
                      for k, lim in GATES.items()},
            "train_seconds": {k: b[k].get("train_seconds")
                              for k in ("ba", "noba", "noba_ds")},
            "device": rep.get("device")}
    report = {"experiment": "ba", "preset": args.preset,
              "generator": "tools/ba_seeds_torch.py seeds, then collect",
              "seeds": {str(s): seeds[s] for s in sorted(seeds)}}
    if seeds:
        report["spread"] = {
            **{f"mae_{k}": _spread([v["mae"][k] for v in seeds.values()])
               for k in ("ba", "noba", "noba_ds")},
            **{k: _spread([v["gates"][k]["value"] for v in seeds.values()])
               for k in GATES},
            "ba_ds_recovers_mae_met": sum(
                v["gates"]["ba_ds_recovers_mae"]["met"]
                for v in seeds.values())}
    for side in ("jax", "torch"):
        path = os.path.join(args.workdir, side, f"{side}_cpu.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            j = json.load(f)
        maes = {k[3:]: v["val"]["mae"] for k, v in j["runs"].items()}
        j["mae"] = maes
        if {"noba", "noba_ds"} <= maes.keys():
            j["ba_ds_recovers_mae"] = maes["noba"] - maes["noba_ds"]
        report[f"{side}_cpu"] = j
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report.get("spread", {}), indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("seeds", "cpu", "collect"))
    ap.add_argument("workdir")
    ap.add_argument("--preset", default="full", choices=("full", "smoke"))
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(10)))
    ap.add_argument("--seed", type=int, default=0, help="the cpu mode's")
    ap.add_argument("--side", default="jax", choices=("jax", "torch"),
                    help="the cpu mode's package")
    ap.add_argument("--runs", nargs="+", default=["noba", "noba_ds"],
                    help="the cpu mode's runs of the BA experiment")
    ap.add_argument("--parallel", type=int, default=1,
                    help="seeds side by side (one card is shared)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="CAPABILITY_torch_ba_seeds.json")
    args = ap.parse_args(argv)
    {"seeds": _run_seeds, "cpu": _run_cpu, "collect": _collect}[args.mode](
        args)


if __name__ == "__main__":
    main()
