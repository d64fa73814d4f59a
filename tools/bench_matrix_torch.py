#!/usr/bin/env python3
"""Run the port's bench (python -m satnerf_tpu_torch.cli.bench) over the
rows of the JAX package's tools/bench_matrix.py and write ONE JSON file
with that tool's schema (BENCH_MATRIX_r05.json).

The nine rows carry tools/bench_matrix.py's names and BENCH_* overrides;
train_default_b1024 adds the batch users train at (Config.batch_size), where
the bench's train default is the largest batch that fits the card. Each row
is a subprocess of its own, on one card (BENCH_DEVICE, default cuda, passes
through).

Usage:
  python3 tools/bench_matrix_torch.py [--out BENCH_MATRIX_torch.json] [--rows a,b,...]
      [--timeout S]
  python3 tools/bench_matrix_torch.py --list

Writes {"rows": {name: bench line + wall_s}, "failed": {name: reason},
"env": the BENCH_* variables} and exits nonzero if any selected row failed.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> BENCH_* overrides (the bench's defaults: sat-nerf 8 x 512, 64
# samples, bf16, fused auto, train mode, 20 steps; the largest train batch
# the card holds, 65,536 rays a render)
ROWS = {
    "train_default": {},
    "train_default_b1024": {"BENCH_BATCH": "1024"},
    "train_sc": {"BENCH_SC": "0.05"},
    "train_nimp": {"BENCH_NIMP": "8"},
    "train_nerf": {"BENCH_MODEL": "nerf"},
    "serve_rays": {"BENCH_MODE": "render", "BENCH_FUSED": "rays",
                   "BENCH_BATCH": "262144"},
    "serve_points": {"BENCH_MODE": "render", "BENCH_FUSED": "on",
                     "BENCH_BATCH": "131072"},
    "serve_nimp": {"BENCH_MODE": "render", "BENCH_FUSED": "rays",
                   "BENCH_NIMP": "8", "BENCH_BATCH": "262144"},
    "serve_nerf": {"BENCH_MODE": "render", "BENCH_MODEL": "nerf",
                   "BENCH_BATCH": "262144"},
    "image_surface": {"BENCH_MODE": "image", "BENCH_BATCH": "262144",
                      "BENCH_STEPS": "5"},
}


def run_row(name: str, overrides: dict, timeout_s: int) -> dict:
    env = dict(os.environ)
    env.update(overrides)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "satnerf_tpu_torch.cli.bench"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout_s)
    dt = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"bench exit {proc.returncode}: {proc.stderr[-2000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    row["wall_s"] = dt
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="BENCH_MATRIX_torch.json")
    ap.add_argument("--rows", default=None,
                    help="comma-separated subset (default: all)")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="per-row wall timeout, seconds")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for k, v in ROWS.items():
            print(f"{k}: {v or '(defaults)'}")
        return 0

    selected = args.rows.split(",") if args.rows else list(ROWS)
    unknown = [r for r in selected if r not in ROWS]
    if unknown:
        sys.exit(f"unknown rows: {unknown}; use --list")

    results, failed = {}, {}
    for name in selected:
        print(f"[{name}] running...", flush=True)
        try:
            row = run_row(name, ROWS[name], args.timeout)
            results[name] = row
            print(f"[{name}] {row['value']:,.1f} {row['unit']} (mfu "
                  f"{row['mfu']:.4f}, device_ms {row['device_ms']}, idle "
                  f"{row['idle']}) in {row['wall_s']:.1f} s", flush=True)
        except Exception as e:  # keep measuring the remaining rows
            failed[name] = str(e)
            print(f"[{name}] FAILED: {e}", flush=True)

    out = {"rows": results, "failed": failed,
           "env": {k: v for k, v in os.environ.items()
                   if k.startswith("BENCH_")}}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out} ({len(results)} ok, {len(failed)} failed)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
