#!/usr/bin/env python3
"""Where the serving time goes on the GPU: the PyTorch port's render_image
under torch.profiler.

Renders N rays (default 262,144, a 512 x 512 view, made like bench.py) with
a seeded sat-nerf 8 x 512 field at 64 samples, bf16, chunk 65,536: one warm
up, three timed calls (rays/s), then one profiled call. Prints the card, the
wall time, the summed device kernel time, the idle share, and the kernels by
device time.

  python3 tools/profile_render_torch.py [--rays N] [--chunk C]
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rays", type=int, default=1 << 18)
    ap.add_argument("--chunk", type=int, default=1 << 16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_render_torch: needs an NVIDIA GPU")
    from satnerf_tpu.config import Config
    from satnerf_tpu_torch.train.system import NeRFSystem

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = Config(model="sat-nerf", fc_layers=8, fc_units=512, n_samples=64,
                 chunk=args.chunk)
    system = NeRFSystem(cfg, "cuda")
    params = system.init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    n = args.rays
    rays = rng.rand(n, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    ts = rng.randint(0, 30, n).astype(np.int32)

    system.render_image(params, rays, ts)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.render_image(params, rays, ts)
        torch.cuda.synchronize()
        print(f"{n / (time.perf_counter() - t0):.1f} rays/s on {card}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.render_image(params, rays, ts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", 0)
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profiled wall {wall_ms:.1f} ms, device kernel time {busy:.1f} ms, "
          f"idle share {1 - busy / wall_ms:.3f} on {card}")
    for ms, count, key in rows[:15]:
        print(f"{ms:10.2f} ms {count:5d}x  {key[:110]}")


if __name__ == "__main__":
    main()
