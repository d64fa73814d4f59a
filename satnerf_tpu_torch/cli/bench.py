"""Throughput of the port on one card: the counterpart of the JAX package's
root bench.py.

  python -m satnerf_tpu_torch.cli.bench

Configured as bench.py, by the environment: BENCH_BATCH (rays a step or a
render), BENCH_STEPS, BENCH_MODEL, BENCH_PRECISION, BENCH_FUSED, BENCH_MODE
(train | render | image), BENCH_SC (sc_lambda), BENCH_NIMP (n_importance)
and BENCH_CHUNK (0: Config.chunk); and BENCH_DEVICE, cuda (the default) or
cpu. With cuda and no card visible it raises: it never falls back to the
CPU.

Every model is 8 x 512 with 64 samples a ray and max_train_steps 300,000;
the initial weights are seed 0's; the inputs are bench.py's, 2^20 random
rays from RandomState(0) (d normalised, near 0, far 1), colours and image
ids in [0, 30), held on the device as the training dataset. A mode is one
call of the port, timed:

- train: NeRFSystem.train_step(state, data, key), the step drawing its rays
  and depths from the run's key (PRNGKey(1), the JAX package's draws);
- render: NeRFSystem.render_chunk on the first BATCH rays, on the device,
  under torch.inference_mode() (the JAX system's make_eval_render);
- image: NeRFSystem.render_image of the first BATCH rays from the host, the
  products back on the host (the eval and DSM surface).

BATCH is at most the 2^20 rays made. After a warm-up (4 steps, as bench.py;
one render), three runs of BENCH_STEPS calls are timed between CUDA events
(`event_ms`, ms a call, all three); `value` is the batch over their median.
Then BENCH_STEPS more calls run under torch.profiler, between CUDA events
of their own (`profiled_ms` a call): `device_ms` is their kernels' summed
device time a call (utils/device_time.py, the sum
tools/profile_render_torch.py reads) and `idle` 1 - device_ms / profiled_ms,
the share of that run the card ran no kernel. Both come from one run: a
device-bound call's idle is under 1 %, less than its time moves between two
runs, so against another run's time it could read below 0. The profiler
adds host work to each launch, so a host-bound call's profiled_ms is above
its event_ms. `launches` counts the kernels launched over the timed and
profiled calls (satnerf_tpu_torch.ops.launch_counts). On the CPU the host's
clock times the calls, and device_ms, profiled_ms, idle, peak_gib and card
are null.

Prints ONE JSON line on stdout, bench.py's keys first (the metric
`train_rays_per_sec_per_chip`, `render_...` or `image_...`; `vs_baseline`
null: BASELINE.json's figure is not this card's; `flops_per_ray` in MFLOP,
utils/flops.py; `mfu` against the H100's peak for the precision), then
event_ms, device_ms, profiled_ms, idle, peak_gib, batch, steps, cards
(1), card (the name and power limit nvidia-smi gives), model, mode, fused
(the resolved path), precision and launches. Anything else the port prints
goes to stderr. tools/bench_matrix_torch.py runs it over the rows of the JAX
package's matrix.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# bench.py's configuration (:82-84) and inputs (:91-98)
LAYERS, FEAT, SAMPLES = 8, 512, 64
N_RAYS = 1 << 20
# BENCH_BATCH's defaults. Train: the largest power of two of rays at which
# train_default's step runs on an NVIDIA H100 80GB HBM3 (bench.py's 65,536
# does not fit: the step keeps about 3 GiB a 1,024 rays). Render and image:
# bench.py's.
TRAIN_BATCH = 16384
SERVE_BATCH = 65536
STEPS = 20  # BENCH_STEPS' default
CHUNK = 0  # BENCH_CHUNK's default: Config.chunk
WARMUP_STEPS = 4
RUNS = 3


@dataclasses.dataclass
class Knobs:
    batch: int
    steps: int
    model: str
    precision: str
    fused: str
    mode: str
    sc: float
    nimp: int
    chunk: int
    device: str


def knobs() -> Knobs:
    """The BENCH_* variables of the environment, with their defaults."""
    env = os.environ
    mode = env.get("BENCH_MODE", "train")
    if mode not in ("train", "render", "image"):
        raise ValueError(f"BENCH_MODE {mode!r}: train, render or image")
    default_batch = TRAIN_BATCH if mode == "train" else SERVE_BATCH
    return Knobs(batch=int(env.get("BENCH_BATCH", default_batch)),
                 steps=int(env.get("BENCH_STEPS", STEPS)),
                 model=env.get("BENCH_MODEL", "sat-nerf"),
                 precision=env.get("BENCH_PRECISION", "bfloat16"),
                 fused=env.get("BENCH_FUSED", "auto"), mode=mode,
                 sc=float(env.get("BENCH_SC", 0.0)),
                 nimp=int(env.get("BENCH_NIMP", 0)),
                 chunk=int(env.get("BENCH_CHUNK", CHUNK)),
                 device=env.get("BENCH_DEVICE", "cuda"))


def inputs(n: int):
    """bench.py's rays (n, 11), colours (n, 3) and image ids (n,)."""
    rng = np.random.RandomState(0)
    rays = rng.rand(n, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    rgbs = rng.rand(n, 3).astype(np.float32)
    ts = rng.randint(0, 30, n).astype(np.int64)
    return rays, rgbs, ts


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def _runs_ms(call, steps: int, cuda: bool) -> list:
    """RUNS timings of `steps` calls, ms a call: between CUDA events on the
    card, by the host's clock on the CPU."""
    out = []
    for _ in range(RUNS):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(steps):
                call()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / steps)
        else:
            t0 = time.perf_counter()
            for _ in range(steps):
                call()
            out.append(1e3 * (time.perf_counter() - t0) / steps)
    return out


def _profiled(call, steps: int) -> tuple:
    """(device ms, event ms) a call over `steps` calls under torch.profiler:
    the kernels' summed device time, and the run's time between CUDA
    events."""
    from torch.profiler import ProfilerActivity, profile

    from satnerf_tpu_torch.utils import device_time as DT

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(steps):
            call()
        end.record()
        torch.cuda.synchronize()
    return DT.device_ms(prof) / steps, start.elapsed_time(end) / steps


def measure(k: Knobs) -> dict:
    """Build the configuration of `k`, time its calls and return the line."""
    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.ops import launch_counts, reset_launch_counts
    from satnerf_tpu_torch.train.system import NeRFSystem
    from satnerf_tpu_torch.utils import jax_prng
    from satnerf_tpu_torch.utils.flops import (H100_PEAK_BF16, H100_PEAK_F32,
                                               flops_per_ray)

    device = torch.device(k.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("BENCH_DEVICE is cuda but no CUDA device is visible "
                           "(BENCH_DEVICE=cpu runs on the CPU)")
    batch = min(k.batch, N_RAYS)
    cfg = Config(model=k.model, fc_units=FEAT, fc_layers=LAYERS,
                 n_samples=SAMPLES, batch_size=batch, sc_lambda=k.sc,
                 n_importance=k.nimp, max_train_steps=300000,
                 precision=k.precision, fused=k.fused, device=k.device,
                 **({"chunk": k.chunk} if k.chunk else {}))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    system = NeRFSystem(cfg, dataset_len=max(batch * 64, N_RAYS))
    rays, rgbs, ts = inputs(N_RAYS)

    if k.mode == "train":
        state = system.init_state(0)
        data = {"rays": torch.from_numpy(rays).to(device),
                "rgbs": torch.from_numpy(rgbs).to(device),
                "ts": torch.from_numpy(ts).to(device)}
        key = jax_prng.prng_key(1)
        call = lambda: system.train_step(state, data, key)  # noqa: E731
        warmup = WARMUP_STEPS
    elif k.mode == "render":
        params = system.init_params(0)
        r = torch.from_numpy(rays[:batch]).to(device)
        t = torch.from_numpy(ts[:batch]).to(device)

        def call():
            with torch.inference_mode():
                return system.render_chunk(params, r, t)
        warmup = 1
    else:
        params = system.init_params(0)
        r, t = rays[:batch], ts[:batch]
        call = lambda: system.render_image(params, r, t)  # noqa: E731
        warmup = 1
    for _ in range(warmup):
        call()
    if cuda:
        torch.cuda.synchronize()
    reset_launch_counts()
    event_ms = _runs_ms(call, k.steps, cuda)
    dev_ms, prof_ms = _profiled(call, k.steps) if cuda else (None, None)
    counts = {name: n for name, n in launch_counts().items() if n}

    median = float(np.median(event_ms))
    value = batch / (median / 1e3)
    fpr = flops_per_ray(k.model, LAYERS, FEAT, SAMPLES,
                        mode="train" if k.mode == "train" else "render",
                        sc=k.sc > 0 and k.mode == "train", n_importance=k.nimp)
    peak = H100_PEAK_BF16 if k.precision == "bfloat16" else H100_PEAK_F32
    return {
        "metric": f"{k.mode}_rays_per_sec_per_chip",
        "value": value,
        "unit": "rays/s",
        "vs_baseline": None,
        "flops_per_ray": fpr / 1e6,
        "mfu": value * fpr / peak,
        "event_ms": event_ms,
        "device_ms": dev_ms,
        "profiled_ms": prof_ms,
        "idle": None if dev_ms is None else 1 - dev_ms / prof_ms,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if cuda else None),
        "batch": batch,
        "steps": k.steps,
        "cards": 1,
        "card": card_name() if cuda else None,
        "model": k.model,
        "mode": k.mode,
        "fused": system.fused_mode,
        "precision": k.precision,
        "launches": counts,
    }


def main(argv=None) -> dict:
    """Measure the configuration the environment asks for and print its
    line (argv: none is taken)."""
    if argv:
        raise SystemExit(f"bench takes no arguments (BENCH_* variables): {argv}")
    k = knobs()
    with contextlib.redirect_stdout(sys.stderr):
        line = measure(k)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
