#!/usr/bin/env python3
"""Where the time goes on the GPU: the PyTorch port's render_image, or with
--train its train_step, under torch.profiler.

Serving: renders N rays (default 262,144, a 512 x 512 view, made like
bench.py) with a seeded sat-nerf 8 x 512 field at 64 samples, bf16, chunk
65,536: one warm up, three timed calls (rays/s), then one profiled call.

Training (--train): the same field, a device-resident dataset of N random
rays, batch 1024: 20 warm-up steps, three timed runs of 50 steps (steps/s,
rays/s), then 10 profiled steps. --sc_lambda and --ds_lambda turn on the
solar-correction pass and the depth-supervision pass (a depth set of 4,096
of the rays with random targets; the depth term stays active throughout),
the full recipe's step. --n_importance N adds the fine model (N resampled
depths a ray: the two-launch dispatch in serving and training, the depth
pass through the ray-mode field kernel) and prints the time of the
resampling alone (sample_pdf, the sort and the merge) at the shape of the
run; --fused on | off | rays picks the path as `cli.train --fused` does.
--model nerf profiles the classic NeRF variant at 8 x 256: its per-ray kernels in serving and in the plain step, the
plain renderer over its per-point field kernel with --n_importance or
--ds_lambda.

Prints the card, the wall time, the summed device kernel time, the idle
share, the peak device memory, and the kernels by device time.

--ablate times siren_dense's wgmma kernel (csrc/fused_render.cu) with each
of its parts dropped in turn (built with SATNERF_ABLATE 1-3: no products, no
epilogue, no sine) beside itself and the library call sin(addmm), at the
serving skip layer (4.19 M points) and at a training batch with the saved
slope (65,536 points): what holds the kernel back, where no hardware
profiler runs.

--wgrad times siren_dense_wgrad at the main path's shapes (65,536 points,
512 x 512 with and without the slope, 512 x 256, 256 x 256) on its wmma
mainloop (GEMM + small_grads summing db) and on its wgmma mainloop (db in the
epilogue) at the rule's split of the points (ops/fused_mlp.py wgrad_split)
and at other splits, in turns, beside the library call X^T @ round(G), the
bytes bound, and small_grads alone summing db (a layer with a bias alone)
beside torch.einsum("pn,pn->n", dY, slope).

In the breakdown, the wgrad's kernels are wgrad_wgmma (the main path's),
wgrad_wmma / wgrad_simt (other shapes, fp32) and small_grads (db where the
GEMM did not sum it, dC and dE of the layers with an E operand).

  python3 tools/profile_render_torch.py [--rays N] [--chunk C] [--train]
      [--batch B] [--sc_lambda L] [--ds_lambda L] [--n_importance N]
      [--fused auto|rays|on|off] [--model sat-nerf|s-nerf|nerf] [--ablate]
      [--wgrad]
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


def report(prof, wall_ms: float, card: str, what: str) -> None:
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", 0)
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{what}: profiled wall {wall_ms:.1f} ms, device kernel time "
          f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f} on {card}")
    for ms, count, key in rows[:22]:
        print(f"{ms:10.2f} ms {count:5d}x  {key[:110]}")


def time_resampling(system, n_rays: int, det: bool, card: str) -> None:
    """The resampling of one pass alone: sample_pdf over (n_rays, S - 2)
    weights, the sort and the merge into (n_rays, S + n_importance)."""
    from satnerf_tpu_torch.render.render import resample_zvals

    cfg, dev = system.cfg, system.device
    gen = torch.Generator(device=dev).manual_seed(2)
    z = torch.sort(torch.rand((n_rays, cfg.n_samples), generator=gen,
                              device=dev), 1)[0]
    w = torch.rand((n_rays, cfg.n_samples), generator=gen, device=dev) ** 3
    run = lambda: resample_zvals(gen, z, w, cfg.n_importance, det=det)  # noqa: E731
    for _ in range(3):
        run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        run()
    end.record()
    torch.cuda.synchronize()
    print(f"resampling alone (sample_pdf + sort + merge, {n_rays} rays, "
          f"{cfg.n_samples} + {cfg.n_importance} samples, det={det}): "
          f"{start.elapsed_time(end) / 20:.3f} ms on {card}")


def peak_memory(what: str, card: str) -> None:
    print(f"{what}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {card}")


def profile_train(system, rays, ts, batch: int, card: str) -> None:
    rng = np.random.RandomState(1)
    dev = system.device
    data = {"rays": torch.from_numpy(rays).to(dev),
            "rgbs": torch.from_numpy(rng.rand(rays.shape[0], 3)
                                     .astype(np.float32)).to(dev),
            "ts": torch.from_numpy(ts.astype(np.int64)).to(dev)}
    if system.depth:
        data.update(d_rays=data["rays"][:4096].clone(),
                    d_depths=torch.from_numpy(
                        rng.rand(4096, 2).astype(np.float32)).to(dev),
                    d_ts=data["ts"][:4096].clone())
    state = system.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(20):
        system.train_step(state, data, gen)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            system.train_step(state, data, gen)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 50
        print(f"{1 / dt:.2f} steps/s, {batch / dt:.1f} rays/s, "
              f"{1e3 * dt:.2f} ms a step (batch {batch}) on {card}")
    peak_memory("train_step", card)
    if system.cfg.n_importance > 0:
        time_resampling(system, batch, False, card)
    steps = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            system.train_step(state, data, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report(prof, wall_ms, card, f"{steps} train steps")


ABLATE = {0: "the kernel as built", 1: "no products (the epilogue alone)",
          2: "no epilogue (products, loads, barriers)",
          3: "no sine (the rest of the epilogue stays)"}


def _event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ablate(card: str) -> None:
    """siren_dense's wgmma kernel with each part dropped, in turns."""
    import ctypes

    from satnerf_tpu_torch.ops import _build as B
    from satnerf_tpu_torch.ops import fused_mlp as FM

    out_dir = os.path.join(B.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(B.CSRC_DIR, "fused_render.cu")
    jobs = {}
    for k in ABLATE:
        lib = os.path.join(out_dir, f"fused_render_ablate{k}.so")
        cmd = [B._nvcc(), *B.NVCC_FLAGS, f"-DSATNERF_ABLATE={k}", "-shared",
               "-o", lib, src]
        jobs[k] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    fns = {}
    for k, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for SATNERF_ABLATE={k}:\n{out}")
        fn = ctypes.CDLL(lib).satnerf_siren_dense
        fn.argtypes = B.SIGNATURES["satnerf_siren_dense"]
        fn.restype = ctypes.c_int
        fns[k] = fn
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    mode, col = FM._EXTRA["xyz"]
    for n_rays, save in ((1 << 16, False), (1024, True)):
        p, feat, n_s = n_rays * 64, 512, 64
        rays16 = torch.rand(n_rays, 16, device=dev, generator=g) - 0.5
        z = torch.sort(torch.rand(n_rays, n_s, device=dev, generator=g), 1).values
        x = (torch.rand(p, feat, device=dev, generator=g) * 2 - 1).to(bf16)
        w = (torch.randn(feat, feat, device=dev, generator=g) / feat ** 0.5).to(bf16)
        b = torch.randn(feat, device=dev, generator=g)
        c = (torch.randn(3, feat, device=dev, generator=g) * 0.3).to(bf16)
        y = torch.empty(p, feat, device=dev, dtype=bf16)
        slope = torch.empty(p, feat, device=dev) if save else None
        args = (1, x.data_ptr(), feat, w.data_ptr(), b.data_ptr(),
                rays16.data_ptr(), z.data_ptr(), n_s, mode, col, 3, c.data_ptr(),
                1.0, FM._ACT["sin"], y.data_ptr(),
                None if slope is None else slope.data_ptr(), p, feat,
                FM._MAINLOOP_CODE["wgmma"], torch.cuda.current_stream().cuda_stream)
        ms = {k: [] for k in ABLATE}
        for k in list(ABLATE) + list(reversed(ABLATE)):
            if fns[k](*args) != 0:
                sys.exit(f"launch failed for SATNERF_ABLATE={k}")
            ms[k].append(_event_ms(lambda: fns[k](*args)))
        lib_ms = _event_ms(lambda: torch.sin(torch.addmm(b.to(bf16), x, w)))
        print(f"siren_dense wgmma, 512 x 512 skip layer, {p} points, slope "
              f"{save}, on {card}: library sin(addmm) {lib_ms:.3f} ms")
        for k, what in ABLATE.items():
            print(f"  {what:45s} {ms[k][0]:.3f} / {ms[k][1]:.3f} ms")


def wgrad(card: str) -> None:
    """siren_dense_wgrad at the main path's shapes on both mainloops and
    at several splits of the points, in turns (a, b, ..., ..., b, a)."""
    from satnerf_tpu_torch.ops import fused_mlp as FM

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    n_rays, n_s = 1024, 64
    p = n_rays * n_s
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rays16 = torch.rand(n_rays, 16, device=dev, generator=g) - 0.5
    for k, n, with_slope in ((512, 512, True), (512, 512, False),
                             (512, 256, True), (256, 256, True)):
        x = (torch.rand(p, k, device=dev, generator=g) * 2 - 1).to(bf16)
        dy = torch.randn(p, n, device=dev, generator=g)
        slope = torch.randn(p, n, device=dev, generator=g) if with_slope else None
        gb = (dy if slope is None else dy * slope).to(bf16)
        args = (x, dy, slope, rays16, n_s)
        rule = FM.wgrad_split(p, k, n, sms)
        runs = {"wmma": lambda: FM.siren_dense_wgrad(*args, mainloop="wmma")}
        for split in sorted({rule, 1024, 2048, 4096, 8192, 16384}):
            runs[f"wgmma split {split}" + (" (rule)" if split == rule else "")] = (
                lambda s=split: FM.siren_dense_wgrad(*args, mainloop="wgmma",
                                                     split=s))
        ms = {key: [] for key in runs}
        for key in list(runs) + list(reversed(runs)):
            ms[key].append(_event_ms(runs[key]))
        lib_ms = _event_ms(lambda: x.t() @ gb)
        nbytes = x.numel() * 2 + dy.numel() * 4 * (2 if with_slope else 1) + (k + 1) * n * 4
        print(f"siren_dense_wgrad {k} x {n}, {p} points, slope {with_slope}, on "
              f"{card}: library X^T @ G {lib_ms:.3f} ms, bound "
              f"{1e3 * nbytes / 3.35e12:.3f} ms (bytes)")
        for key, v in ms.items():
            print(f"  {key:32s} {v[0]:.3f} / {v[1]:.3f} ms")
        if k == 512 and n == 512 and with_slope:  # small_grads alone, db only
            db_ms = [_event_ms(lambda: FM.siren_dense_wgrad(None, dy, slope,
                                                            rays16, n_s))
                     for _ in range(2)]
            ein = _event_ms(lambda: torch.einsum("pn,pn->n", dy, slope))
            print(f"small_grads alone (db of a {n}-column layer, {p} points): "
                  f"{db_ms[0]:.3f} / {db_ms[1]:.3f} ms, einsum {ein:.3f} ms, "
                  f"bound {1e3 * (2 * dy.numel() * 4 + n * 4) / 3.35e12:.3f} ms "
                  f"on {card}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rays", type=int, default=1 << 18)
    ap.add_argument("--chunk", type=int, default=1 << 16)
    ap.add_argument("--train", action="store_true",
                    help="profile train_step in place of render_image")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--sc_lambda", type=float, default=0.0)
    ap.add_argument("--ds_lambda", type=float, default=0.0)
    ap.add_argument("--n_importance", type=int, default=0)
    ap.add_argument("--fused", default="auto",
                    choices=["auto", "rays", "on", "off"])
    ap.add_argument("--model", default="sat-nerf",
                    choices=["sat-nerf", "s-nerf", "nerf"])
    ap.add_argument("--ablate", action="store_true",
                    help="time siren_dense's wgmma kernel with each part "
                         "dropped in turn")
    ap.add_argument("--wgrad", action="store_true",
                    help="time siren_dense_wgrad's mainloops and splits")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_render_torch: needs an NVIDIA GPU")
    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.train.system import NeRFSystem

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.ablate:
        ablate(card)
        return
    if args.wgrad:
        wgrad(card)
        return
    units = 256 if args.model == "nerf" else 512  # the widths run_all.sh trains
    cfg = Config(model=args.model, fc_layers=8, fc_units=units, n_samples=64,
                 chunk=args.chunk, batch_size=args.batch, first_beta_epoch=0,
                 sc_lambda=args.sc_lambda, ds_lambda=args.ds_lambda, ds_drop=1.0,
                 n_importance=args.n_importance, fused=args.fused)
    system = NeRFSystem(cfg, dataset_len=args.rays)
    params = system.init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    n = args.rays
    rays = rng.rand(n, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 8:11] /= np.linalg.norm(rays[:, 8:11], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    ts = rng.randint(0, 30, n).astype(np.int32)
    if args.train:
        profile_train(system, rays, ts, args.batch, card)
        return

    system.render_image(params, rays, ts)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.render_image(params, rays, ts)
        torch.cuda.synchronize()
        print(f"{n / (time.perf_counter() - t0):.1f} rays/s on {card}")
    peak_memory("render_image", card)
    if args.n_importance > 0:
        time_resampling(system, min(n, args.chunk), True, card)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.render_image(params, rays, ts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report(prof, wall_ms, card, "render_image")


if __name__ == "__main__":
    main()
