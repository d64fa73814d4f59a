#!/usr/bin/env python3
"""Where the time goes on the GPU: the PyTorch port's render_image, or with
--train its train_step, under torch.profiler.

Serving: renders N rays (default 262,144, a 512 x 512 view, made like
bench.py) with a seeded sat-nerf 8 x 512 field at 64 samples, bf16, chunk
65,536: one warm up, three timed calls (rays/s), then one profiled call.

Training (--train): the same field, a device-resident dataset of N random
rays, batch 1024: 20 warm-up steps, three timed runs of 50 steps (steps/s,
rays/s); on the main path (no depth pass, fine model or sigma noise) five
runs of 50 steps drawing their batch and depths in turns with five given
them (what the draws cost a step), and the host time inside the step's
draw calls beside torch's own draws of the same shapes; then 10 profiled
steps. --sc_lambda and --ds_lambda turn on the
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
share, the peak device memory, the draw kernel's device time and launches
(csrc/jax_draws.cu, the training draws), and the kernels by device time (user
annotations such as the optimizer's step are left out: their device time is
a span on the timeline, gaps included).

--ablate times siren_dense's wgmma kernel (csrc/fused_render.cu) with each
of its parts dropped in turn (built with SATNERF_ABLATE 1-3: no products, no
epilogue, no sine) beside itself and the library call sin(addmm), at the
serving skip layer (4.19 M points) and at a training batch with the saved
slope (65,536 points): what holds the kernel back, where no hardware
profiler runs.

--wgrad times siren_dense_wgrad at the main path's shapes (65,536 points,
512 x 512 with and without the slope, 512 x 256, 256 x 256) on its wmma
mainloop (GEMM + narrow_grads summing db) and on its wgmma mainloop (db in the
epilogue) at the rule's split of the points (ops/fused_mlp.py wgrad_split)
and at other splits, in turns, beside the library call X^T @ round(G), the
bytes bound, and narrow_grads alone summing db (a layer with a bias alone)
beside torch.einsum("pn,pn->n", dY, slope).

--model nerf --ablate times nerf_dense's wgmma kernel (csrc/fused_nerf.cu)
built with SATNERF_NERF_ABLATE 1 (the products, loads and epilogue alone:
no sines) and 2 (the encoding alone: the positions' loads and the sines, no
X, no products, no stores), beside itself, its wmma mainloop and the library call relu(addmm), at the skip layer (256 x 256
with the 64-row encoding) at a serving chunk (4.19 M points) and a training
batch (65,536 points), and layer 0 (the encoding alone, K = 0): whether the
sines or the mainloop hold it back.

--composite times composite_loss_bwd and composite_bwd at a training batch
(1,024 rays x 64 and x 128 samples, 8 x 512, bf16) on both bodies, a block
a ray (the default) and the warp a ray that it replaced, the block body's
parts alone (builds of csrc/fused_train.cu with SATNERF_CLB_ABLATE 1-3: no
outer products, no loads of the heads, neither), in turns (CUDA
events, then device time), beside the bytes bound; then profiles the
training step as --train does.

--model nerf --wgrad times the nerf variant's nerf_dense_dgrad and
nerf_dense_wgrad alone at the 8 x 256 chain's shapes (65,536 points: the
dgrad of rgb_0, feats and a trunk layer; the wgrad of the skip layer, a
trunk layer, rgb_0 and layer 0) on the wmma mainloop (the wgrad: its GEMMs
and nerf_bias_grad) and on wgmma, the wgrad at the rule's split and at
others, in turns (CUDA events; then each run's device time alone, by
torch.profiler, without the gaps the host leaves between short launches),
beside the library calls (G @ W^T; X^T @ G and [X | enc]^T @ G) and the
bytes bound; the dgrad's wgmma ring at 3 and 5
stages beside the rule's 4 (builds of csrc/fused_nerf.cu with
SATNERF_RELU_DG_STAGES); then profiles the nerf step as --train --model nerf
does.

--heads times sc_loss_bwd at 1,024 rays x 64 and x 128 samples and 256 x
640 (8 x 512, bf16) beside builds of csrc/fused_aux.cu with its parts
dropped (SATNERF_SC_ABLATE 1-3: no d_s2 / dWn pass, no loads of h and s2,
neither) and with other samples a warp in flight and blocks an SM
(SATNERF_SC_IN_FLIGHT, SATNERF_SC_MIN_BLOCKS), in turns (CUDA events, then
device time); field_heads and field_heads_bwd at 1,024 x 128 and on
131,072 points that are their own rays; and heads_composite at a serving
chunk (65,536 x 64 with weights) and at the depth pass's batch (1,024 x 64
with noise); each beside its bytes bound; then profiles the training step
as --train does (with --sc_lambda, --ds_lambda and --n_importance, the
steps that run them).

In the breakdown, the wgrad's kernels are wgrad_wgmma (the main path's),
wgrad_wmma / wgrad_simt (other shapes, fp32) and narrow_grads (db where
the GEMM did not sum it, dC of the layers without X, dE); the nerf
variant's are dgrad_wgmma<1> and wgrad_wgmma<1, ...> (the relu mask), or
nerf_dgrad_wmma, nerf_wgrad_wmma and nerf_bias_grad.

  python3 tools/profile_render_torch.py [--rays N] [--chunk C] [--train]
      [--batch B] [--sc_lambda L] [--ds_lambda L] [--n_importance N]
      [--fused auto|rays|on|off] [--model sat-nerf|s-nerf|nerf] [--ablate]
      [--wgrad] [--composite] [--heads]

With --model nerf the serving profile also sums nerf_dense's device time by
mainloop.
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

from satnerf_tpu_torch.utils import device_time as DT  # noqa: E402
from satnerf_tpu_torch.utils import jax_prng  # noqa: E402


def report(prof, wall_ms: float, card: str, what: str, calls: int = 1) -> None:
    """The profile's kernels by device time (utils/device_time.py: the sum
    the bench reads too), their sum a call over `calls` calls, and the idle
    share of the profiled wall time."""
    rows = DT.kernel_rows(prof)
    busy = DT.device_ms(prof)
    print(f"{what}: profiled wall {wall_ms:.1f} ms, device kernel time "
          f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f} on {card}")
    print(f"{what}: {busy / calls:.4f} device-ms a call over {calls} on {card}")
    for ms, count, key in rows[:22]:
        print(f"{ms:10.2f} ms {count:5d}x  {key[:110]}")
    draws = [r for r in rows if "jax_draws" in r[2]]
    if draws:  # the training draws' kernel (csrc/jax_draws.cu), every mode
        print(f"{what}: jax_draws {sum(r[0] for r in draws):.4f} ms over "
              f"{sum(r[1] for r in draws)} launches on {card}")


def time_resampling(system, n_rays: int, det: bool, card: str) -> None:
    """The resampling of one pass alone: sample_pdf over (n_rays, S - 2)
    weights, the sort and the merge into (n_rays, S + n_importance)."""
    from satnerf_tpu_torch.render.render import resample_zvals

    cfg, dev = system.cfg, system.device
    gen = torch.Generator(device=dev).manual_seed(2)
    z = torch.sort(torch.rand((n_rays, cfg.n_samples), generator=gen,
                              device=dev), 1)[0]
    w = torch.rand((n_rays, cfg.n_samples), generator=gen, device=dev) ** 3
    key = jax_prng.prng_key(2)
    run = lambda: resample_zvals(key, z, w, cfg.n_importance, det=det)  # noqa: E731
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


def time_draws(system, state, data, key, batch: int, card: str,
               runs: int = 5, steps: int = 50) -> None:
    """The main-path step drawing its batch and depths from the key, and
    the same step given them (made once, injected), in turns: the
    difference is what the draws cost a step, host and device."""
    from satnerf_tpu_torch.render.sampling import stratified_zvals

    dev = system.device
    idx = torch.randint(0, data["rays"].shape[0], (batch,), device=dev)
    rays = data["rays"][idx]
    z = stratified_zvals(None, rays[:, 6:7], rays[:, 7:8],
                         system.cfg.n_samples, perturb=0.0)

    def ms_a_step(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps

    drawn, given = [], []
    for _ in range(runs):
        drawn.append(ms_a_step(lambda: system.train_step(state, data, key)))
        given.append(ms_a_step(lambda: system.train_step(
            state, data, None, idx=idx, z_vals=z)))
    print(f"the step drawing its batch and depths "
          f"{' '.join(f'{t:.3f}' for t in drawn)} ms, given them "
          f"{' '.join(f'{t:.3f}' for t in given)} ms ({runs} runs of {steps} "
          f"steps in turns): the draws {np.median(drawn) - np.median(given):.3f} "
          f"ms a step by the medians on {card}")

    # the host's share: the time spent inside the step's draw calls (its
    # keys, jax_prng.step_keys and split_at; its launches, JD.randint and
    # JD.uniform), against torch's own draws of the same shapes
    from satnerf_tpu_torch.ops import jax_draws as JD

    inside = [0.0]

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                inside[0] += time.perf_counter() - t0
        return call

    patched = [(jax_prng, "step_keys"), (jax_prng, "split_at"),
               (JD, "randint"), (JD, "uniform")]
    saved = [getattr(m, n) for m, n in patched]
    try:
        for m, n in patched:
            setattr(m, n, timed(getattr(m, n)))
        ms_a_step(lambda: system.train_step(state, data, key))
    finally:
        for (m, n), fn in zip(patched, saved):
            setattr(m, n, fn)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        torch.randint(0, data["rays"].shape[0], (batch,), generator=gen,
                      device=dev)
        torch.rand(z.shape, generator=gen, device=dev)
    torch_ms = 1e3 * (time.perf_counter() - t0) / steps
    print(f"the step's draw calls on the host {1e3 * inside[0] / steps:.4f} "
          f"ms a step (keys and two launches), torch.randint and torch.rand "
          f"of the same shapes {torch_ms:.4f} ms on {card}")


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
    state = system.init_state(0)
    key = jax_prng.prng_key(1)  # the run's key: JAX's draws (ops/jax_draws.py)
    for _ in range(20):
        system.train_step(state, data, key)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            system.train_step(state, data, key)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 50
        print(f"{1 / dt:.2f} steps/s, {batch / dt:.1f} rays/s, "
              f"{1e3 * dt:.2f} ms a step (batch {batch}) on {card}")
    if not (system.depth or system.cfg.n_importance or system.cfg.noise_std):
        time_draws(system, state, data, key, batch, card)
    peak_memory("train_step", card)
    if system.cfg.n_importance > 0:
        time_resampling(system, batch, False, card)
    steps = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            system.train_step(state, data, key)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report(prof, wall_ms, card, f"{steps} train steps", calls=steps)


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


def _device_ms(fn, reps: int = 5) -> float:
    """The device time of fn's kernels a call, by torch.profiler: what the
    card spends, where _event_ms also counts the gaps the host leaves
    between short launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return DT.device_ms(prof) / reps


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


NERF_ABLATE = {"SATNERF_NERF_ABLATE=0": "the kernel as built",
               "SATNERF_NERF_ABLATE=1": "no sines (products, loads, epilogue)",
               "SATNERF_NERF_ABLATE=2": "the encoding's sines alone"}


def nerf_ablate(card: str) -> None:
    """nerf_dense's wgmma kernel with its parts dropped, in turns."""
    import ctypes

    from satnerf_tpu_torch.ops import _build as B
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.ops import fused_nerf as FN

    out_dir = os.path.join(B.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for k in NERF_ABLATE:
        lib = os.path.join(out_dir, f"fused_nerf_{k.replace('=', '')}.so")
        cmd = [B._nvcc(), *B.NVCC_FLAGS, f"-D{k}", "-shared",
               "-o", lib, os.path.join(B.CSRC_DIR, "fused_nerf.cu")]
        jobs[k] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    fns = {}
    for k, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {k}:\n{out}")
        fn = ctypes.CDLL(lib).satnerf_nerf_dense
        fn.argtypes = B.SIGNATURES["satnerf_nerf_dense"]
        fn.restype = ctypes.c_int
        fns[k] = fn
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    feat, n_s = 256, 64
    for n_rays, k in ((1 << 16, feat), (1024, feat), (1 << 16, 0)):
        p = n_rays * n_s
        o = torch.rand(n_rays, 3, device=dev, generator=g) - 0.5
        d = torch.nn.functional.normalize(torch.randn(n_rays, 3, device=dev, generator=g))
        rays8 = FN.pack_rays(o, d)
        z = torch.sort(torch.rand(n_rays, n_s, device=dev, generator=g), 1).values
        x = torch.rand(p, k, device=dev, generator=g).to(bf16) if k else None
        w = (torch.randn(k, feat, device=dev, generator=g) / feat ** 0.5).to(bf16) if k else None
        b = torch.randn(feat, device=dev, generator=g) * 0.1
        c = torch.randn(64, feat, device=dev, generator=g) * 0.3
        c[60:] = 0
        c = c.to(bf16)
        y = torch.empty(p, feat, device=dev, dtype=bf16)
        args = (1, None if x is None else x.data_ptr(), k,
                None if w is None else w.data_ptr(), b.data_ptr(), rays8.data_ptr(),
                z.data_ptr(), n_s, FN._ENC["xyz"], 10, 64, c.data_ptr(), FN._ACT["relu"],
                y.data_ptr(), p, feat, FM._MAINLOOP_CODE["wgmma"],
                torch.cuda.current_stream().cuda_stream)
        kw = dict(enc="xyz", enc_weight=c, z=z, n_freq=10)
        runs = {f"wgmma, {what}": (lambda fn=fns[a]: fn(*args))
                for a, what in NERF_ABLATE.items()}
        runs["wmma"] = lambda: FN.nerf_dense(x, w, b, rays8, n_s, mainloop="wmma", **kw)
        if x is not None:
            runs["library relu(addmm), no encoding"] = (
                lambda: torch.relu(torch.addmm(b.to(bf16), x, w)))
        if any(fn(*args) != 0 for fn in fns.values()):
            sys.exit("an ablated nerf_dense failed to launch")
        ms = {key: [] for key in runs}
        for key in list(runs) + list(reversed(runs)):
            ms[key].append(_event_ms(runs[key]))
        nbytes = (0 if x is None else x.numel() * 2) + y.numel() * 2
        flops = 2.0 * p * feat * (k + 64)
        print(f"nerf_dense K={k} N={feat} with the 64-row encoding, {p} points, on "
              f"{card}: bound {1e3 * max(nbytes / 3.35e12, flops / 989e12):.3f} ms")
        for key, v in ms.items():
            print(f"  {key:45s} {v[0]:.3f} / {v[1]:.3f} ms")


# builds of csrc/fused_train.cu beside the library: the block body's parts
# alone, and the body with the registers of 1 and 3 blocks an SM (the rule: 2)
CLB_BUILDS = {"SATNERF_CLB_ABLATE=1": "block, no outer products",
              "SATNERF_CLB_ABLATE=2": "block, no heads' loads",
              "SATNERF_CLB_ABLATE=3": "block, neither (arithmetic, scans, barriers)"}


def _clb_builds() -> dict:
    """satnerf_composite_loss_bwd from the CLB_BUILDS of csrc/fused_train.cu,
    built side by side."""
    import ctypes

    from satnerf_tpu_torch.ops import _build as B

    out_dir = os.path.join(B.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for k in CLB_BUILDS:
        lib = os.path.join(out_dir, f"fused_train_{k.replace('=', '')}.so")
        cmd = [B._nvcc(), *B.NVCC_FLAGS, f"-D{k}", "-shared",
               "-o", lib, os.path.join(B.CSRC_DIR, "fused_train.cu")]
        jobs[k] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    fns = {}
    for k, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {k}:\n{out}")
        fn = ctypes.CDLL(lib).satnerf_composite_loss_bwd
        fn.argtypes = B.SIGNATURES["satnerf_composite_loss_bwd"]
        fn.restype = ctypes.c_int
        fns[k] = fn
    return fns


def composite(card: str) -> None:
    """composite_loss_bwd and composite_bwd on both bodies, in turns; the
    block body's parts alone (composite_loss_bwd)."""
    from satnerf_tpu_torch.ops import fused_mlp as FM

    ablated = _clb_builds()

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    n_rays, feat = 1024, 512
    fh = feat // 2
    for n_s in (64, 128):
        p = n_rays * n_s

        def rand(*shape, to=bf16):
            return (torch.rand(*shape, device=dev, generator=g) * 2 - 1).to(to)

        h, r, s2, bh = rand(p, feat), rand(p, fh), rand(p, fh), rand(p, fh)
        skyh = rand(n_rays, fh).abs()
        wn, bn = rand(9, feat) * 0.1, rand(9, to=torch.float32)
        z = torch.sort(torch.rand(n_rays, n_s, device=dev, generator=g), 1).values
        noise = rand(n_rays, n_s, to=torch.float32)
        gt, cot = rand(n_rays, 3, to=torch.float32).abs(), rand(n_rays, 16, to=torch.float32)
        args = (h, r, s2, bh, skyh, wn, bn, z, noise)
        nbytes = sum(t.numel() * t.element_size() for t in (*args, gt)) + (
            p * (feat + 3 * fh) + n_rays * fh + 9 * feat + 9) * 4
        for name, fn in (("composite_loss_bwd", lambda body: FM.composite_loss_bwd(
                *args, gt, 1.0, return_weights=True, body=body)),
                         ("composite_bwd", lambda body: FM.composite_bwd(
                             *args, cot, body=body))):
            print(f"{name} {n_rays} rays x {n_s}, 8 x {feat}, bf16, on {card}: bound "
                  f"{1e3 * nbytes / 3.35e12:.3f} ms (bytes)")
            runs = {body: (lambda b=body: fn(b)) for body in FM.COMPOSITE_BODIES}
            if name == "composite_loss_bwd":  # the wrapper's launch, ablated
                res = FM.composite_loss_bwd(*args, gt, 1.0, return_weights=True)
                ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
                cargs = (1, *(ptr(t) for t in (h,)), feat, ptr(r), ptr(s2), ptr(bh),
                         ptr(skyh), fh, ptr(wn), ptr(bn), ptr(z), ptr(noise), ptr(gt),
                         n_rays, n_s, 0.001, 0.05, 1.0, ptr(res["loss_sums"]),
                         ptr(res["weights"]), ptr(res["d_h"]), ptr(res["d_r"]),
                         ptr(res["d_s2"]), ptr(res["d_bh"]), ptr(res["d_skyh"]),
                         ptr(res["dwn"]), ptr(res["dbn"]), FM._BODY_CODE["block"],
                         torch.cuda.current_stream().cuda_stream)
                for k, what in CLB_BUILDS.items():
                    runs[what] = lambda f=ablated[k]: f(*cargs)
            ms = {key: [] for key in runs}
            for key in list(runs) + list(reversed(runs)):
                ms[key].append(_event_ms(runs[key]))
            for key, v in ms.items():
                print(f"  {key:45s} {v[0]:.3f} / {v[1]:.3f} ms, device "
                      f"{_device_ms(runs[key]):.3f} ms")


# builds of csrc/fused_aux.cu beside the library: sc_loss_bwd's parts alone,
# and other samples in flight a warp in A, blocks an SM and rows in flight
# in C (the library's: 4, 2 and 4)
SC_BUILDS = {"-DSATNERF_SC_ABLATE=1": "no C (d_s2, dWn row 4)",
             "-DSATNERF_SC_ABLATE=2": "no loads in A",
             "-DSATNERF_SC_ABLATE=3": "neither (weights, scan, sums, barriers)",
             "-DSATNERF_SC_IN_FLIGHT=1 -DSATNERF_SC_MIN_BLOCKS=4":
                 "1 sample a warp in flight, 4 blocks an SM",
             "-DSATNERF_SC_IN_FLIGHT=4 -DSATNERF_SC_MIN_BLOCKS=3":
                 "4 samples a warp in flight, 3 blocks an SM",
             "-DSATNERF_SC_IN_FLIGHT=8": "8 samples a warp in flight",
             "-DSATNERF_SC_ROWS=2": "2 rows a warp in flight in C",
             "-DSATNERF_SC_ROWS=8": "8 rows a warp in flight in C"}


def _sc_builds() -> dict:
    """satnerf_sc_loss_bwd from the SC_BUILDS of csrc/fused_aux.cu, built
    side by side."""
    import ctypes

    from satnerf_tpu_torch.ops import _build as B

    out_dir = os.path.join(B.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for i, k in enumerate(SC_BUILDS):
        lib = os.path.join(out_dir, f"fused_aux_{i}.so")
        cmd = [B._nvcc(), *B.NVCC_FLAGS, *k.split(), "-shared", "-o", lib,
               os.path.join(B.CSRC_DIR, "fused_aux.cu")]
        jobs[k] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    fns = {}
    for k, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {k}:\n{out}")
        fn = ctypes.CDLL(lib).satnerf_sc_loss_bwd
        fn.argtypes = B.SIGNATURES["satnerf_sc_loss_bwd"]
        fn.restype = ctypes.c_int
        fns[k] = fn
    return fns


def heads(card: str) -> None:
    """sc_loss_bwd (1,024 rays x 64 and x 128, 256 x 640) beside its
    SC_BUILDS, in turns; field_heads at 1,024 x 128 and on 131,072 points
    that are their own rays; each beside its bytes bound."""
    from satnerf_tpu_torch.ops import fused_mlp as FM

    variants = _sc_builds()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    feat, fh = 512, 256

    def rand(*shape, to=bf16):
        return (torch.rand(*shape, device=dev, generator=g) * 2 - 1).to(to)

    wn, bn = rand(9, feat) * 0.1, rand(9, to=torch.float32)
    for n_rays, n_s in ((1024, 64), (1024, 128), (256, 640)):
        p = n_rays * n_s
        h, s2 = rand(p, feat), rand(p, fh)
        z = torch.sort(torch.rand(n_rays, n_s, device=dev, generator=g), 1).values
        noise = rand(n_rays, n_s, to=torch.float32)
        args = (h, s2, wn, bn, z, noise, 0.1 / 3)
        nbytes = sum(t.numel() * t.element_size() for t in args[:-1]) + (
            p * fh + 9 * feat + 9 + 2) * 4
        print(f"sc_loss_bwd {n_rays} rays x {n_s}, 8 x {feat}, bf16, on {card}: "
              f"bound {1e3 * nbytes / 3.35e12:.3f} ms (bytes)")
        res = FM.sc_loss_bwd(*args)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        cargs = (1, ptr(h), feat, ptr(s2), fh, ptr(wn), ptr(bn), ptr(z), ptr(noise),
                 n_rays, n_s, 0.1 / 3 / n_rays, ptr(res["sums"]), ptr(res["d_s2"]),
                 ptr(res["dwn"]), ptr(res["dbn"]), torch.cuda.current_stream().cuda_stream)
        runs = {"the library's build": lambda: FM.sc_loss_bwd(*args)}
        for k, what in SC_BUILDS.items():
            runs[what] = lambda f=variants[k]: f(*cargs)
        ms = {key: [] for key in runs}
        for key in list(runs) + list(reversed(runs)):
            ms[key].append(_event_ms(runs[key]))
        for key, v in ms.items():
            print(f"  {key:45s} {v[0]:.3f} / {v[1]:.3f} ms, device "
                  f"{_device_ms(runs[key]):.3f} ms")
    for n_rays, n_s in ((1024, 128), (131072, 1)):
        p = n_rays * n_s
        fargs = (rand(p, feat), rand(p, fh), rand(p, fh), rand(p, fh),
                 rand(n_rays, fh).abs(), rand(9, feat) * 0.5, bn, n_s)
        nbytes = sum(t.numel() * t.element_size() for t in fargs[:-1]) + p * 16 * 4
        fn = lambda: FM.field_heads(*fargs)  # noqa: E731
        print(f"field_heads {n_rays} rays x {n_s}, 8 x {feat}, bf16, on {card}: "
              f"{_event_ms(fn):.3f} ms, device {_device_ms(fn):.3f} ms, bound "
              f"{1e3 * nbytes / 3.35e12:.3f} ms (bytes)")
        # the backward: the rows and g read, d_h, d_r, d_s2, d_bh, d_skyh written
        cot = rand(p, 16, to=torch.float32)
        nbytes = (sum(t.numel() * t.element_size() for t in fargs[:-1]) + p * 16 * 4
                  + (p * (feat + 3 * fh) + n_rays * fh + 9 * feat + 9) * 4)
        fn = lambda: FM.field_heads_bwd(*fargs, cot)  # noqa: E731
        print(f"field_heads_bwd {n_rays} rays x {n_s}, 8 x {feat}, bf16, on {card}: "
              f"{_event_ms(fn):.3f} ms, device {_device_ms(fn):.3f} ms, bound "
              f"{1e3 * nbytes / 3.35e12:.3f} ms (bytes)")
    # heads_composite at the serving chunk (weights asked for) and at the
    # depth pass's batch (noise)
    for n_rays, n_s, noise in ((65536, 64, False), (1024, 64, True)):
        p = n_rays * n_s
        hargs = (rand(p, feat), rand(p, fh), rand(p, fh), rand(p, fh),
                 rand(n_rays, fh).abs(), wn, bn,
                 torch.sort(torch.rand(n_rays, n_s, device=dev, generator=g), 1).values)
        nz = rand(n_rays, n_s, to=torch.float32) if noise else None
        nbytes = (sum(t.numel() * t.element_size() for t in hargs + (nz,) if t is not None)
                  + n_rays * 16 * 4 + (0 if noise else p * 4))
        fn = lambda: FM.heads_composite(  # noqa: E731
            *hargs, noise=nz, return_weights=not noise)
        print(f"heads_composite {n_rays} rays x {n_s}, 8 x {feat}, bf16, noise "
              f"{noise}, on {card}: {_event_ms(fn):.3f} ms, device {_device_ms(fn):.3f} "
              f"ms, bound {1e3 * nbytes / 3.35e12:.3f} ms (bytes)")


def by_mainloop(prof, kernel: str, card: str) -> None:
    """A kernel's device time in a profile, summed by mainloop (the kernels'
    names carry it: <kernel>_wgmma, _wmma, _simt), beside its launches."""
    from satnerf_tpu_torch.ops import fused_mlp as FM

    ms = {}
    for t, _, key in DT.kernel_rows(prof, kernel):
        loop = next((m for m in ("wgmma", "wmma", "simt")
                     if f"{kernel}_{m}" in key), "other")
        ms[loop] = ms.get(loop, 0.0) + t
    launches = {m: n for (k, m), n in FM.MAINLOOP_LAUNCHES.items() if k == kernel}
    print(f"{kernel} device time by mainloop {ms} ms, launches {launches} on {card}")


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
        if k == 512 and n == 512 and with_slope:  # narrow_grads alone, db only
            db_ms = [_event_ms(lambda: FM.siren_dense_wgrad(None, dy, slope,
                                                            rays16, n_s))
                     for _ in range(2)]
            ein = _event_ms(lambda: torch.einsum("pn,pn->n", dy, slope))
            print(f"narrow_grads alone (db of a {n}-column layer, {p} points): "
                  f"{db_ms[0]:.3f} / {db_ms[1]:.3f} ms, einsum {ein:.3f} ms, "
                  f"bound {1e3 * (2 * dy.numel() * 4 + n * 4) / 3.35e12:.3f} ms "
                  f"on {card}")


def nerf_wgrad(card: str) -> None:
    """The nerf backward's two kernels at the 8 x 256 chain's shapes on both
    mainloops, the wgrad at several splits, in turns (a, b, ..., ..., b,
    a); the dgrad's wgmma ring at 3, 4 and 5 stages."""
    import ctypes

    from satnerf_tpu_torch.ops import _build as B
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.ops import fused_nerf as FN

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    n_rays, n_s = 1024, 64
    p = n_rays * n_s
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    o = torch.rand(n_rays, 3, device=dev, generator=g) - 0.5
    d = torch.nn.functional.normalize(torch.randn(n_rays, 3, device=dev, generator=g))
    rays8 = FN.pack_rays(o, d)
    z = torch.sort(torch.rand(n_rays, n_s, device=dev, generator=g), 1).values

    def both(fn):
        return f"{_event_ms(fn):.3f} ms (device {_device_ms(fn):.3f})"

    def in_turns(runs):
        """Event times in turns, then each run's device time (kernels only)."""
        ms = {key: [] for key in runs}
        for key in list(runs) + list(reversed(runs)):
            ms[key].append(_event_ms(runs[key]))
        for key, v in ms.items():
            print(f"  {key:40s} {v[0]:.3f} / {v[1]:.3f} ms, device "
                  f"{_device_ms(runs[key]):.3f} ms")

    # the wgmma dgrad with rings of 3 and 5 stages, from builds of its source
    # beside the rule's 4
    jobs = {}
    for stages in (3, 5):
        lib = os.path.join(B.BUILD_DIR, "stages", f"fused_nerf_stages{stages}.so")
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        cmd = [B._nvcc(), *B.NVCC_FLAGS, f"-DSATNERF_RELU_DG_STAGES={stages}", "-shared",
               "-o", lib, os.path.join(B.CSRC_DIR, "fused_nerf.cu")]
        jobs[stages] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    dgrads = {}
    for stages, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for SATNERF_RELU_DG_STAGES={stages}:\n{out}")
        fn = ctypes.CDLL(lib).satnerf_nerf_dense_dgrad
        fn.argtypes = B.SIGNATURES["satnerf_nerf_dense_dgrad"]
        fn.restype = ctypes.c_int
        dgrads[stages] = fn

    for n, k, masked, what in ((128, 256, True, "rgb_0"), (256, 256, True, "trunk"),
                               (256, 256, False, "feats")):
        dy = torch.randn(p, n, device=dev, generator=g)
        y = torch.relu(torch.randn(p, n, device=dev, generator=g)).to(bf16) if masked else None
        w = (torch.randn(k, n, device=dev, generator=g) * 0.1).to(bf16)
        dx = torch.empty(p, k, device=dev)
        gb = (dy if y is None else dy * (y > 0)).to(bf16)
        args = (1, dy.data_ptr(), None if y is None else y.data_ptr(), w.data_ptr(),
                dx.data_ptr(), 0, p, n, k, FM._MAINLOOP_CODE["wgmma"],
                torch.cuda.current_stream().cuda_stream)
        if any(fn(*args) != 0 for fn in dgrads.values()):
            sys.exit("a dgrad of another ring depth failed to launch")
        nbytes = dy.numel() * 4 + (0 if y is None else y.numel() * 2) + w.numel() * 2 + p * k * 4
        print(f"nerf_dense_dgrad {what} {n} -> {k}, {p} points, on {card}: library "
              f"G @ W^T {both(lambda: gb @ w.t())}, bound "
              f"{1e3 * nbytes / 3.35e12:.3f} ms (bytes)")
        in_turns({"wmma": lambda: FN.nerf_dense_dgrad(dy, y, w, mainloop="wmma"),
                  "wgmma, 4 stages (rule)": lambda: FN.nerf_dense_dgrad(dy, y, w),
                  **{f"wgmma, {st} stages": (lambda fn=fn: fn(*args))
                     for st, fn in dgrads.items()}})

    for k, n, enc, what in ((256, 256, "xyz", "skip"), (256, 256, None, "trunk"),
                            (256, 128, "dir", "rgb_0"), (0, 256, "xyz", "layer 0")):
        n_freq = {"xyz": 10, "dir": 4, None: 0}[enc]
        rows = FN._enc_rows(n_freq) if enc else 0
        x = torch.rand(p, k, device=dev, generator=g).to(bf16) if k else None
        dy = torch.randn(p, n, device=dev, generator=g)
        y = torch.relu(torch.randn(p, n, device=dev, generator=g)).to(bf16)
        gb = (dy * (y > 0)).to(bf16)
        args = (x, dy, y, rays8, n_s)
        kw = dict(enc=enc, z=z, n_freq=n_freq, enc_rows=rows, dtype=bf16)
        rule = FM.wgrad_split(p, k, n, sms, rows)
        runs = {"wmma + nerf_bias_grad": lambda: FN.nerf_dense_wgrad(
            *args, mainloop="wmma", **kw)}
        for split in sorted({rule, 512, 1024, 2048, 4096}):
            runs[f"wgmma split {split}" + (" (rule)" if split == rule else "")] = (
                lambda s=split: FN.nerf_dense_wgrad(*args, mainloop="wgmma", split=s, **kw))
        lib = [] if x is None else [f"X^T @ G {both(lambda: x.t() @ gb)}"]
        if enc:
            enc_op = FN._encoding(rays8, n_s, z, enc, n_freq, rows, bf16).to(bf16)
            xe = enc_op if x is None else torch.cat([x, enc_op], dim=1)
            lib.append(f"[X | enc]^T @ G {both(lambda: xe.t() @ gb)}")
        nbytes = ((0 if x is None else x.numel() * 2) + dy.numel() * 4 + y.numel() * 2
                  + (k + 1 + rows) * n * 4)
        print(f"nerf_dense_wgrad {what} K={k} N={n} e_rows={rows}, {p} points, on "
              f"{card}: library {', '.join(lib)}, bound "
              f"{1e3 * nbytes / 3.35e12:.3f} ms (bytes)")
        in_turns(runs)


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
    ap.add_argument("--composite", action="store_true",
                    help="time composite_loss_bwd and composite_bwd on both "
                         "bodies, then profile the training step")
    ap.add_argument("--heads", action="store_true",
                    help="time sc_loss_bwd with its parts dropped and other "
                         "samples in flight, and field_heads, then profile "
                         "the training step")
    ap.add_argument("--wgrad", action="store_true",
                    help="time siren_dense_wgrad's mainloops and splits (with "
                         "--model nerf: nerf_dense_dgrad's and "
                         "nerf_dense_wgrad's, then profile the nerf step)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_render_torch: needs an NVIDIA GPU")
    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.train.system import NeRFSystem

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.ablate:
        (nerf_ablate if args.model == "nerf" else ablate)(card)
        return
    if args.composite:
        composite(card)
        args.train = True
    if args.heads:
        heads(card)
        args.train = True
    if args.wgrad and args.model != "nerf":
        wgrad(card)
        return
    if args.wgrad:  # the two kernels alone, then the nerf step they run in
        nerf_wgrad(card)
        args.train = True
    units = 256 if args.model == "nerf" else 512  # the widths run_all.sh trains
    cfg = Config(model=args.model, fc_layers=8, fc_units=units, n_samples=64,
                 chunk=args.chunk, batch_size=args.batch, first_beta_epoch=0,
                 sc_lambda=args.sc_lambda, ds_lambda=args.ds_lambda, ds_drop=1.0,
                 n_importance=args.n_importance, fused=args.fused)
    system = NeRFSystem(cfg, dataset_len=args.rays)
    params = system.init_params(0)
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

    from satnerf_tpu_torch.ops import fused_mlp as FM

    FM.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.render_image(params, rays, ts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report(prof, wall_ms, card, "render_image")
    if args.model == "nerf":
        by_mainloop(prof, "nerf_dense", card)


if __name__ == "__main__":
    main()
