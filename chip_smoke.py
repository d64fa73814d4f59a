#!/usr/bin/env python3
"""Smoke run of the PyTorch port (satnerf_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, any failure exits nonzero:
  0  the card: torch.cuda must see a GPU (no CPU run), name and power limit
  1  build the CUDA kernels in satnerf_tpu_torch/csrc/ with nvcc (sm_90a)
  2  each kernel against its plain PyTorch version on the card, at 8 x 512,
     64 samples, 8192 + 37 rays (a ragged edge), sat-nerf and s-nerf, fp32 and
     bf16, with the compositing weights; max errors and times printed
  3  the serving path through its entry point: a 128 x 128 synthetic AOI,
     a seeded sat-nerf 8 x 512 checkpoint, create_pretty_dsm on the card
     (finite DSM and MAE, every kernel launched), then render_image on
     262,144 rays for a rays/s reading

The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Scratch files go to build/chip_smoke/.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
KERNEL_SOURCE = "satnerf_tpu_torch/csrc/fused_render.cu"
TPU_KERNEL = "satnerf_tpu/ops/pallas/fused_mlp.py:1035"
LAYERS, FEAT, SAMPLES, TAU = 8, 512, 64, 4
N_RAYS = 8192 + 37
CHUNK = 65536  # rays a render_image chunk holds (--chunk default)
DEPTH_RANGE = 1.0  # far - near of the phase 2 rays

# Tolerances (kernel vs plain version, same inputs, same operand dtype).
# fp32: both sum the same fp32 products in another order; over 512-term dots,
#   eight layers and sin(30 x) at layer 0 that stays well below 1e-3.
# bf16: every activation is rounded to bf16 between layers. A different
#   summation order can move a pre-activation across a bf16 rounding boundary,
#   one step of 2^-8 relative, and such steps travel through the remaining
#   layers: 2e-2 on the [0, 1] products and 2e-2 * (far - near) on depth.
# siren_dense alone (one layer, same inputs): fp32 1e-4 abs + 1e-4 rel;
#   bf16 at most one bf16 rounding step, 2^-7 * |ref| + 1e-4.
# heads_composite alone: identical operands, fp32 arithmetic, 1e-4.
K2_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase0():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on "
              "a GPU", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    print(card, flush=True)
    return name, card


def phase1():
    sys.path.insert(0, REPO)
    from satnerf_tpu_torch.ops._build import build, load_library

    path, secs = build()
    load_library()
    log(f"phase 1: built {os.path.relpath(path, REPO)} in {secs:.1f} s")
    return secs


def _cuda_ms(fn, reps: int = 3) -> float:
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _inputs(n_rays: int, seed: int, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    o = torch.rand(n_rays, 3, generator=g) - 0.5
    d = torch.randn(n_rays, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    sun = torch.randn(n_rays, 3, generator=g)
    sun = sun / sun.norm(dim=1, keepdim=True)
    t = torch.randn(n_rays, TAU, generator=g)
    near, far = torch.zeros(n_rays, 1), torch.ones(n_rays, 1)
    from satnerf_tpu_torch.render.sampling import stratified_zvals

    z = stratified_zvals(g, near, far, SAMPLES, perturb=1.0)
    return [x.to(device) for x in (o, d, sun, t, z)]


class StageCheck:
    """Stands in for siren_dense / heads_composite in the staged render:
    launches the kernel, runs the plain version on the same inputs, records
    the error against the stated tolerance."""

    def __init__(self, dtype):
        self.bf16 = str(dtype).endswith("bfloat16")
        self.err = {"siren_dense": 0.0, "heads_composite": 0.0}
        self.bad = []

    def dense(self, *args, **kw):
        from satnerf_tpu_torch.ops.fused_mlp import (siren_dense,
                                                     siren_dense_reference)

        y = siren_dense(*args, **kw)
        ref = siren_dense_reference(*args, **kw).float()
        diff = (y.float() - ref).abs()
        tol = (2.0 ** -7 * ref.abs() + 1e-4 if self.bf16
               else 1e-4 * ref.abs() + 1e-4)
        self.err["siren_dense"] = max(self.err["siren_dense"], diff.max().item())
        if bool((diff > tol).any()):
            self.bad.append(f"siren_dense extra={kw.get('extra')} "
                            f"max err {diff.max().item():.3g}")
        return y

    def heads(self, *args, **kw):
        from satnerf_tpu_torch.ops.fused_mlp import (heads_composite,
                                                     heads_composite_reference)

        out, w = heads_composite(*args, **kw)
        ref, ref_w = heads_composite_reference(*args, **kw)
        e = (out - ref).abs().max().item()
        if w is not None:
            e = max(e, (w - ref_w).abs().max().item())
        self.err["heads_composite"] = max(self.err["heads_composite"], e)
        if e > 1e-4:
            self.bad.append(f"heads_composite max err {e:.3g}")
        return out, w


def _time_kernels(packed: dict, dtype, dname: str, dev) -> dict:
    """Kernel and plain ms of one trunk layer (the skip layer) and of the
    compositor at the main path's shapes: one chunk of CHUNK rays x 64
    samples, 4.19 M points."""
    import torch
    from satnerf_tpu_torch.ops import fused_mlp as FM

    o, d, sun, t, z = _inputs(CHUNK, 3, dev)
    rays16 = FM.pack_rays(o, d, sun, t, TAU)
    p, fh = CHUNK * SAMPLES, FEAT // 2
    g = torch.Generator(device=dev).manual_seed(4)
    h = (torch.rand(p, FEAT, generator=g, device=dev) * 2 - 1).to(dtype)
    args = (h, packed["B"][3], packed["bt"][4], rays16, SAMPLES)
    dkw = dict(extra="xyz", extra_weight=packed["C"], z=z)
    times = {("siren_dense", dname): (
        _cuda_ms(lambda: FM.siren_dense(*args, **dkw)),
        _cuda_ms(lambda: FM.siren_dense_reference(*args, **dkw)))}
    hs = [(torch.rand(p, fh, generator=g, device=dev) * 2 - 1).to(dtype)
          for _ in range(3)]
    skyh = torch.rand(CHUNK, fh, generator=g, device=dev).to(dtype)
    hargs = (h, *hs, skyh, packed["wn"], packed["bn"], z)
    hkw = dict(rgb_padding=0.001, return_weights=True)
    times[("heads_composite", dname)] = (
        _cuda_ms(lambda: FM.heads_composite(*hargs, **hkw)),
        _cuda_ms(lambda: FM.heads_composite_reference(*hargs, **hkw)))
    return times


def phase2(results: dict):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from satnerf_tpu_torch.models.nerf import build_model
    from satnerf_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda:0")
    failures = []
    times = {}
    launches_before = dict(FM.LAUNCHES)
    for variant in ("sat-nerf", "s-nerf"):
        use_beta = variant == "sat-nerf"
        field = build_model(variant, LAYERS, FEAT, t_dim=TAU,
                            generator=torch.Generator().manual_seed(1)).to(dev)
        o, d, sun, t, z = _inputs(N_RAYS, 2, dev)
        t_in = t if use_beta else None
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            kw = dict(layers=LAYERS, feat=FEAT, skip=4, use_beta=use_beta,
                      tau=TAU, dtype=dtype, return_weights=True)
            with torch.inference_mode():
                out = FM.fused_render_rays(field, o, d, sun, t_in, z, **kw)
                ref = FM.fused_render_rays_reference(field, o, d, sun, t_in, z,
                                                     **kw)
                torch.cuda.synchronize()
                errs = {k: (out[k] - ref[k]).abs().max().item() for k in ref}
                tol = K2_TOL[dname]
                for k, e in errs.items():
                    lim = tol * DEPTH_RANGE if k == "depth" else tol
                    if not e <= lim:
                        failures.append(f"K2 {variant} {dname} {k}: {e:.3g} > {lim}")

                # every launch of the chain against its plain version
                chk = StageCheck(dtype)
                rays16 = FM.pack_rays(o, d, sun, t_in, TAU)
                packed = FM.pack_params(field, skip=4, use_beta=use_beta,
                                        dtype=dtype)
                FM._render_staged(packed, rays16, z, skip=4, use_beta=use_beta,
                                  rgb_padding=0.001, return_weights=True,
                                  dense_fn=chk.dense, heads_fn=chk.heads)
                torch.cuda.synchronize()
                failures += [f"{variant} {dname}: {b}" for b in chk.bad]
                for k, e in chk.err.items():
                    key = (k, dname)
                    results["err"][key] = max(results["err"].get(key, 0.0), e)

                k2_ms = _cuda_ms(lambda: FM.fused_render_rays(
                    field, o, d, sun, t_in, z, **kw))
                plain_ms = _cuda_ms(lambda: FM.fused_render_rays_reference(
                    field, o, d, sun, t_in, z, **kw))
                if variant == "sat-nerf":
                    times.update(_time_kernels(packed, dtype, dname, dev))
            log(f"phase 2: K2 {variant} {dname} R={N_RAYS} S={SAMPLES}: "
                f"kernel {k2_ms:.2f} ms, plain {plain_ms:.2f} ms; max err "
                + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                + "; per launch " + ", ".join(f"{k} {e:.2e}"
                                              for k, e in chk.err.items()))
            results["k2"][(variant, dname)] = (k2_ms, plain_ms, errs)
            del out, ref
    for (name, dname), (ms, pms) in times.items():
        log(f"phase 2: {name} {dname} at a main-path chunk ({CHUNK} rays x "
            f"{SAMPLES}): kernel {ms:.3f} ms, plain {pms:.3f} ms")
    results["times"] = times
    grown = {k: FM.LAUNCHES[k] - launches_before[k] for k in FM.LAUNCHES}
    if not all(v > 0 for v in grown.values()):
        failures.append(f"launch counters did not grow: {grown}")
    if failures:
        raise SystemExit("phase 2 failed:\n  " + "\n  ".join(failures))


def phase3(results: dict, card: str):
    import torch

    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.eval import read_geotiff
    from satnerf_tpu_torch.eval.loader import load_run_config
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.train.checkpoints import (checkpoint_path,
                                                     save_checkpoint)
    from satnerf_tpu_torch.train.system import NeRFSystem

    shutil.rmtree(WORK, ignore_errors=True)
    aoi = os.path.join(WORK, "aoi")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synthetic_aoi.py"),
                    aoi, "--size", "128"], check=True, cwd=REPO, timeout=300,
                   stdout=subprocess.DEVNULL)
    log(f"phase 3: synthetic 128 x 128 AOI in {time.perf_counter() - t0:.1f} s")

    run_id, logs, ckpts = "smoke", os.path.join(WORK, "logs"), os.path.join(WORK, "ckpts")
    os.makedirs(os.path.join(logs, run_id))
    opts = {"model": "sat-nerf", "fc_layers": LAYERS, "fc_units": FEAT,
            "n_samples": SAMPLES, "chunk": CHUNK, "exp_name": run_id,
            "root_dir": os.path.join(aoi, "data"), "gt_dir": os.path.join(aoi, "gt"),
            "logs_dir": logs, "ckpts_dir": ckpts}
    with open(os.path.join(logs, run_id, "opts.json"), "w") as f:
        json.dump(opts, f)
    cfg = load_run_config(logs, run_id)
    system = NeRFSystem(cfg, device="cuda")
    params = system.init_params(torch.Generator().manual_seed(0))
    save_checkpoint(checkpoint_path(ckpts, run_id, 1), params)

    out_dir = os.path.join(WORK, "out")
    FM.reset_launches()
    t0 = time.perf_counter()
    mae = create_pretty_dsm(run_id, logs, out_dir, 1, device="cuda")
    dsm_s = time.perf_counter() - t0
    launches = dict(FM.LAUNCHES)
    dsm_path = glob.glob(os.path.join(out_dir, run_id, "*_dsm_epoch1.tif"))[0]
    dsm = read_geotiff(dsm_path).data[0]
    finite = float(np.isfinite(dsm).mean())
    log(f"phase 3: create_pretty_dsm in {dsm_s:.2f} s: DSM {dsm.shape} "
        f"{finite:.3f} finite, MAE {mae:.3f} m, launches {launches}")
    if not (mae is not None and np.isfinite(mae)):
        raise SystemExit(f"phase 3 failed: MAE {mae}")
    # random weights scatter the depths, so the raster over their bounding
    # box is sparse; the chain must still place a good share of cells
    if finite < 0.05:
        raise SystemExit(f"phase 3 failed: DSM only {finite:.3f} finite")
    if not all(v > 0 for v in launches.values()):
        raise SystemExit(f"phase 3 failed: a kernel was not launched: {launches}")
    results["launches"] = launches

    # a 512 x 512 view worth of rays, made like bench.py:91-97
    rng = np.random.RandomState(0)
    n = 1 << 18
    rays = rng.rand(n, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    ts = rng.randint(0, 30, n).astype(np.int32)
    res = system.render_image(params, rays, ts)  # warm up
    reps, t0 = 2, time.perf_counter()
    for _ in range(reps):
        res = system.render_image(params, rays, ts)
    dt = (time.perf_counter() - t0) / reps
    for k, v in res.items():
        if v.shape[0] != n or not np.isfinite(v).all():
            raise SystemExit(f"phase 3 failed: render_image {k} {v.shape}")
    log(f"phase 3: render_image {n} rays (chunk {cfg.chunk}, "
        f"{str(system.compute_dtype).split('.')[-1]}): "
        f"{dt:.3f} s, {n / dt:.1f} rays/s on {card}")

    # the system's products against the plain version on the first rays of
    # the first chunk and on the last rays of that chunk (the highest point
    # indices a launch addresses)
    from satnerf_tpu_torch.render.sampling import stratified_zvals

    m = 4096
    keys = ("rgb", "depth", "sun", "sky", "albedo", "beta", "opacity")
    errs = dict.fromkeys(keys, 0.0)
    for lo in (0, cfg.chunk - m):
        sl = slice(lo, lo + m)
        with torch.inference_mode():
            r = torch.from_numpy(rays[sl]).to("cuda")
            t_e = params["embedding_t"](torch.from_numpy(ts[sl]).long().to("cuda"))
            z = stratified_zvals(None, r[:, 6:7], r[:, 7:8], SAMPLES, perturb=0.0)
            ref = FM.fused_render_rays_reference(
                params["nerf_coarse"], r[:, 0:3], r[:, 3:6], r[:, 8:11], t_e, z,
                layers=LAYERS, feat=FEAT, tau=TAU, dtype=system.compute_dtype)
        for k in keys:
            e = np.abs(res[f"{k}_coarse"][sl].reshape(m, -1)
                       - ref[k].float().cpu().numpy().reshape(m, -1)).max()
            errs[k] = max(errs[k], float(e))
    log(f"phase 3: render_image vs plain version on rays [0, {m}) and "
        f"[{cfg.chunk - m}, {cfg.chunk}): "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    lim = K2_TOL["bfloat16"]
    if not all(e <= lim * (DEPTH_RANGE if k == "depth" else 1.0)
               for k, e in errs.items()):
        raise SystemExit(f"phase 3 failed: render_image disagrees: {errs}")


def main():
    name, card = phase0()
    secs = phase1()
    import torch

    results = {"err": {}, "k2": {}}
    phase2(results)
    phase3(results, card)
    kernels = []
    for kname in ("siren_dense", "heads_composite"):
        ms, pms = results["times"][(kname, "bfloat16")]
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL, "launches": results["launches"][kname],
            "max_abs_err": max(results["err"][(kname, "float32")],
                               results["err"][(kname, "bfloat16")]),
            "ms": ms, "plain_ms": pms,
        })
    if "jax" in sys.modules or "flax" in sys.modules:
        raise SystemExit("the port loaded jax")
    log(f"build {secs:.1f} s; card {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
