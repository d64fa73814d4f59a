#!/usr/bin/env python3
"""Outputs of the port's kernels, saved from one tree and compared with
another's, on the card; and the times of the kernels a change redesigns, on
the tree it runs from.

  python3 tools/outputs_torch.py save OUT.pt      (from a tree's root)
  python3 tools/outputs_torch.py compare CHANGE.pt PARENT.pt
  python3 tools/outputs_torch.py time [PARENT_DIR] (from a tree's root)
  python3 tools/outputs_torch.py faint

`save` runs, on seeded inputs: composite_loss_bwd and composite_bwd on both
bodies at 64 and 256 samples a ray (the per-sample cotangents and the
weights: no atomics), nerf_composite_loss_bwd (d_h, d_r), siren_dense at
K = 0 (layer 0 with its slope, sky_0), the skip layer's wgrad dW and db
with every point in one block's range (the fp32 atomics across ranges add
in another order each run), and a dgrad's dX; these must come out equal to
the bit. Then sc_loss_bwd (sums, d_s2, dWn row 4, dbn[4]) at 1,024 x 64,
1,024 x 128 and 256 x 640 samples, bf16 and fp32, with and without sigma
noise, and field_heads' (P, 16) output at 1,024 x 128 and at 131,072
points that are their own rays (S = 1), bf16 and fp32: field_heads to the
bit, sc_loss_bwd, whose body may change the order of its sums, to a
tolerance (TOLERANCES). Then heads_composite's (R, 16) products and (R, S)
weights at 65,536 x 64 (the serving chunk), 1,024 x 64 with sigma noise
(the depth pass) and 256 x 640 with noise, with and without the beta
head, and field_heads_bwd's d_h, d_r, d_s2, d_bh, d_skyh, dWn and dbn at
1,024 x 128 and at S = 1, each in bf16 and fp32, to a tolerance. It imports the
package of the directory it runs from, so the same file saves from two
checkouts.

`compare` prints how many outputs are equal to the bit, and for the others
the largest difference and whether it is within the output's tolerance
(taken of the second file's entries: the parent's); it exits nonzero if an output without a tolerance differs or one with a
tolerance exceeds it.

`time` times sc_loss_bwd, field_heads, heads_composite and field_heads_bwd
alone at those shapes in bf16 (CUDA events over 20 launches after a
warm-up, the wrapper's zero fills included; then the kernels' own device
time by torch.profiler, and each kernel's share where a wrapper launches
more than one), with the card's name, power limit and clocks. Given the
root of another tree (`time PARENT_DIR`), it also builds that tree's
csrc/fused_render.cu and csrc/fused_field.cu into a library of their own
and times field_heads, heads_composite and field_heads_bwd through the
same wrappers on either library, in one process and in turns (parent,
change, change, parent): the C entries keep their contract, so the same
call drives both.

`faint` prints sc_loss_bwd's dbn[4] on one ray of the most samples its
shared memory holds, from the kernel and from the plain version on the card
and on the CPU, with depths over [0, 1] and over [0, S / 320]: how far two
fp32 evaluations of the same formula drift apart where every factor
1 - alpha lies within 1e-4 of 1.
"""

import os
import subprocess
import sys

SC_SHAPES = ((1024, 64), (1024, 128), (256, 640))  # (rays, samples a ray)
FIELD_SHAPES = ((1024, 128), (131072, 1))
# (rays, samples a ray, sigma noise): the serving chunk, the depth pass's
# batch, and a ray past two chunks of the block scan at fewer rays
HEADS_SHAPES = ((65536, 64, False), (1024, 64, True), (256, 640, True))
FEAT, FH = 512, 256

# Outputs held to a tolerance, by the start of their name (the longest
# that fits), and why:
# sc_loss_bwd: the transmittance is a product whose order differs between a
#   walk and a scan, and the sums over rays are fp32 atomics whose order
#   changes from run to run: 1e-4 of the tensor's largest entry; in bf16 a
#   d_s2 entry may also move by one bf16 step of itself (2^-7 relative),
#   where the cotangent lands on the other side of a rounding boundary.
# heads_composite: the heads' dot products sum their terms in another
#   order, the transmittance is a product in another order (a block scan in
#   double against a walk in fp32, up to 640 factors) and the integrals are
#   sums in another order: 1e-4 of max(1, |entry|).
# field_heads_bwd: the recomputed heads sum their dot products in another
#   order, and dWn and dbn are sums over all points, by fp32 atomics whose
#   order changes from run to run: 1e-4 of the tensor's largest entry; in
#   bf16 a cotangent entry may also move by one bf16 step of itself, where
#   the pre-activation cotangent lands on the other side of a rounding
#   boundary, and d_r and d_skyh (sums of three such products, one a color
#   channel) by one step of one term: 2^-8 of the tensor's largest entry.
TOLERANCES = {"sc_loss_bwd": 1e-4, "heads_composite": 1e-4, "field_heads_bwd": 1e-4}


def _tensors(g, dev):
    import torch

    def t(*shape, s=1.0, dtype=torch.bfloat16):
        return ((torch.rand(*shape, generator=g, device=g.device) * 2 - 1) * s).to(dev, dtype)

    return t


def _sc_args(t, g, dev, n_rays, n_s, dtype, noise):
    import torch

    p = n_rays * n_s
    h, s2 = t(p, FEAT, dtype=dtype), t(p, FH, dtype=dtype)
    wn = t(9, FEAT, s=0.1, dtype=dtype)
    wn[0] = t(FEAT, s=3.0 / FEAT ** 0.5, dtype=dtype)  # sigma of order 1
    bn = t(9, dtype=torch.float32)
    z = torch.sort(torch.rand(n_rays, n_s, generator=g), 1).values.to(dev)
    nz = t(n_rays, n_s, dtype=torch.float32) if noise else None
    return (h, s2, wn, bn, z, nz, 0.1 / 3)


def _field_args(t, n_rays, n_s, dtype):
    import torch

    p = n_rays * n_s
    return (t(p, FEAT, dtype=dtype), t(p, FH, dtype=dtype), t(p, FH, dtype=dtype),
            t(p, FH, dtype=dtype), t(n_rays, FH, dtype=dtype).relu(),
            t(9, FEAT, s=0.5, dtype=dtype), t(9, dtype=torch.float32), n_s)


def _heads_args(t, g, n_rays, n_s, dtype, noise):
    """heads_composite's positional arguments and its noise (or None); made
    on the device's generator g: 4.19 M points of rows at the serving chunk."""
    import torch

    p = n_rays * n_s
    h, r, s2, bh = (t(p, FEAT, dtype=dtype), t(p, FH, dtype=dtype),
                    t(p, FH, dtype=dtype), t(p, FH, dtype=dtype))
    wn = t(9, FEAT, s=0.1, dtype=dtype)
    wn[0] = t(FEAT, s=3.0 / FEAT ** 0.5, dtype=dtype)  # sigma of order 1
    z = torch.sort(torch.rand(n_rays, n_s, generator=g, device=g.device), 1).values
    nz = t(n_rays, n_s, dtype=torch.float32) if noise else None
    return (h, r, s2, bh, t(n_rays, FH, dtype=dtype).relu(), wn,
            t(9, dtype=torch.float32), z), nz


def save(path: str) -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.ops import fused_nerf as FN

    if not torch.cuda.is_available():
        raise SystemExit("outputs_torch.py save runs on a GPU")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    t = _tensors(g, dev)

    out = {}
    n_rays, feat, fh = 96, 512, 256
    for n_s in (64, 256):
        p = n_rays * n_s
        h, r, s2, bh = t(p, feat), t(p, fh), t(p, fh), t(p, fh)
        skyh = t(n_rays, fh).relu()
        wn, bn = t(9, feat, s=0.1), t(9, dtype=torch.float32)
        z = torch.sort(torch.rand(n_rays, n_s, generator=g), 1).values.to(dev)
        noise = t(n_rays, n_s, dtype=torch.float32)
        gt = t(n_rays, 3, dtype=torch.float32).abs()
        cot = t(n_rays, 16, dtype=torch.float32)
        args = (h, r, s2, bh, skyh, wn, bn, z, noise)
        for body in ("block", "warp"):
            a = FM.composite_loss_bwd(*args, gt, 0.7, return_weights=True, body=body)
            b = FM.composite_bwd(*args, cot, body=body)
            for k in ("d_h", "d_r", "d_s2", "d_bh", "d_skyh", "weights"):
                out[f"composite_loss_bwd {body} S={n_s} {k}"] = a[k].cpu()
            for k in ("d_h", "d_r", "d_s2", "d_bh", "d_skyh"):
                out[f"composite_bwd {body} S={n_s} {k}"] = b[k].cpu()
        a = FN.nerf_composite_loss_bwd(t(p, 256), t(p, 128).relu(), t(4, 256, s=0.1),
                                       t(4, dtype=torch.float32), z, noise, gt)
        for k in ("d_h", "d_r"):
            out[f"nerf_composite_loss_bwd S={n_s} {k}"] = a[k].cpu()
    rays16 = t(1024, 16, s=0.5, dtype=torch.float32)
    z = torch.sort(torch.rand(1024, 64, generator=g), 1).values.to(dev)
    c0, b0 = t(3, 512, s=0.5), t(512, dtype=torch.float32)
    y, slope = FM.siren_dense(None, None, b0, rays16, 64, extra="xyz",
                              extra_weight=c0, z=z, w0=30.0, save=True)
    out["siren_dense K=0 layer 0 Y"], out["siren_dense K=0 layer 0 slope"] = y.cpu(), slope.cpu()
    out["siren_dense K=0 sky_0 Y"] = FM.siren_dense(
        None, None, b0[:256], rays16, 1, extra="sun",
        extra_weight=c0[:, :256].contiguous(), act="relu").cpu()
    x = t(4096, 512)
    dy, sl = t(4096, 512, dtype=torch.float32), t(4096, 512, s=30, dtype=torch.float32)
    w = FM.siren_dense_wgrad(x, dy, sl, rays16[:64], 64, extra="xyz",
                             extra_weight=t(3, 512, s=0.3), z=z[:64], split=4096)
    out["skip layer dW"], out["skip layer db"] = w[0].cpu(), w[1].cpu()
    out["dgrad dX"] = FM.siren_dense_dgrad(dy, sl, t(512, 512, s=0.05)).cpu()

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for n_r, n_s in SC_SHAPES:
            for noise in (False, True):
                res = FM.sc_loss_bwd(*_sc_args(t, g, dev, n_r, n_s, dtype, noise))
                tag = f"sc_loss_bwd {dname} R={n_r} S={n_s} noise={'on' if noise else 'off'}"
                out[f"{tag} sums"] = res["sums"].cpu()
                out[f"{tag} d_s2"] = res["d_s2"].cpu()
                out[f"{tag} dWn row 4"] = res["dwn"][4].cpu()
                out[f"{tag} dbn[4]"] = res["dbn"][4:5].cpu()
        for n_r, n_s in FIELD_SHAPES:
            out[f"field_heads {dname} R={n_r} S={n_s}"] = FM.field_heads(
                *_field_args(t, n_r, n_s, dtype)).cpu()
    # on the card's generator: the serving chunk's rows would take minutes
    # on the host's
    gd = torch.Generator(device=dev).manual_seed(2)
    td = _tensors(gd, dev)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for n_r, n_s, noise in HEADS_SHAPES:
            args, nz = _heads_args(td, gd, n_r, n_s, dtype, noise)
            for beta in (True, False):
                a = args[:3] + (args[3] if beta else None,) + args[4:]
                prod, w = FM.heads_composite(*a, noise=nz, return_weights=True)
                tag = (f"heads_composite {dname} R={n_r} S={n_s} noise="
                       f"{'on' if noise else 'off'} beta={'on' if beta else 'off'}")
                out[f"{tag} products"], out[f"{tag} weights"] = prod.cpu(), w.cpu()
            del args, a, nz, prod, w
        for n_r, n_s in FIELD_SHAPES:
            args = _field_args(td, n_r, n_s, dtype)
            res = FM.field_heads_bwd(*args, td(n_r * n_s, 16, dtype=torch.float32))
            for k, v in res.items():
                out[f"field_heads_bwd {dname} R={n_r} S={n_s} {k}"] = v.cpu()
            del args, res
    torch.cuda.synchronize()
    torch.save(out, path)
    print(f"saved {len(out)} outputs to {path}")


def _tolerance(name: str):
    keys = [k for k in TOLERANCES if name.startswith(k)]
    return TOLERANCES[max(keys, key=len)] if keys else None


def _within(name: str, a, b, tol: float) -> bool:
    """b (the reference tree's) against a, as TOLERANCES says."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    if name.startswith("heads_composite"):
        return bool((diff <= tol * b.abs().clamp_min(1.0)).all())
    lim = tol * b.abs().max()
    bf16_cot = "bfloat16" in name and name.split()[-1].startswith("d_")
    if bf16_cot and name.startswith("sc_loss_bwd"):
        lim = lim + 2.0 ** -7 * b.abs()
    if bf16_cot and name.startswith("field_heads_bwd"):
        lim = lim + 2.0 ** -7 * b.abs()
        if name.split()[-1] in ("d_r", "d_skyh"):
            lim = lim + 2.0 ** -8 * b.abs().max()
    return bool((diff <= lim).all())


def compare(path_a: str, path_b: str) -> None:
    """path_b is the reference: its entries scale the tolerances."""
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    if set(a) != set(b):
        raise SystemExit(f"the two files hold other outputs: {set(a) ^ set(b)}")
    diff = {k: (a[k].float() - b[k].float()).abs().max().item()
            for k in a if not torch.equal(a[k], b[k])}
    bits = [k for k in a if _tolerance(k) is None]
    print(f"equal to the bit: {len(a) - len(diff)} of {len(a)} "
          f"({sum(k not in diff for k in bits)} of the {len(bits)} held to the bit)")
    bad = []
    for k, d in diff.items():
        tol = _tolerance(k)
        ok = tol is not None and _within(k, a[k], b[k], tol)
        rel = d / max(b[k].float().abs().max().item(), 1e-30)
        print(f"  {k}: max |diff| {d:.3g} ({rel:.2e} of the largest entry), "
              + (f"within its tolerance {tol}" if ok else "FAILS" if tol else
                 "FAILS: held to the bit"))
        if not ok:
            bad.append(k)
    if bad:
        sys.exit(1)


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _parent_library(parent_dir: str):
    """parent_dir's fused_render.cu and fused_field.cu (heads_composite,
    field_heads, field_heads_bwd) built as the package builds its sources, into one
    library under this tree's build directory, bound by the same signatures."""
    import ctypes

    from satnerf_tpu_torch.ops import _build as B

    out = os.path.join(B.BUILD_DIR, "parent")
    os.makedirs(out, exist_ok=True)
    objs, jobs = [], []
    for src in ("fused_render.cu", "fused_field.cu"):
        obj = os.path.join(out, src + ".o")
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-c",
               os.path.join(parent_dir, "satnerf_tpu_torch", "csrc", src), "-o", obj]
        objs.append(obj)
        jobs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
    for job in jobs:
        log, _ = job.communicate()
        if job.returncode != 0:
            raise SystemExit(f"nvcc failed on the parent's sources:\n{log}")
    lib = os.path.join(out, "libsatnerf_parent.so")
    subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-shared", "-o", lib, *objs], check=True)
    cdll = ctypes.CDLL(lib)
    for name in ("satnerf_heads_composite", "satnerf_field_heads", "satnerf_field_heads_bwd"):
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = B.SIGNATURES[name], ctypes.c_int
    return cdll


def time_kernels(parent_dir=None) -> None:
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    from satnerf_tpu_torch.ops import _build as B
    from satnerf_tpu_torch.ops import fused_mlp as FM

    if not torch.cuda.is_available():
        raise SystemExit("outputs_torch.py time runs on a GPU")
    card = _smi("name,power.limit")
    parent = None if parent_dir is None else _parent_library(parent_dir)
    own_library = B.load_library
    print(f"clocks (sm, mem), power, temperature at the start: "
          f"{_smi('clocks.sm,clocks.mem,power.draw,temperature.gpu')}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    t = _tensors(g, dev)

    def event_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, name, reps=20):
        """The device time a call of the kernels whose name holds `name`
        (not the wrapper's zero fills), and of each such kernel by name."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        each = {}
        for e in prof.key_averages():
            if name in e.key:  # "void (anonymous namespace)::kernel<T>(...)" -> kernel
                short = e.key.replace("(anonymous namespace)::", "").split("(")[0]
                short = short.split("<")[0].split()[-1]
                each[short] = each.get(short, 0.0) + e.device_time_total / 1e3 / reps
        return sum(each.values()), each

    def report(what, fn, name):
        total, each = device_ms(fn, name)
        parts = (" (" + ", ".join(f"{k} {v:.4f}" for k, v in each.items()) + ")"
                 if len(each) > 1 else "")
        print(f"{what}: {event_ms(fn):.4f} ms by events, {total:.4f} ms of the "
              f"kernels{parts} on {card}", flush=True)

    for n_r, n_s in SC_SHAPES:
        args = _sc_args(t, g, dev, n_r, n_s, torch.bfloat16, True)
        report(f"sc_loss_bwd bf16 R={n_r} S={n_s}", lambda: FM.sc_loss_bwd(*args),
               "sc_loss_bwd")
    def paired(what, fn, name):
        """fn through the parent's library and this tree's, in turns."""
        got = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            B.load_library = (lambda: parent) if who == "parent" else own_library
            try:
                got[who].append((event_ms(fn), device_ms(fn, name)[0]))
            finally:
                B.load_library = own_library
        print(f"{what}, in turns: " + "; ".join(
            f"{who} " + ", ".join(f"{e:.4f} by events / {d:.4f} device" for e, d in v)
            for who, v in got.items()) + f" ms on {card}", flush=True)

    for n_r, n_s in FIELD_SHAPES:
        args = _field_args(t, n_r, n_s, torch.bfloat16)
        what = f"field_heads bf16 R={n_r} S={n_s}"
        fn = lambda: FM.field_heads(*args)  # noqa: E731
        report(what, fn, "field_heads_stream")
        if parent is not None:
            paired(what, fn, "field_heads_stream")
    gd = torch.Generator(device=dev).manual_seed(3)
    td = _tensors(gd, dev)
    for n_r, n_s, noise in HEADS_SHAPES:
        args, nz = _heads_args(td, gd, n_r, n_s, torch.bfloat16, noise)
        weights = not noise  # as the main path calls it: serving asks for them
        what = (f"heads_composite bf16 R={n_r} S={n_s} noise={'on' if noise else 'off'} "
                f"weights={'on' if weights else 'off'}")
        fn = lambda: FM.heads_composite(*args, noise=nz, return_weights=weights)  # noqa: E731
        report(what, fn, "heads_composite")
        if parent is not None:
            paired(what, fn, "heads_composite")
        del args, nz
    for n_r, n_s in FIELD_SHAPES:
        args = _field_args(td, n_r, n_s, torch.bfloat16)
        cot = td(n_r * n_s, 16, dtype=torch.float32)
        what = f"field_heads_bwd bf16 R={n_r} S={n_s}"
        fn = lambda: FM.field_heads_bwd(*args, cot)  # noqa: E731
        report(what, fn, "_bwd")
        if parent is not None:
            paired(what, fn, "_bwd")
        del args, cot
    print(f"clocks (sm, mem), power, temperature at the end: "
          f"{_smi('clocks.sm,clocks.mem,power.draw,temperature.gpu')}", flush=True)


def faint() -> None:
    """sc_loss_bwd's dbn[4] on one ray of the most samples a block holds,
    with depths over [0, 1] (each factor 1 - alpha within 1e-4 of 1) and over
    [0, S / 320] (the spacing of 320 samples over [0, 1]): the kernel, the
    plain version on the card and the plain version on the CPU, fp32."""
    sys.path.insert(0, os.getcwd())
    import torch

    from satnerf_tpu_torch.ops import fused_mlp as FM

    if not torch.cuda.is_available():
        raise SystemExit("outputs_torch.py faint runs on a GPU")
    dev = torch.device("cuda")
    for fh in (48, 256):
        n_s = FM.sc_max_samples(2 * fh, fh)
        for span in (1.0, n_s / 320):
            g = torch.Generator().manual_seed(30)
            t = _tensors(g, "cpu")
            h, s2 = t(n_s, 2 * fh, dtype=torch.float32), t(n_s, fh, dtype=torch.float32)
            wn = t(9, 2 * fh, s=0.5, dtype=torch.float32)
            wn[0] = t(2 * fh, s=3.0 / (2 * fh) ** 0.5, dtype=torch.float32)
            bn = torch.randn(9, generator=g)
            z = torch.sort(torch.rand(1, n_s, generator=g), 1).values * span
            args = (h, s2, wn, bn, z, None, 0.1 / 3)
            on_card = tuple(None if a is None or isinstance(a, float) else a.to(dev)
                            for a in args[:-1]) + (args[-1],)
            kernel = FM.sc_loss_bwd(*on_card)["dbn"][4].item()
            card = FM.sc_loss_bwd_reference(*on_card)["dbn"][4].item()
            cpu = FM.sc_loss_bwd_reference(*args)["dbn"][4].item()
            print(f"sc_loss_bwd fp32 F={2 * fh} S={n_s} z over [0, {span:g}]: dbn[4] "
                  f"kernel {kernel:.7g}, plain on the card {card:.7g}, plain on the "
                  f"CPU {cpu:.7g}; kernel vs card {abs(kernel - card) / abs(card):.2e}, "
                  f"kernel vs CPU {abs(kernel - cpu) / abs(cpu):.2e}, card vs CPU "
                  f"{abs(card - cpu) / abs(cpu):.2e}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        save(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    elif len(sys.argv) in (2, 3) and sys.argv[1] == "time":
        time_kernels(*sys.argv[2:])
    elif len(sys.argv) == 2 and sys.argv[1] == "faint":
        faint()
    else:
        raise SystemExit(__doc__)
