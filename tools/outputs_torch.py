#!/usr/bin/env python3
"""Outputs of the port's kernels, saved from one tree and compared with
another's, on the card; and the times of the kernels a change redesigns, on
the tree it runs from.

  python3 tools/outputs_torch.py save OUT.pt      (from a tree's root)
  python3 tools/outputs_torch.py compare CHANGE.pt PARENT.pt
  python3 tools/outputs_torch.py time [PARENT_DIR] (from a tree's root)
  python3 tools/outputs_torch.py faint
  python3 tools/outputs_torch.py variants NAME=CONST:VALUE[,CONST:VALUE] ...

`save` runs, on seeded inputs: composite_loss_bwd and composite_bwd on both
bodies at 64 and 256 samples a ray (the per-sample cotangents and the
weights: no atomics), siren_dense at K = 0 (layer 0 with its slope, sky_0), the skip layer's wgrad dW and db
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
1,024 x 128 and at S = 1, each in bf16 and fp32, to a tolerance. Then the
nerf variant's two per-ray kernels at F = 256, Fh = 128, in bf16 and fp32,
to a tolerance: nerf_heads_composite's (R, 8) products and (R, S) weights
at 65,536 x 64 (the serving chunk), 1,024 x 128 and 256 x 640 with sigma
noise, and every output of nerf_composite_loss_bwd (the loss, d_h, d_r, dWn,
dbn) at 96 x 64 and 96 x 256 (bf16), 1,024 x 64 (the training batch) and
256 x 640, with noise; and the two per-point kernels' outputs, nerf_field_heads'
(P, 8) and nerf_field_heads_bwd's d_h, d_r, dWn and dbn, at 131,072 and
65,536 points of the 8 x 256 field and at the widest width (16,384 points,
F = 512), in bf16 and fp32, to a tolerance. It imports the package of the directory it
runs from, so the same file saves from two checkouts.

`compare` prints how many outputs are equal to the bit, and for the others
the largest difference and whether it is within the output's tolerance
(taken of the second file's entries: the parent's); it exits nonzero if an output without a tolerance differs or one with a
tolerance exceeds it.

`time` times sc_loss_bwd, field_heads, heads_composite, field_heads_bwd,
nerf_heads_composite, nerf_composite_loss_bwd, nerf_field_heads and
nerf_field_heads_bwd alone at those shapes in
bf16 (CUDA events over 20 launches after a warm-up, the wrapper's zero fills
included; then the kernels' own device time by torch.profiler, and each
kernel's share where a wrapper launches more than one), with the card's
name, power limit and clocks. Given the root of another tree (`time
PARENT_DIR`), it also builds that tree's csrc/fused_render.cu,
csrc/fused_field.cu and csrc/fused_nerf.cu into a library of their own and
times all but sc_loss_bwd through the same wrappers on either library, in
one process and in turns (parent, change, change, parent): the C entries
keep their contract, so the same call drives both.

`variants` builds this tree's csrc/fused_nerf.cu once a spec with the
constants of its design choices set otherwise (in a copy of csrc/) and
times the two per-ray and the two per-point nerf kernels through each build
and the package's in turns, with ptxas' registers and spills of each.

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
# the nerf variant's per-ray kernels at its 8 x 256 field: (rays, samples a
# ray, sigma noise) of nerf_heads_composite (the serving chunk, a fine pass
# of --n_importance 64, past two chunks of the block scan) and (rays,
# samples a ray) of nerf_composite_loss_bwd (the training batch, past two
# chunks), always with noise as the trainer calls it
NERF_HEADS_SHAPES = ((65536, 64, False), (1024, 128, False), (256, 640, True))
NERF_LOSS_SHAPES = ((1024, 64), (256, 640))
NERF_FEAT, NERF_FH = 256, 128
# (points, F) of the nerf variant's per-point kernels (Fh = F / 2): the fine
# and the coarse pass of a hierarchical batch at the field's width, and the
# widest width they take
NERF_POINT_SHAPES = ((131072, 256), (65536, 256), (16384, 512))

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
# nerf_heads_composite: as heads_composite (the walk it replaced summed the
#   heads, T and the integrals in order): 1e-4 of max(1, |entry|).
# nerf_field_heads: the heads' dot products sum their terms in another
#   order: 1e-4 of max(1, |entry|), as heads_composite.
# nerf_field_heads_bwd: as field_heads_bwd (the recomputed heads sum in
#   another order; dWn and dbn by fp32 atomics in an order that changes from
#   run to run; in bf16 a cotangent entry one step of itself, d_r one step
#   of a term).
# nerf_composite_loss_bwd: the heads, T (a block scan in double against a
#   walk in fp32), the suffix sum of the adjoint (a block scan) and the rgb
#   integrals sum in another order, and the loss, dWn and dbn are sums over
#   rays by fp32 atomics: 1e-4 of the tensor's largest entry; in bf16 a
#   cotangent entry may also move by one bf16 step of itself and d_r (three
#   products of rounded cotangents) by one step of a term, 2^-8 of the
#   tensor's largest entry, as field_heads_bwd; dWn and dbn in bf16, sums
#   over every sample of such rounded products, to 5e-4 of their largest
#   entry, as tests/test_torch_cuda.py holds them past 256 samples.
TOLERANCES = {"sc_loss_bwd": 1e-4, "heads_composite": 1e-4, "field_heads_bwd": 1e-4,
              "nerf_heads_composite": 1e-4, "nerf_composite_loss_bwd": 1e-4,
              "nerf_field_heads": 1e-4, "nerf_field_heads_bwd": 1e-4}


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


def _nerf_args(t, g, n_rays, n_s, dtype):
    """h, r, wn, bn, z of the nerf per-ray kernels and their noise and gt,
    made on the device's generator g."""
    import torch

    p = n_rays * n_s
    h, r = t(p, NERF_FEAT, dtype=dtype), t(p, NERF_FH, dtype=dtype).relu()
    wn = t(4, NERF_FEAT, s=0.1, dtype=dtype)
    wn[0] = t(NERF_FEAT, s=3.0 / NERF_FEAT ** 0.5, dtype=dtype)  # sigma of order 1
    z = torch.sort(torch.rand(n_rays, n_s, generator=g, device=g.device), 1).values
    return ((h, r, wn, t(4, dtype=torch.float32), z), t(n_rays, n_s, dtype=torch.float32),
            t(n_rays, 3, dtype=torch.float32).abs())


def _nerf_point_args(t, n_p, feat, dtype):
    """h, r, wn, bn of the nerf per-point kernels at F = feat, Fh = feat / 2,
    and a (P, 8) cotangent."""
    import torch

    wn = t(4, feat, s=0.1, dtype=dtype)
    wn[0] = t(feat, s=3.0 / feat ** 0.5, dtype=dtype)  # sigma of order 1
    return ((t(n_p, feat, dtype=dtype), t(n_p, feat // 2, dtype=dtype).relu(), wn,
             t(4, dtype=torch.float32)), t(n_p, 8, dtype=torch.float32))


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
        for k, v in a.items():
            out[f"nerf_composite_loss_bwd bfloat16 R={n_rays} S={n_s} {k}"] = v.cpu()
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
        for n_r, n_s, noise in NERF_HEADS_SHAPES:
            args, nz, _ = _nerf_args(td, gd, n_r, n_s, dtype)
            prod, w = FN.nerf_heads_composite(*args, noise=nz if noise else None,
                                              return_weights=True)
            tag = f"nerf_heads_composite {dname} R={n_r} S={n_s} noise={'on' if noise else 'off'}"
            out[f"{tag} products"], out[f"{tag} weights"] = prod.cpu(), w.cpu()
            del args, nz, prod, w
        for n_r, n_s in NERF_LOSS_SHAPES:
            args, nz, gt = _nerf_args(td, gd, n_r, n_s, dtype)
            for k, v in FN.nerf_composite_loss_bwd(*args, nz, gt).items():
                out[f"nerf_composite_loss_bwd {dname} R={n_r} S={n_s} {k}"] = v.cpu()
            del args, nz, gt
        for n_p, feat in NERF_POINT_SHAPES:
            args, cot = _nerf_point_args(td, n_p, feat, dtype)
            out[f"nerf_field_heads {dname} P={n_p} F={feat}"] = FN.nerf_field_heads(
                *args).cpu()
            for k, v in FN.nerf_field_heads_bwd(*args, cot).items():
                out[f"nerf_field_heads_bwd {dname} P={n_p} F={feat} {k}"] = v.cpu()
            del args, cot
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
    if name.startswith(("heads_composite", "nerf_heads_composite")) or (
            name.startswith("nerf_field_heads ")):
        return bool((diff <= tol * b.abs().clamp_min(1.0)).all())
    lim = tol * b.abs().max()
    what, bf16 = name.split()[-1], "bfloat16" in name
    bf16_cot = bf16 and what.startswith("d_")
    if bf16_cot and name.startswith("sc_loss_bwd"):
        lim = lim + 2.0 ** -7 * b.abs()
    if bf16_cot and name.startswith(("field_heads_bwd", "nerf_composite_loss_bwd",
                                     "nerf_field_heads_bwd")):
        lim = lim + 2.0 ** -7 * b.abs()
        if what in ("d_r", "d_skyh"):
            lim = lim + 2.0 ** -8 * b.abs().max()
    if bf16 and name.startswith("nerf_composite_loss_bwd") and what in ("dwn", "dbn"):
        lim = 5e-4 * b.abs().max()
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


# the parent tree's sources `time PARENT_DIR` builds, and the C entries it
# binds from them
PARENT_SOURCES = ("fused_render.cu", "fused_field.cu", "fused_nerf.cu")
PARENT_ENTRIES = ("satnerf_heads_composite", "satnerf_field_heads", "satnerf_field_heads_bwd",
                  "satnerf_nerf_heads_composite", "satnerf_nerf_composite_loss_bwd",
                  "satnerf_nerf_field_heads", "satnerf_nerf_field_heads_bwd")


def _build_libraries(jobs: dict) -> dict:
    """Each job, tag -> (a csrc/ directory, the sources to build of it),
    built as the package builds its sources (all nvcc started together), into
    one library a job under this tree's build directory, PARENT_ENTRIES bound
    by the same signatures (those the library holds). Returns tag -> (CDLL,
    ptxas' report of the registers and spills of each kernel)."""
    import ctypes
    import re

    from satnerf_tpu_torch.ops import _build as B

    procs = {}
    for tag, (csrc, sources) in jobs.items():
        out = os.path.join(B.BUILD_DIR, tag)
        os.makedirs(out, exist_ok=True)
        for src in sources:
            obj = os.path.join(out, src + ".o")
            cmd = [B._nvcc(), *B.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                   os.path.join(csrc, src), "-o", obj]
            procs[(tag, obj)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)
    logs = {}
    for (tag, obj), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {tag}'s sources:\n{log}")
        logs[tag] = logs.get(tag, "") + log
    built = {}
    for tag in jobs:
        out = os.path.join(B.BUILD_DIR, tag)
        lib = os.path.join(out, f"libsatnerf_{tag}.so")
        objs = [o for (t, o) in procs if t == tag]
        subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-shared", "-o", lib, *objs], check=True)
        cdll = ctypes.CDLL(lib)
        for name in PARENT_ENTRIES:
            if hasattr(cdll, name):
                fn = getattr(cdll, name)
                fn.argtypes, fn.restype = B.SIGNATURES[name], ctypes.c_int
        report = {}
        for block in re.split(r"Compiling entry function '", logs[tag])[1:]:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_\d+\w+?_cu_\w{8}\d+", "", block.split("'")[0])
            regs = re.search(r"Used (\d+) registers", block)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            report[name[:60]] = (int(regs.group(1)) if regs else None,
                                 tuple(map(int, spills.groups())) if spills else None)
        built[tag] = (cdll, report)
    return built


def _parent_library(parent_dir: str):
    """parent_dir's PARENT_SOURCES built into a library of their own."""
    csrc = os.path.join(parent_dir, "satnerf_tpu_torch", "csrc")
    return _build_libraries({"parent": (csrc, PARENT_SOURCES)})["parent"][0]


def _event_ms(fn, reps=20):
    """fn's mean time over reps calls after a warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, name, reps=20):
    """The device time a call of the kernels whose name holds `name` (not
    the wrappers' zero fills), and of each such kernel by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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


def time_kernels(parent_dir=None) -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    from satnerf_tpu_torch.ops import _build as B
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.ops import fused_nerf as FN

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

    def report(what, fn, name):
        total, each = _device_ms(fn, name)
        parts = (" (" + ", ".join(f"{k} {v:.4f}" for k, v in each.items()) + ")"
                 if len(each) > 1 else "")
        print(f"{what}: {_event_ms(fn):.4f} ms by events, {total:.4f} ms of the "
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
                got[who].append((_event_ms(fn), _device_ms(fn, name)[0]))
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
    for n_r, n_s, noise in NERF_HEADS_SHAPES:
        args, nz, _ = _nerf_args(td, gd, n_r, n_s, torch.bfloat16)
        nz = nz if noise else None
        weights = not noise  # as the main path calls it: serving asks for them
        what = (f"nerf_heads_composite bf16 R={n_r} S={n_s} noise={'on' if noise else 'off'} "
                f"weights={'on' if weights else 'off'}")
        fn = lambda: FN.nerf_heads_composite(*args, noise=nz, return_weights=weights)  # noqa: E731
        report(what, fn, "nerf_heads")
        if parent is not None:
            paired(what, fn, "nerf_heads")
        del args, nz
    for n_r, n_s in NERF_LOSS_SHAPES:
        args, nz, gt = _nerf_args(td, gd, n_r, n_s, torch.bfloat16)
        what = f"nerf_composite_loss_bwd bf16 R={n_r} S={n_s} noise=on"
        fn = lambda: FN.nerf_composite_loss_bwd(*args, nz, gt)  # noqa: E731
        report(what, fn, "nerf_composite_loss_bwd")
        if parent is not None:
            paired(what, fn, "nerf_composite_loss_bwd")
        del args, nz, gt
    for n_p, feat in NERF_POINT_SHAPES:
        args, cot = _nerf_point_args(td, n_p, feat, torch.bfloat16)
        for what, fn, name in (
                (f"nerf_field_heads bf16 P={n_p} F={feat}",
                 lambda: FN.nerf_field_heads(*args), "nerf_field_heads"),
                (f"nerf_field_heads_bwd bf16 P={n_p} F={feat}",
                 lambda: FN.nerf_field_heads_bwd(*args, cot), "nerf_field_heads_bwd")):
            report(what, fn, name)
            if parent is not None:
                paired(what, fn, name)
        del args, cot
    print(f"clocks (sm, mem), power, temperature at the end: "
          f"{_smi('clocks.sm,clocks.mem,power.draw,temperature.gpu')}", flush=True)


def _variant_csrc(tag: str, consts: str) -> str:
    """A copy of this tree's csrc/ with fused_nerf.cu's constants set as
    `consts` says (NAME:VALUE[,NAME:VALUE]: `constexpr <type> NAME = ...;`,
    which must be there once each); returns the copy's directory."""
    import re
    import shutil

    from satnerf_tpu_torch.ops import _build as B

    dst = os.path.join(B.BUILD_DIR, tag, "csrc")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(B.CSRC_DIR, dst)
    path = os.path.join(dst, "fused_nerf.cu")
    with open(path) as f:
        text = f.read()
    for item in consts.split(","):
        name, value = item.split(":")
        text, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"fused_nerf.cu holds {n} definitions of {name}")
    with open(path, "w") as f:
        f.write(text)
    return dst


def variants(specs) -> None:
    """`variants NAME=CONST:VALUE[,CONST:VALUE] ...`: this tree's
    csrc/fused_nerf.cu built once a spec with constants of its design
    choices set otherwise (NH_IN_FLIGHT, NCL_IN_FLIGHT, NCL_MIN_BLOCKS,
    NCL_PERSISTENT, NCL_ROWS_IN_FLIGHT, NCL_COL_GROUPS, NFH_IN_FLIGHT,
    NFH_MIN_BLOCKS, NFH_WARP_POINTS, NFB_IN_FLIGHT, NFB_MIN_BLOCKS,
    NFB_KEEP_ROWS, or any other `constexpr` of the file) and once as it is,
    ptxas' registers and spills of the two per-ray and the two per-point
    nerf kernels of each, and those four kernels at their shapes in bf16
    through each spec's library and the package's, in turns (package, spec,
    spec, package): events over 20 launches and device time by
    torch.profiler."""
    sys.path.insert(0, os.getcwd())
    import torch

    from satnerf_tpu_torch.ops import _build as B
    from satnerf_tpu_torch.ops import fused_nerf as FN

    if not torch.cuda.is_available():
        raise SystemExit("outputs_torch.py variants runs on a GPU")
    card = _smi("name,power.limit")
    given = dict(spec.split("=", 1) for spec in specs)
    jobs = {"default": (B.CSRC_DIR, ("fused_nerf.cu",))}
    jobs.update({tag: (_variant_csrc(tag, consts), ("fused_nerf.cu",))
                 for tag, consts in given.items()})
    built = _build_libraries(jobs)
    for tag, (_, report) in built.items():
        for kernel, (regs, spills) in report.items():
            if any(k in kernel for k in ("nerf_heads_scan", "nerf_composite_loss_bwd",
                                         "nerf_field_heads")):
                print(f"{tag} {given.get(tag, '')}: {kernel}: {regs} registers, "
                      f"spill stores / loads {spills} bytes", flush=True)
    own = B.load_library
    dev = torch.device("cuda")
    gd = torch.Generator(device=dev).manual_seed(5)
    td = _tensors(gd, dev)

    cases = []
    for n_r, n_s, noise in NERF_HEADS_SHAPES:
        args, nz, _ = _nerf_args(td, gd, n_r, n_s, torch.bfloat16)
        nz = nz if noise else None
        cases.append((f"nerf_heads_composite R={n_r} S={n_s} noise={'on' if noise else 'off'}",
                      "nerf_heads", lambda a=args, n=nz, w=not noise:
                      FN.nerf_heads_composite(*a, noise=n, return_weights=w)))
    for n_r, n_s in NERF_LOSS_SHAPES:
        args, nz, gt = _nerf_args(td, gd, n_r, n_s, torch.bfloat16)
        cases.append((f"nerf_composite_loss_bwd R={n_r} S={n_s} noise=on",
                      "nerf_composite_loss_bwd",
                      lambda a=args, n=nz, g=gt: FN.nerf_composite_loss_bwd(*a, n, g)))
    for n_p, feat in NERF_POINT_SHAPES:
        args, cot = _nerf_point_args(td, n_p, feat, torch.bfloat16)
        cases.append((f"nerf_field_heads P={n_p} F={feat}", "nerf_field_heads",
                      lambda a=args: FN.nerf_field_heads(*a)))
        cases.append((f"nerf_field_heads_bwd P={n_p} F={feat}", "nerf_field_heads_bwd",
                      lambda a=args, c=cot: FN.nerf_field_heads_bwd(*a, c)))
    for what, name, fn in cases:
        for tag, (cdll, _) in built.items():
            if tag == "default":
                continue
            got = {"package": [], tag: []}
            for who in ("package", tag, tag, "package"):
                B.load_library = own if who == "package" else (lambda c=cdll: c)
                try:
                    got[who].append((_event_ms(fn), _device_ms(fn, name)[0]))
                finally:
                    B.load_library = own
            print(f"{what} bf16, in turns: " + "; ".join(
                f"{who} " + ", ".join(f"{e:.4f} by events / {d:.4f} device" for e, d in v)
                for who, v in got.items()) + f" ms on {card}", flush=True)


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
    elif len(sys.argv) >= 3 and sys.argv[1] == "variants":
        variants(sys.argv[2:])
    else:
        raise SystemExit(__doc__)
