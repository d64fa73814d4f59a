#!/usr/bin/env python3
"""Outputs of the port's kernels that a change must leave unchanged to the
bit, saved from one tree and compared with another's, on the card.

  python3 tools/outputs_torch.py save OUT.pt      (from a tree's root)
  python3 tools/outputs_torch.py compare A.pt B.pt

`save` runs, on seeded inputs: composite_loss_bwd and composite_bwd on both
bodies at 64 and 256 samples a ray (the per-sample cotangents and the
weights: no atomics), nerf_composite_loss_bwd (d_h, d_r), siren_dense at
K = 0 (layer 0 with its slope, sky_0), the skip layer's wgrad dW and db
with every point in one block's range (the fp32 atomics across ranges add
in another order each run), and a dgrad's dX. It imports the package of the
directory it runs from, so the same file saves from two checkouts.
`compare` prints how many are equal to the bit and the largest difference
of each that is not, and exits nonzero if any differs.
"""

import os
import sys


def save(path: str) -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.ops import fused_nerf as FN

    if not torch.cuda.is_available():
        raise SystemExit("outputs_torch.py save runs on a GPU")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def t(*shape, s=1.0, dtype=torch.bfloat16):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * s).to(dev, dtype)

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
    torch.cuda.synchronize()
    torch.save(out, path)
    print(f"saved {len(out)} outputs to {path}")


def compare(path_a: str, path_b: str) -> None:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    if set(a) != set(b):
        raise SystemExit(f"the two files hold other outputs: {set(a) ^ set(b)}")
    diff = {k: (a[k].float() - b[k].float()).abs().max().item()
            for k in a if not torch.equal(a[k], b[k])}
    print(f"equal to the bit: {len(a) - len(diff)} of {len(a)}; differing: {diff}")
    if diff:
        sys.exit(1)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        save(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(__doc__)
