"""The fused kernels of the classic NeRF variant: positional encoding, ReLU
trunk, view-direction rgb head (counterpart of
satnerf_tpu/ops/pallas/fused_nerf.py, same public names).

fused_nerf_train_loss_grads — counterpart of fused_nerf.py:653 (K7). Rays,
depths, sigma noise and target colors go in; the MSE and the gradient of
every field parameter come out.

fused_nerf_render_rays — counterpart of fused_nerf.py:464 (K8). Rays and
per-ray depths go in, per-ray products come out: rgb, depth, opacity and, on
request, the (R, S) compositing weights.

fused_nerf_apply — counterpart of fused_nerf.py:740 (K9). The field on points
already expanded, any leading shape: rgb and sigma per point; a
torch.autograd.Function whose backward takes a per-point cotangent to the
field's parameters. Positions and directions get no gradient, as in the JAX
kernel. The plain renderer (render/render.py) runs over it where the nerf
variant trains hierarchically or with depth supervision.

On the card all three are chains of hand-written CUDA kernels
(csrc/fused_nerf.cu), each behind a wrapper here with a plain PyTorch version
beside it:

  nerf_dense               one dense layer, act(X.W + b + enc.C), the
                           positional encoding of the sample point or of the
                           ray's direction computed in-kernel from the rays
  nerf_dense_dgrad         dX (+)= round(dY * [Y > 0]) . W^T, the relu's mask
                           read from the layer's stored output
  nerf_dense_wgrad         dW, db and dC (against the encoding, computed again)
  nerf_heads_composite     sigma head, rgb_1 and the alpha compositor without
                           irradiance and without clip, a block scan over
                           chunks of 256 samples that cross rays
  nerf_composite_loss_bwd  the same forward, the squared error, its adjoint,
                           the compositor adjoint and the narrow heads'
                           backward, a block a ray
  nerf_field_heads         the narrow heads per point, no compositor
  nerf_field_heads_bwd     their backward from a (P, 8) cotangent

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it runs its plain version. There is no fallback from one to the other.
Every launch adds one to ops/fused_mlp.LAUNCHES[name].

nerf_dense has the mainloops of siren_dense (wgmma: the encoding a k tile
computed into shared memory; wmma; simt), nerf_dense_dgrad and
nerf_dense_wgrad those of the SIREN backward (wgmma, wmma, simt);
ops/fused_mlp.dense_mainloop is their rule, `mainloop=` asks for one by hand
and each launch is counted in MAINLOOP_LAUNCHES. On wgmma the wgrad forms dW, dC and db in one launch;
on the others nerf_bias_grad sums db beside it (`nerf_bias_grad_runs`),
counted in LAUNCHES["nerf_bias_grad"].

Precision follows the JAX kernel: matmul operands (weights, activations, the
encoding) in the compute dtype, sums and biases in fp32, each activation
stored in the compute dtype. The backward masks on the stored
post-activations, keeps the cotangents between layers in fp32 and rounds each
to the compute dtype before both of its products. softplus' is formed as
-expm1(-sigma) where the JAX kernel has 1 - exp(-sigma) (fused_nerf.py:236):
the two differ by at most 6e-8 of the cotangent, and only the first keeps a
gradient where sigma is below 1e-8 and a ray's last sample still has weight.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from satnerf_tpu_torch.models.nerf import positional_encoding, rounded_matmul
from satnerf_tpu_torch.ops.fused_mlp import (
    _DTYPE_CODE, _MAINLOOP_CODE, LAUNCHES, SMEM_OPTIN_BYTES,
    WGRAD_STAGE_POINTS, _aligned, _check_cuda, _check_mainloop, _largest_fitting,
    _launch, _ptr, _sm_count, _stream, dense_mainloop, wgrad_split)
from satnerf_tpu_torch.render.composite import ray_weights
from satnerf_tpu_torch.render.render import run_field

RAY_COLS = 8  # o 0:3 | d 3:6 | 0
OUT_COLS = 8  # per ray: rgb 0:3 | depth 3 | opacity 4; per point: rgb 0:3 | sigma 3

_ACT = {"none": 0, "relu": 2}
_ENC = {None: 0, "xyz": 1, "dir": 2}


def _enc_rows(n_freq: int) -> int:
    """Rows of an encoding weight in the kernels' layout: 6 * n_freq, padded
    with zero rows to a multiple of 32 (one tensor-core tile's depth)."""
    return -(-6 * n_freq // 32) * 32


# ------------------------------------------------------------------ nerf_dense


def _encoding(rays8, samples: int, z, enc: str, n_freq: int, rows: int, dtype):
    """Materialized encoding operand (P, rows), rounded to `dtype`, zero from
    column 6 * n_freq on (plain version only: the kernels never hold it)."""
    if enc == "xyz":
        x = rays8[:, None, 0:3] + rays8[:, None, 3:6] * z[:, :, None]
        x = x.reshape(-1, 3)
    else:
        x = rays8[:, 3:6].repeat_interleave(samples, dim=0)
    e = positional_encoding(x, n_freq).to(dtype).float()
    return F.pad(e, (0, rows - e.shape[1]))


def nerf_dense_reference(x, weight, bias, rays8, samples: int, *,
                         enc: Optional[str] = None, enc_weight=None, z=None,
                         n_freq: int = 0, act: str = "relu"):
    """Plain version of nerf_dense: act(x.weight + bias + enc.enc_weight).

    x (P, K) or None for K = 0; weight (K, N); bias (N,) fp32; rays8 (R, 8)
    fp32 [o | d | 0] with P = R * samples; enc in {None, "xyz", "dir"}
    selects the positional encoding of o + d*z (needs z (R, S)) or of d, with
    n_freq frequencies; enc_weight (rows, N), its rows from 6 * n_freq on zero.
    Returns (P, N) in the compute dtype (that of weight, else enc_weight).
    """
    dtype = (weight if weight is not None else enc_weight).dtype
    pre = bias.expand(rays8.shape[0] * samples, -1)
    if x is not None:
        pre = pre + x.float() @ weight.float()
    if enc is not None:
        e = _encoding(rays8, samples, z, enc, n_freq, enc_weight.shape[0], dtype)
        pre = pre + e @ enc_weight.float()
    return (torch.relu(pre) if act == "relu" else pre).to(dtype)


def _check_enc_call(rays8, samples, enc, enc_rows: int, z, n_freq: int):
    """What the dense forward and its wgrad ask of the operands the encoding
    is computed from."""
    if rays8.dtype != torch.float32 or rays8.shape[1] != RAY_COLS:
        raise ValueError("rays8 must be (R, 8) float32")
    if enc not in _ENC:
        raise ValueError(f"enc must be one of {list(_ENC)}, got {enc!r}")
    if enc == "xyz" and (z is None or z.dtype != torch.float32
                         or z.shape != (rays8.shape[0], samples)):
        raise ValueError("enc='xyz' needs z (R, samples) float32")
    if enc is not None and (n_freq < 1 or enc_rows < 6 * n_freq):
        raise ValueError("the encoding's weight needs at least 6 * n_freq rows")
    if rays8.shape[0] * samples >= 2 ** 31:
        raise ValueError("the points exceed the kernel's int32 indexing")


def nerf_dense(x, weight, bias, rays8, samples: int, *,
               enc: Optional[str] = None, enc_weight=None, z=None,
               n_freq: int = 0, act: str = "relu",
               mainloop: Optional[str] = None):
    """One dense layer of the nerf field; arguments as nerf_dense_reference.
    CUDA tensors launch the nerf_dense kernel on the mainloop
    `dense_mainloop` gives (None: the rule; "wmma" / "wgmma" by hand); CPU
    tensors run the plain version."""
    _check_mainloop(mainloop)
    if rays8.device.type == "cpu":
        return nerf_dense_reference(x, weight, bias, rays8, samples, enc=enc,
                                    enc_weight=enc_weight, z=z, n_freq=n_freq,
                                    act=act)
    if x is None and enc is None:
        raise ValueError("a layer without X and without an encoding")
    dtype = (weight if weight is not None else enc_weight).dtype
    _check_cuda(dtype, x=x, weight=weight, bias=bias, rays8=rays8, z=z,
                enc_weight=enc_weight)
    n = bias.shape[0]
    if enc is not None and (enc_weight is None or enc_weight.shape[1] != n):
        raise ValueError("enc_weight must be (rows, N)")
    _check_enc_call(rays8, samples, enc,
                    0 if enc is None else enc_weight.shape[0], z, n_freq)
    if bias.dtype != torch.float32:
        raise ValueError("bias must be float32")
    for name, t in (("x", x), ("weight", weight), ("enc_weight", enc_weight)):
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    p = rays8.shape[0] * samples
    k = 0 if x is None else x.shape[1]
    if x is not None and (x.shape[0] != p or weight.shape != (k, n)):
        raise ValueError(f"x {tuple(x.shape)} / weight {tuple(weight.shape)} "
                         f"do not fit P={p}, N={n}")
    y = torch.empty((p, n), dtype=dtype, device=rays8.device)
    e_rows = 0 if enc is None else enc_weight.shape[0]
    loop = dense_mainloop("nerf_dense", dtype, k, n, e_rows=e_rows,
                          inputs_aligned=_aligned(x, weight, enc_weight),
                          outputs_aligned=_aligned(y), mainloop=mainloop)
    _launch("nerf_dense", _DTYPE_CODE[dtype], _ptr(x), k, _ptr(weight),
            _ptr(bias), _ptr(rays8), _ptr(z), samples, _ENC[enc], n_freq,
            e_rows, _ptr(enc_weight), _ACT[act], _ptr(y), p, n,
            _MAINLOOP_CODE.get(loop, 0), _stream(rays8), mainloop=loop)
    return y


# ------------------------------------------------------------ nerf_dense_dgrad


def _cotangent(dy, y, dtype):
    """(G, round(G)) for G = dy * [y > 0] in fp32 (y None: a linear layer)."""
    g = dy if y is None else dy * (y > 0)
    return g, g.to(dtype).float()


def nerf_dense_dgrad_reference(dy, y, weight, *, out=None):
    """Plain version of nerf_dense_dgrad: round(dy * [y > 0]) @ weight.T.

    dy (P, N) fp32; y (P, N) the layer's output in the compute dtype, whose
    sign is the relu's mask (None for a linear layer); weight (K, N) in the
    compute dtype. Returns dX (P, K) fp32, added onto `out` when given.
    """
    _, gb = _cotangent(dy, y, weight.dtype)
    dx = gb @ weight.float().t()
    return dx if out is None else out.add_(dx)


def nerf_dense_dgrad(dy, y, weight, *, out=None,
                     mainloop: Optional[str] = None):
    """The input cotangent of one dense layer; arguments as
    nerf_dense_dgrad_reference. CUDA tensors launch the kernel on the
    mainloop `dense_mainloop` gives (None: the rule; "wmma" / "wgmma" by
    hand)."""
    _check_mainloop(mainloop)
    if dy.device.type == "cpu":
        return nerf_dense_dgrad_reference(dy, y, weight, out=out)
    dtype = weight.dtype
    _check_cuda(dtype, dy=dy, y=y, weight=weight, out=out)
    p, n = dy.shape
    k = weight.shape[0]
    if dy.dtype != torch.float32 or weight.shape != (k, n):
        raise ValueError("dy must be (P, N) fp32 and weight (K, N)")
    if y is not None and (y.shape != dy.shape or y.dtype != dtype):
        raise ValueError(f"y must match dy, {dtype}")
    if out is not None and (out.shape != (p, k) or out.dtype != torch.float32):
        raise ValueError("out must be (P, K) fp32")
    dx = out if out is not None else torch.empty(
        (p, k), dtype=torch.float32, device=dy.device)
    loop = dense_mainloop("nerf_dense_dgrad", dtype, k, n,
                          inputs_aligned=_aligned(dy, y, weight),
                          outputs_aligned=_aligned(dx), mainloop=mainloop)
    _launch("nerf_dense_dgrad", _DTYPE_CODE[dtype], _ptr(dy), _ptr(y),
            _ptr(weight), _ptr(dx), int(out is not None), p, n, k,
            _MAINLOOP_CODE.get(loop, 0), _stream(dy), mainloop=loop)
    return dx


# ------------------------------------------------------------ nerf_dense_wgrad


def nerf_dense_wgrad_reference(x, dy, y, rays8, samples: int, *,
                               enc: Optional[str] = None, z=None,
                               n_freq: int = 0, enc_rows: int = 0, dtype=None):
    """Plain version of nerf_dense_wgrad, the parameter gradients of
    out = act(x.W + b + enc.C) given its cotangent dy and its stored output.

    x (P, K) in the compute dtype or None (K = 0); dy (P, N) fp32; y (P, N)
    the layer's output (None for a linear layer); rays8, samples, enc, z,
    n_freq as nerf_dense; enc_rows the rows of C; dtype the compute dtype
    (that of x unless given). Returns (dW (K, N) or None, db (N,), dC
    (enc_rows, N) or None), all fp32: dW = x.T @ round(G), db = sum G
    (unrounded), dC = enc.T @ round(G), with G = dy * [y > 0].
    """
    dtype = dtype if dtype is not None else (x if x is not None else y).dtype
    g, gb = _cotangent(dy, y, dtype)
    dw = x.float().t() @ gb if x is not None else None
    dc = None
    if enc is not None:
        dc = _encoding(rays8, samples, z, enc, n_freq, enc_rows, dtype).t() @ gb
    return dw, g.sum(0), dc


def nerf_bias_grad_runs(mainloop: str) -> bool:
    """Whether a nerf_dense_wgrad launch whose GEMM took `mainloop` (as
    dense_mainloop answers) also launches nerf_bias_grad to sum db: on every
    mainloop but wgmma, whose epilogue sums it. The C entry refuses any other
    answer, so LAUNCHES["nerf_bias_grad"], which the wrapper counts from
    this, is what ran."""
    return mainloop != "wgmma"


def nerf_dense_wgrad(x, dy, y, rays8, samples: int, *,
                     enc: Optional[str] = None, z=None, n_freq: int = 0,
                     enc_rows: int = 0, dtype=None,
                     mainloop: Optional[str] = None,
                     split: Optional[int] = None):
    """The parameter gradients of one dense layer; arguments and returns as
    nerf_dense_wgrad_reference. CUDA tensors launch the kernel on the
    mainloop `dense_mainloop` gives (None: the rule; "wmma" / "wgmma" by
    hand) and nerf_bias_grad where `nerf_bias_grad_runs` says. split: points
    a block of the wgmma mainloop (None: ops/fused_mlp.wgrad_split; a
    positive multiple of WGRAD_STAGE_POINTS), for measuring."""
    _check_mainloop(mainloop)
    if dy.device.type == "cpu":
        return nerf_dense_wgrad_reference(x, dy, y, rays8, samples, enc=enc,
                                          z=z, n_freq=n_freq,
                                          enc_rows=enc_rows, dtype=dtype)
    if x is None and enc is None:
        raise ValueError("a layer without X and without an encoding has no "
                         "weights")
    dtype = dtype if dtype is not None else (x if x is not None else y).dtype
    _check_cuda(dtype, x=x, dy=dy, y=y, rays8=rays8, z=z)
    p, n = dy.shape
    k = 0 if x is None else x.shape[1]
    if dy.dtype != torch.float32 or p != rays8.shape[0] * samples:
        raise ValueError("dy must be (R * samples, N) fp32")
    if p > 65535 * 512:  # the kernel splits the points over the grid's z extent
        raise ValueError("nerf_dense_wgrad takes at most 33.5 M points")
    if y is not None and (y.shape != dy.shape or y.dtype != dtype):
        raise ValueError(f"y must match dy, {dtype}")
    if x is not None and (x.shape[0] != p or x.dtype != dtype):
        raise ValueError(f"x must be ({p}, K) {dtype}")
    _check_enc_call(rays8, samples, enc, enc_rows, z, n_freq)
    e_rows = enc_rows if enc is not None else 0
    loop = dense_mainloop("nerf_dense_wgrad", dtype, k, n, e_rows=e_rows,
                          inputs_aligned=_aligned(x, dy, y), mainloop=mainloop)
    bias = nerf_bias_grad_runs(loop)
    if loop != "wgmma":
        split = 0
    elif split is None:
        split = wgrad_split(p, k, n, _sm_count(dy.device.index or 0), e_rows)
    elif split <= 0 or split % WGRAD_STAGE_POINTS:
        raise ValueError(f"split must be a positive multiple of "
                         f"{WGRAD_STAGE_POINTS}, got {split}")

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dy.device)

    dw = zeros(k, n) if x is not None else None
    db = zeros(n)
    dc = zeros(enc_rows, n) if enc is not None else None
    _launch("nerf_dense_wgrad", _DTYPE_CODE[dtype], _ptr(x), k, _ptr(dy),
            _ptr(y), _ptr(rays8), _ptr(z), samples, _ENC[enc], n_freq, e_rows,
            _ptr(dw), _ptr(db), _ptr(dc), p, n, _MAINLOOP_CODE.get(loop, 0),
            split, int(bias), _stream(dy), mainloop=loop)
    if bias:
        LAUNCHES["nerf_bias_grad"] += 1
    return dw, db, dc


# ------------------------------------------------------------ the narrow heads


def _narrow_heads(h, r, wn, bn, rgb_padding: float, dtype=None):
    """Per-point sigma (P,) and padded rgb (P, 3) (plain, differentiable);
    the operands are rounded to `dtype` (that of wn unless given)."""
    fh, dt = r.shape[1], (wn.dtype if dtype is None else dtype)
    sigma = F.softplus(rounded_matmul(h, wn[0:1], dt)[:, 0] + bn[0])
    rgb = torch.sigmoid(rounded_matmul(r, wn[1:4, :fh], dt) + bn[1:4])
    return sigma, rgb * (1 + 2 * rgb_padding) - rgb_padding


def _heads_products(h, r, wn, bn, z, noise, rgb_padding, dtype):
    """((R, 8) products, (R, S) weights) of the narrow heads and the
    compositor without irradiance and clip (plain, differentiable)."""
    n_rays, n_s = z.shape
    sigma, rgb = _narrow_heads(h, r, wn, bn, rgb_padding, dtype=dtype)
    _, _, w = ray_weights(sigma.reshape(n_rays, n_s), z, noise)
    out = torch.cat([
        (w[..., None] * rgb.reshape(n_rays, n_s, 3)).sum(1),
        (w * z).sum(1, keepdim=True), w.sum(1, keepdim=True),
        torch.zeros((n_rays, OUT_COLS - 5), dtype=torch.float32,
                    device=z.device)], dim=1)
    return out, w


def _narrow_adjoint(fn, h, r, wn, bn) -> tuple:
    """Differentiate a scalar of the narrow heads' inputs by autograd.
    fn(hf, rf, wn_l, bn_l) -> (scalar, aux) runs on fp32 leaves. Returns
    ({d_h, d_r, dwn, dbn}, aux); a leaf the scalar does not reach gets zeros."""
    leaves = [h.detach().float().requires_grad_(True),
              r.detach().float().requires_grad_(True),
              wn.detach().float().requires_grad_(True),
              bn.detach().clone().requires_grad_(True)]
    with torch.enable_grad():
        scalar, aux = fn(*leaves)
        grads = torch.autograd.grad(scalar, leaves, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(leaves, grads)]
    return dict(zip(("d_h", "d_r", "dwn", "dbn"), grads)), aux


# the widest trunk (F) and rgb hidden layer (Fh) the nerf heads' kernels
# (per ray and per point, forward and adjoint) hold
NERF_HEADS_MAX_FEATURES = 512
NERF_HEADS_MAX_HIDDEN = 256


def _check_narrow(name, h, r, wn, bn, n_points: int):
    """Shapes and dtypes the per-ray and per-point kernels share; (F, Fh)."""
    dtype = h.dtype
    p, feat = h.shape
    fh = r.shape[1]
    if (feat > NERF_HEADS_MAX_FEATURES or fh > NERF_HEADS_MAX_HIDDEN
            or fh > feat):
        raise ValueError(f"{name} holds at most {NERF_HEADS_MAX_FEATURES} "
                         f"features and {NERF_HEADS_MAX_HIDDEN} hidden")
    if (p != n_points or r.shape[0] != p or wn.shape != (4, feat)
            or bn.shape != (4,) or bn.dtype != torch.float32):
        raise ValueError(f"{name}: inconsistent shapes")
    if r.dtype != dtype or wn.dtype != dtype:
        raise ValueError(f"r and wn must be {dtype}")
    if p * feat >= 2 ** 40:
        raise ValueError(f"{name}: too many points")
    return feat, fh


def nerf_heads_composite_reference(h, r, wn, bn, z, *, noise=None,
                                   rgb_padding: float = 0.001,
                                   return_weights: bool = False):
    """Plain version of nerf_heads_composite.

    h (P, F) the trunk output and r (P, Fh) the rgb hidden layer, in the
    compute dtype; wn (4, F) narrow weights in the compute dtype (rows: sigma,
    rgb_1 x3 over the first Fh columns); bn (4,) fp32; z (R, S) fp32; noise
    (R, S) fp32 added to sigma before the relu, or None. Returns ((R, 8)
    products [rgb | depth | opacity | 0], (R, S) weights or None).
    """
    out, w = _heads_products(h, r, wn, bn, z, noise, rgb_padding, wn.dtype)
    return out, (w if return_weights else None)


def nerf_heads_composite(h, r, wn, bn, z, *, noise=None,
                         rgb_padding: float = 0.001,
                         return_weights: bool = False):
    """Narrow heads + compositing; arguments as
    nerf_heads_composite_reference. CUDA tensors launch the kernel."""
    if z.device.type == "cpu":
        return nerf_heads_composite_reference(
            h, r, wn, bn, z, noise=noise, rgb_padding=rgb_padding,
            return_weights=return_weights)
    dtype = h.dtype
    _check_cuda(dtype, h=h, r=r, wn=wn, bn=bn, z=z, noise=noise)
    n_rays, n_s = z.shape
    feat, fh = _check_narrow("nerf_heads_composite", h, r, wn, bn, n_rays * n_s)
    for what, t in (("z", z), ("noise", noise)):
        if t is not None and (t.dtype != torch.float32 or t.shape != z.shape):
            raise ValueError(f"{what} must be (R, S) fp32")
    out = torch.empty((n_rays, OUT_COLS), dtype=torch.float32, device=z.device)
    weights = (torch.empty((n_rays, n_s), dtype=torch.float32, device=z.device)
               if return_weights else None)
    _launch("nerf_heads_composite", _DTYPE_CODE[dtype], _ptr(h), feat, _ptr(r),
            fh, _ptr(wn), _ptr(bn), _ptr(z), _ptr(noise), n_rays, n_s,
            float(rgb_padding), _ptr(out), _ptr(weights), _stream(z))
    return out, weights


def nerf_composite_loss_bwd_reference(h, r, wn, bn, z, noise, gt, *,
                                      rgb_padding: float = 0.001) -> dict:
    """Plain version of nerf_composite_loss_bwd, by autograd.

    h, r, wn, bn, z, noise as nerf_heads_composite_reference; gt (R, 3) fp32.
    The narrow heads and the compositor run forward; the MSE
    sum |rgb - gt|^2 / (3 R) is differentiated. Returns fp32 tensors:
    loss_sum (1,) the sum of squared errors over the rays, d_h (P, F) the
    sigma head's share of h's cotangent, d_r (P, Fh), dwn (4, F), dbn (4,).
    """
    n_rays = z.shape[0]

    def loss(hf, rf, wn_l, bn_l):
        out, _ = _heads_products(hf, rf, wn_l, bn_l, z, noise, rgb_padding,
                                 wn.dtype)
        sq = ((out[:, 0:3] - gt) ** 2).sum()
        return sq / (3.0 * n_rays), sq.detach().reshape(1)

    res, sq = _narrow_adjoint(loss, h, r, wn, bn)
    res["loss_sum"] = sq
    return res


def _adjoint_buffers(p, feat, fh, dev) -> dict:
    """The fp32 outputs the narrow heads' adjoints write; dwn and dbn
    zero-filled for the kernel's atomics."""
    def f32(*shape, make=torch.empty):
        return make(shape, dtype=torch.float32, device=dev)

    return {"d_h": f32(p, feat), "d_r": f32(p, fh),
            "dwn": f32(4, feat, make=torch.zeros),
            "dbn": f32(4, make=torch.zeros)}


# csrc/fused_nerf.cu ncl_smem_bytes: the block's threads and warps, and the
# block sums' values
_NCL_THREADS, _NCL_WARPS, _NCL_SUMS = 256, 8, 4


def _ncl_smem_bytes(feat: int, fh: int, n_s: int, elem_bytes: int) -> int:
    """The dynamic shared memory a launch of nerf_composite_loss_bwd asks
    for (csrc/fused_nerf.cu ncl_smem_bytes): the four weight rows in the
    compute type and their biases, the scans' scratch, each warp's columns
    of dWn, eight values a sample, and above one chunk of 256 samples the
    transmittance of each."""
    pad8 = lambda v: -(-v // 8) * 8  # noqa: E731
    rows = (pad8(feat) + 3 * pad8(fh)) * elem_bytes + 16
    floats = (_NCL_WARPS * _NCL_SUMS + _NCL_WARPS * (pad8(feat) + 3 * pad8(fh))
              + 8 * n_s + (n_s if n_s > _NCL_THREADS else 0))
    return rows + 4 * floats


def nerf_composite_max_samples(feat: int = 512, fh: int = 256,
                               dtype=torch.float32) -> int:
    """The most samples a ray nerf_composite_loss_bwd takes on the card at a
    trunk of `feat` features, heads of `fh` and operands of `dtype`: the
    largest S whose shared memory fits the 227 KB a block may hold. The
    defaults are the widest the kernel takes, so that limit holds at every
    width (5,172 samples); the nerf 8 x 256 field in bf16 takes 5,848. The
    C entry refuses past it by the same rule."""
    elem = torch.finfo(dtype).bits // 8
    return _largest_fitting(lambda n_s: _ncl_smem_bytes(feat, fh, n_s, elem))


def nerf_composite_loss_bwd(h, r, wn, bn, z, noise, gt, *,
                            rgb_padding: float = 0.001) -> dict:
    """Narrow heads, compositor, MSE and their adjoints; arguments and returns
    as nerf_composite_loss_bwd_reference. CUDA tensors launch the kernel."""
    if z.device.type == "cpu":
        return nerf_composite_loss_bwd_reference(h, r, wn, bn, z, noise, gt,
                                                 rgb_padding=rgb_padding)
    dtype = h.dtype
    _check_cuda(dtype, h=h, r=r, wn=wn, bn=bn, z=z, noise=noise, gt=gt)
    n_rays, n_s = z.shape
    feat, fh = _check_narrow("nerf_composite_loss_bwd", h, r, wn, bn,
                             n_rays * n_s)
    limit = nerf_composite_max_samples(feat, fh, dtype)
    if n_s > limit:
        raise ValueError(
            f"nerf_composite_loss_bwd: {n_s} samples a ray do not fit the "
            f"{SMEM_OPTIN_BYTES} bytes (227 KB) of shared memory a block "
            f"may hold; it takes at most {limit} at F={feat}, Fh={fh}")
    for what, t, shape in (("z", z, z.shape), ("noise", noise, z.shape),
                           ("gt", gt, (n_rays, 3))):
        if t is not None and (t.dtype != torch.float32 or t.shape != shape):
            raise ValueError(f"{what} must be {tuple(shape)} fp32")
    res = _adjoint_buffers(n_rays * n_s, feat, fh, z.device)
    res["loss_sum"] = torch.zeros(1, dtype=torch.float32, device=z.device)
    _launch("nerf_composite_loss_bwd", _DTYPE_CODE[dtype], _ptr(h), feat,
            _ptr(r), fh, _ptr(wn), _ptr(bn), _ptr(z), _ptr(noise), _ptr(gt),
            n_rays, n_s, float(rgb_padding), _ptr(res["loss_sum"]),
            _ptr(res["d_h"]), _ptr(res["d_r"]), _ptr(res["dwn"]),
            _ptr(res["dbn"]), _stream(z))
    return res


def nerf_field_heads_reference(h, r, wn, bn, *, rgb_padding: float = 0.001,
                               dtype=None):
    """Plain version of nerf_field_heads (differentiable): (P, 8) fp32, per
    point rgb 0:3 (padded), sigma 3 (softplus, before noise and relu), zeros
    after. h, r, wn, bn as nerf_heads_composite_reference."""
    sigma, rgb = _narrow_heads(h, r, wn, bn, rgb_padding, dtype=dtype)
    pad = torch.zeros((h.shape[0], OUT_COLS - 4), dtype=torch.float32,
                      device=h.device)
    return torch.cat([rgb, sigma[:, None], pad], dim=1)


def nerf_field_heads(h, r, wn, bn, *, rgb_padding: float = 0.001):
    """The narrow heads per point; arguments and return as
    nerf_field_heads_reference. CUDA tensors launch the kernel."""
    if h.device.type == "cpu":
        return nerf_field_heads_reference(h, r, wn, bn,
                                          rgb_padding=rgb_padding)
    dtype = h.dtype
    _check_cuda(dtype, h=h, r=r, wn=wn, bn=bn)
    p = h.shape[0]
    feat, fh = _check_narrow("nerf_field_heads", h, r, wn, bn, p)
    if p >= 2 ** 31:
        raise ValueError("the points exceed the kernel's int32 indexing")
    out = torch.empty((p, OUT_COLS), dtype=torch.float32, device=h.device)
    _launch("nerf_field_heads", _DTYPE_CODE[dtype], _ptr(h), feat, _ptr(r),
            fh, _ptr(wn), _ptr(bn), p, float(rgb_padding), _ptr(out),
            _stream(h))
    return out


def nerf_field_heads_bwd_reference(h, r, wn, bn, g, *,
                                   rgb_padding: float = 0.001) -> dict:
    """Plain version of nerf_field_heads_bwd, by autograd: the
    vector-Jacobian product of nerf_field_heads_reference with the per-point
    cotangent g (P, 8) fp32. Returns fp32 d_h (P, F), the sigma head's share
    of h's cotangent, d_r (P, Fh), dwn (4, F), dbn (4,)."""
    def contracted(hf, rf, wn_l, bn_l):
        out = nerf_field_heads_reference(hf, rf, wn_l, bn_l,
                                         rgb_padding=rgb_padding,
                                         dtype=wn.dtype)
        return (out * g).sum(), None

    return _narrow_adjoint(contracted, h, r, wn, bn)[0]


def nerf_field_heads_bwd(h, r, wn, bn, g, *,
                         rgb_padding: float = 0.001) -> dict:
    """The narrow heads' backward from a per-point cotangent; arguments and
    returns as nerf_field_heads_bwd_reference. CUDA tensors launch the
    kernel."""
    if h.device.type == "cpu":
        return nerf_field_heads_bwd_reference(h, r, wn, bn, g,
                                              rgb_padding=rgb_padding)
    dtype = h.dtype
    _check_cuda(dtype, h=h, r=r, wn=wn, bn=bn, g=g)
    p = h.shape[0]
    feat, fh = _check_narrow("nerf_field_heads_bwd", h, r, wn, bn, p)
    if g.dtype != torch.float32 or g.shape != (p, OUT_COLS) or p >= 2 ** 31:
        raise ValueError(f"g must be ({p}, {OUT_COLS}) fp32")
    res = _adjoint_buffers(p, feat, fh, h.device)
    _launch("nerf_field_heads_bwd", _DTYPE_CODE[dtype], _ptr(h), feat, _ptr(r),
            fh, _ptr(wn), _ptr(bn), _ptr(g), p, float(rgb_padding),
            _ptr(res["d_h"]), _ptr(res["d_r"]), _ptr(res["dwn"]),
            _ptr(res["dbn"]), _stream(h))
    return res


# ------------------------------------------------------------------ the chains


def pack_rays(rays_o, rays_d):
    """(R, 8) fp32 [o | d | 0], the layout of fused_nerf.py:473."""
    rays8 = torch.zeros((rays_o.shape[0], RAY_COLS), dtype=torch.float32,
                        device=rays_o.device)
    rays8[:, 0:3], rays8[:, 3:6] = rays_o.float(), rays_d.float()
    return rays8


def pack_params(field, *, skip: int, dtype) -> dict:
    """The nerf RadianceField -> kernel operands: (in, out) weights in
    `dtype`, fp32 biases; layer 0 as A over the position encoding, the skip
    layer split into its encoding rows C (first) and its h rows, rgb_0 into
    its feats rows and its direction-encoding rows, each encoding block
    padded with zero rows to a multiple of 32; the narrow heads packed as wn
    (4, F) / bn (4,). Counterpart of fused_nerf.py:67."""
    layers, feat = field.layers, field.feat
    fh = feat // 2
    n_xyz, n_dir = field.mapping_sizes
    e_xyz = 6 * n_xyz

    def k(lin):
        return lin.weight.detach().t().contiguous().to(dtype)

    def b(lin):
        return lin.bias.detach().float().contiguous()

    def pad_rows(w, rows):
        return F.pad(w, (0, 0, 0, rows - w.shape[0])).contiguous()

    fc = [field.fc_net[2 * i] for i in range(layers)]
    p = {"A": pad_rows(k(fc[0]), _enc_rows(n_xyz)), "bt": [b(l) for l in fc],
         "B": [], "C": None}
    for l in range(1, layers):
        w = k(fc[l])
        if l == skip:  # input was cat([enc_xyz, h]): the encoding rows first
            p["C"] = pad_rows(w[:e_xyz], _enc_rows(n_xyz))
            w = w[e_xyz:].contiguous()
        p["B"].append(w)
    p["Wfeat"], p["bfeat"] = k(field.feats_from_xyz), b(field.feats_from_xyz)
    rgb0, rgb1 = field.rgb_from_xyzdir[0], field.rgb_from_xyzdir[2]
    w = k(rgb0)
    p["Wrgb0h"] = w[:feat].contiguous()
    p["Wrgb0d"] = pad_rows(w[feat:], _enc_rows(n_dir))
    p["brgb0"] = b(rgb0)
    dev = fc[0].weight.device
    wn = torch.zeros((4, feat), dtype=torch.float32, device=dev)
    bn = torch.zeros((4,), dtype=torch.float32, device=dev)
    sig = field.sigma_from_xyz[0]
    wn[0], bn[0] = sig.weight.detach()[0], sig.bias.detach()[0]
    wn[1:4, :fh], bn[1:4] = rgb1.weight.detach(), rgb1.bias.detach()
    p["wn"], p["bn"] = wn.to(dtype).contiguous(), bn
    return p


def unpack_grads(g: dict, field, *, skip: int) -> dict:
    """Kernel-layout gradients -> {parameter name: gradient shaped like the
    parameter}, keyed as field.named_parameters(). Undoes every split and
    padding of pack_params."""
    fh = field.feat // 2
    e_xyz, e_dir = (6 * n for n in field.mapping_sizes)
    out = {}

    def put(name, kernel_w, bias):  # (in, out) -> Linear.weight (out, in)
        out[f"{name}.weight"] = kernel_w.t().contiguous()
        out[f"{name}.bias"] = bias

    put("fc_net.0", g["A"][:e_xyz], g["bt"][0])
    for l in range(1, field.layers):
        w = g["B"][l - 1]
        if l == skip:
            w = torch.cat([g["C"][:e_xyz], w], dim=0)
        put(f"fc_net.{2 * l}", w, g["bt"][l])
    wn, bn = g["wn"], g["bn"]
    out["sigma_from_xyz.0.weight"], out["sigma_from_xyz.0.bias"] = wn[0:1], bn[0:1]
    put("feats_from_xyz", g["Wfeat"], g["bfeat"])
    put("rgb_from_xyzdir.0", torch.cat([g["Wrgb0h"], g["Wrgb0d"][:e_dir]], dim=0),
        g["brgb0"])
    out["rgb_from_xyzdir.2.weight"], out["rgb_from_xyzdir.2.bias"] = wn[1:4, :fh], bn[1:4]
    return out


class NerfOps:
    """The stage functions the chains run. A check swaps in its own to see
    each launch's inputs."""

    dense = staticmethod(nerf_dense)
    heads = staticmethod(nerf_heads_composite)
    composite = staticmethod(nerf_composite_loss_bwd)
    field_heads = staticmethod(nerf_field_heads)
    field_heads_bwd = staticmethod(nerf_field_heads_bwd)
    dgrad = staticmethod(nerf_dense_dgrad)
    wgrad = staticmethod(nerf_dense_wgrad)


def _chain_forward(p: dict, rays8, z, *, skip: int, n_freq: tuple,
                   keep: bool, ops=NerfOps) -> dict:
    """The field's ten dense launches: trunk (layer 0 over the position
    encoding alone, the skip layer with it as a second operand), feats, rgb_0
    (with the direction encoding). p: pack_params output; n_freq =
    (n_freq_xyz, n_freq_dir). Returns {"hs": the trunk's outputs (all with
    `keep`, what the backward needs; else only the last), "feats", "r"}."""
    n_s = z.shape[1]
    n_xyz, n_dir = n_freq

    def dense(x, w, bias, enc=None, ew=None, n=0, act="relu"):
        return ops.dense(x, w, bias, rays8, n_s, enc=enc, enc_weight=ew, z=z,
                         n_freq=n, act=act)

    hs = [dense(None, None, p["bt"][0], "xyz", p["A"], n_xyz)]
    for l, w in enumerate(p["B"], start=1):
        h = (dense(hs[-1], w, p["bt"][l], "xyz", p["C"], n_xyz) if l == skip
             else dense(hs[-1], w, p["bt"][l]))
        if keep:
            hs.append(h)
        else:
            hs = [h]
    feats = dense(hs[-1], p["Wfeat"], p["bfeat"], act="none")
    r = dense(feats, p["Wrgb0h"], p["brgb0"], "dir", p["Wrgb0d"], n_dir)
    return {"hs": hs, "feats": feats if keep else None, "r": r}


def _chain_backward(p: dict, a: dict, cot: dict, rays8, z, *, skip: int,
                    n_freq: tuple, ops=NerfOps) -> dict:
    """Nine dgrad and ten wgrad launches, the order of fused_nerf.py
    _point_bwd_from_saves :216-254. a: `_chain_forward`'s output with `keep`;
    cot: the per-ray or per-point stage's d_h, d_r, dwn, dbn, each fp32 in its
    own buffers (d_h is accumulated onto). Returns g in the layout of p."""
    n_s = z.shape[1]
    n_xyz, n_dir = n_freq
    dtype = p["wn"].dtype
    hs, feats, r = a["hs"], a["feats"], a["r"]
    g = {"wn": cot["dwn"], "bn": cot["dbn"], "B": [None] * len(p["B"]),
         "bt": [None] * len(p["bt"]), "C": None}

    def wgrad(x, dy, y, enc=None, n=0, rows=0):
        return ops.wgrad(x, dy, y, rays8, n_s, enc=enc, z=z, n_freq=n,
                         enc_rows=rows, dtype=dtype)

    g["Wrgb0h"], g["brgb0"], g["Wrgb0d"] = wgrad(
        feats, cot["d_r"], r, "dir", n_dir, p["Wrgb0d"].shape[0])
    d_feats = ops.dgrad(cot["d_r"], r, p["Wrgb0h"])
    # feats and sigma meet in the trunk output
    g["Wfeat"], g["bfeat"], _ = wgrad(hs[-1], d_feats, None)
    d_h = ops.dgrad(d_feats, None, p["Wfeat"], out=cot["d_h"])
    for l in range(len(p["B"]), 0, -1):
        if l == skip:
            g["B"][l - 1], g["bt"][l], g["C"] = wgrad(
                hs[l - 1], d_h, hs[l], "xyz", n_xyz, p["C"].shape[0])
        else:
            g["B"][l - 1], g["bt"][l], _ = wgrad(hs[l - 1], d_h, hs[l])
        d_h = ops.dgrad(d_h, hs[l], p["B"][l - 1])
    _, g["bt"][0], g["A"] = wgrad(None, d_h, hs[0], "xyz", n_xyz,
                                  p["A"].shape[0])
    return g


def _render_staged(p: dict, rays8, z, *, skip: int, n_freq: tuple,
                   rgb_padding: float, return_weights: bool, ops=NerfOps):
    """The serving chain (K8): ten dense launches, nerf_heads_composite.
    Returns ((R, 8) products, (R, S) weights or None)."""
    a = _chain_forward(p, rays8, z, skip=skip, n_freq=n_freq, keep=False,
                       ops=ops)
    return ops.heads(a["hs"][-1], a["r"], p["wn"], p["bn"], z,
                     rgb_padding=rgb_padding, return_weights=return_weights)


def _train_staged(p: dict, rays8, z, noise, gt, *, skip: int, n_freq: tuple,
                  rgb_padding: float, ops=NerfOps):
    """The chain of one training step (K7): the forward with every trunk
    output kept, nerf_composite_loss_bwd, the backward. Returns (loss_sum
    (1,), g) with g the gradients in the layout of p (fp32)."""
    a = _chain_forward(p, rays8, z, skip=skip, n_freq=n_freq, keep=True,
                       ops=ops)
    out = ops.composite(a["hs"][-1], a["r"], p["wn"], p["bn"], z, noise, gt,
                        rgb_padding=rgb_padding)
    g = _chain_backward(p, a, out, rays8, z, skip=skip, n_freq=n_freq, ops=ops)
    return out["loss_sum"], g


def _check_field(field, layers, feat, skip, n_freq_xyz, n_freq_dir,
                 rgb_padding):
    got = (field.layers, field.feat, field.skips, field.mapping_sizes,
           field.mapping and field.use_view_dirs and not field.siren
           and not field.use_shadow and not field.use_beta, field.rgb_padding)
    want = (layers, feat, (skip,), (n_freq_xyz, n_freq_dir), True, rgb_padding)
    if got != want:
        raise ValueError(f"field (layers, feat, skips, mapping_sizes, nerf "
                         f"variant, rgb_padding) = {got} does not match {want}")


def _check_card_call(name, field, ref, layers, feat, skip, n_freq_xyz,
                     n_freq_dir, rgb_padding):
    """What every kernel chain asks of its caller before it packs anything."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {ref.device}")
    _check_field(field, layers, feat, skip, n_freq_xyz, n_freq_dir,
                 rgb_padding)


# ====================================================== K8, the serving render


def _products(out, weights) -> dict:
    res = {"rgb": out[:, 0:3], "depth": out[:, 3], "opacity": out[:, 4]}
    if weights is not None:
        res["weights"] = weights
    return res


def fused_nerf_render_rays_reference(params, rays_o, rays_d, z_vals, *,
                                     layers: int = 8, feat: int = 256,
                                     skip: int = 4, n_freq_xyz: int = 10,
                                     n_freq_dir: int = 4,
                                     rgb_padding: float = 0.001,
                                     dtype=torch.bfloat16,
                                     return_weights: bool = False,
                                     noise=None) -> dict:
    """Plain version of fused_nerf_render_rays: the field module on o + d*z
    with the ray's direction as its view direction, then render/composite.py
    (with the sigma noise, when given). Differentiable where the caller lets
    autograd record."""
    _check_field(params, layers, feat, skip, n_freq_xyz, n_freq_dir,
                 rgb_padding)
    res = run_field(params, rays_o, rays_d, rays_d, None, None, z_vals,
                    shadow=False, dtype=dtype, noise=noise)
    out = {"rgb": res["rgb"], "depth": res["depth"],
           "opacity": res["weights"].sum(-1)}
    if return_weights:
        out["weights"] = res["weights"]
    return out


def fused_nerf_render_rays(params, rays_o, rays_d, z_vals, *, layers: int = 8,
                           feat: int = 256, skip: int = 4,
                           n_freq_xyz: int = 10, n_freq_dir: int = 4,
                           rgb_padding: float = 0.001, dtype=torch.bfloat16,
                           return_weights: bool = False) -> dict:
    """Serving path of the nerf variant: render rays to per-ray products.

    params: the nerf RadianceField. rays_o, rays_d (R, 3); z_vals (R, S).
    Returns {"rgb": (R, 3), "depth": (R,), "opacity": (R,)} plus "weights"
    (R, S) when return_weights — the same dict as the JAX kernel.

    On CUDA tensors this launches the nerf_dense / nerf_heads_composite chain
    under torch.inference_mode(): its outputs carry no grad_fn. On CPU tensors
    it runs fused_nerf_render_rays_reference.
    """
    kw = dict(layers=layers, feat=feat, skip=skip, n_freq_xyz=n_freq_xyz,
              n_freq_dir=n_freq_dir, rgb_padding=rgb_padding, dtype=dtype,
              return_weights=return_weights)
    if z_vals.device.type == "cpu":
        return fused_nerf_render_rays_reference(params, rays_o, rays_d, z_vals,
                                                **kw)
    _check_card_call("fused_nerf_render_rays", params, z_vals, layers, feat,
                     skip, n_freq_xyz, n_freq_dir, rgb_padding)
    with torch.inference_mode():
        out, weights = _render_staged(
            pack_params(params, skip=skip, dtype=dtype),
            pack_rays(rays_o, rays_d), z_vals.float().contiguous(), skip=skip,
            n_freq=(n_freq_xyz, n_freq_dir), rgb_padding=rgb_padding,
            return_weights=return_weights)
    return _products(out, weights)


# ======================================================= K7, the training step


def fused_nerf_train_loss_grads_reference(params, rays_o, rays_d, z_vals,
                                          noise, gt_rgb, *, layers: int = 8,
                                          feat: int = 256, skip: int = 4,
                                          n_freq_xyz: int = 10,
                                          n_freq_dir: int = 4,
                                          rgb_padding: float = 0.001,
                                          dtype=torch.bfloat16):
    """Plain version of fused_nerf_train_loss_grads: the field module on
    o + d*z, render/composite.py, the MSE and torch.autograd.grad. The field's
    matmuls round their operands, and in the backward their cotangents, to
    `dtype` where the JAX kernel does (models/nerf.py rounded_matmul)."""
    _check_field(params, layers, feat, skip, n_freq_xyz, n_freq_dir,
                 rgb_padding)
    leaves = list(params.parameters())
    with torch.enable_grad():
        d = rays_d.float()
        res = run_field(params, rays_o.float(), d, d, None, None,
                        z_vals.float(), shadow=False, dtype=dtype, noise=noise)
        mse = torch.mean((res["rgb"] - gt_rgb.float()) ** 2)
        grads = torch.autograd.grad(mse, leaves, allow_unused=True)
    param_grads = {n: (torch.zeros_like(q) if g is None else g)
                   for (n, q), g in zip(params.named_parameters(), grads)}
    return mse.detach(), param_grads


def fused_nerf_train_loss_grads(params, rays_o, rays_d, z_vals, noise, gt_rgb,
                                *, layers: int = 8, feat: int = 256,
                                skip: int = 4, n_freq_xyz: int = 10,
                                n_freq_dir: int = 4,
                                rgb_padding: float = 0.001,
                                dtype=torch.bfloat16):
    """Training path of the nerf variant: the primary pass' loss and
    gradients.

    params: the nerf RadianceField. rays_o, rays_d (R, 3); z_vals (R, S);
    noise (R, S) sigma noise or None; gt_rgb (R, 3). Returns (mse,
    param_grads): the scalar mean squared error over the R * 3 colors and its
    gradient keyed as params.named_parameters().

    On CUDA tensors this launches the kernel chain `_train_staged`; nothing in
    it goes through autograd, and the weights are packed anew from `params`
    on every call. On CPU tensors it runs
    fused_nerf_train_loss_grads_reference.
    """
    kw = dict(layers=layers, feat=feat, skip=skip, n_freq_xyz=n_freq_xyz,
              n_freq_dir=n_freq_dir, rgb_padding=rgb_padding, dtype=dtype)
    if z_vals.device.type == "cpu":
        return fused_nerf_train_loss_grads_reference(
            params, rays_o, rays_d, z_vals, noise, gt_rgb, **kw)
    _check_card_call("fused_nerf_train_loss_grads", params, z_vals, layers,
                     feat, skip, n_freq_xyz, n_freq_dir, rgb_padding)
    with torch.no_grad():
        sq, g = _train_staged(
            pack_params(params, skip=skip, dtype=dtype),
            pack_rays(rays_o, rays_d), z_vals.float().contiguous(),
            None if noise is None else noise.float().contiguous(),
            gt_rgb.float().contiguous(), skip=skip,
            n_freq=(n_freq_xyz, n_freq_dir), rgb_padding=rgb_padding)
        mse = sq[0] / (3.0 * z_vals.shape[0])
        param_grads = unpack_grads(g, params, skip=skip)
    return mse, param_grads


# ================================================== K9, the field on points
#
# fused_nerf_apply: forward = the dense chain and nerf_field_heads; backward =
# nerf_field_heads_bwd and the training chain's backward, on points that are
# their own rays: samples = 1, rays8 = [xyz | dir | 0] and z = 0, so the
# encoded position o + d*z is xyz.


class _NerfApply(torch.autograd.Function):
    """(points, directions, the field's parameters) -> (P, 8) per-point
    outputs on the card. When a graph is recorded the forward keeps the
    chain's activations on the node (the compute dtype's 2 or 4 bytes for each
    of 8 F + F + F/2 values a point: no fp32 slope is saved) and the backward
    frees them; under no_grad or inference_mode (cfg["record"] False: the
    caller's grad mode, which the forward itself never sees) it saves
    nothing."""

    @staticmethod
    def forward(ctx, field, cfg: dict, xyz, view_dir, *weights):
        skip, n_freq = cfg["skip"], cfg["n_freq"]
        rays8 = pack_rays(xyz, view_dir)
        z = torch.zeros((xyz.shape[0], 1), dtype=torch.float32,
                        device=xyz.device)
        packed = pack_params(field, skip=skip, dtype=cfg["dtype"])
        keep = cfg.get("record", True) and any(ctx.needs_input_grad)
        a = _chain_forward(packed, rays8, z, skip=skip, n_freq=n_freq,
                           keep=keep)
        out = nerf_field_heads(a["hs"][-1], a["r"], packed["wn"], packed["bn"],
                               rgb_padding=cfg["rgb_padding"])
        if keep:
            ctx.field, ctx.cfg = field, cfg
            ctx.chain = (packed, rays8, z, a)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        packed, rays8, z, a = ctx.chain
        ctx.chain = None  # the activations go as soon as the backward has read them
        cfg = ctx.cfg
        cot = nerf_field_heads_bwd(a["hs"][-1], a["r"], packed["wn"],
                                   packed["bn"], g.float().contiguous(),
                                   rgb_padding=cfg["rgb_padding"])
        gk = _chain_backward(packed, a, cot, rays8, z, skip=cfg["skip"],
                             n_freq=cfg["n_freq"])
        grads = unpack_grads(gk, ctx.field, skip=cfg["skip"])
        return (None,) * 4 + tuple(
            grads[n] for n, _ in ctx.field.named_parameters())


def fused_nerf_apply_reference(params, xyz, view_dir, *, layers: int = 8,
                               feat: int = 256, skip: int = 4,
                               n_freq_xyz: int = 10, n_freq_dir: int = 4,
                               rgb_padding: float = 0.001,
                               dtype=torch.bfloat16) -> dict:
    """Plain version of fused_nerf_apply: the field module on the points,
    left to plain autograd; view_dir None means zero directions (whose
    encoding is not zero: cos 0 = 1), as fused_nerf.py:747-748."""
    _check_field(params, layers, feat, skip, n_freq_xyz, n_freq_dir,
                 rgb_padding)
    if view_dir is None:
        view_dir = torch.zeros_like(xyz)
    return params(xyz, view_dir=view_dir, dtype=dtype)


def fused_nerf_apply(params, xyz, view_dir, *, layers: int = 8,
                     feat: int = 256, skip: int = 4, n_freq_xyz: int = 10,
                     n_freq_dir: int = 4, rgb_padding: float = 0.001,
                     dtype=torch.bfloat16) -> dict:
    """The nerf field on points, in place of the field module's forward.

    params: the nerf RadianceField. xyz and view_dir (..., 3) with any
    leading shape; view_dir None means zero directions. Returns {"rgb"
    (..., 3), "sigma" (...)}. Gradients flow to the parameters; xyz and
    view_dir get none, as in the JAX kernel.

    On CUDA tensors forward and backward are kernel chains (`_NerfApply`);
    on CPU tensors it runs fused_nerf_apply_reference.
    """
    kw = dict(layers=layers, feat=feat, skip=skip, n_freq_xyz=n_freq_xyz,
              n_freq_dir=n_freq_dir, rgb_padding=rgb_padding, dtype=dtype)
    if xyz.device.type == "cpu":
        return fused_nerf_apply_reference(params, xyz, view_dir, **kw)
    _check_card_call("fused_nerf_apply", params, xyz, layers, feat, skip,
                     n_freq_xyz, n_freq_dir, rgb_padding)
    lead = tuple(xyz.shape[:-1])
    pts = xyz.detach().reshape(-1, 3)
    dirs = (torch.zeros_like(pts) if view_dir is None
            else view_dir.detach().reshape(-1, 3))
    cfg = dict(skip=skip, n_freq=(n_freq_xyz, n_freq_dir),
               rgb_padding=rgb_padding, dtype=dtype,
               record=torch.is_grad_enabled())
    out = _NerfApply.apply(params, cfg, pts, dirs, *params.parameters())
    return {"rgb": out[:, 0:3].reshape(*lead, 3),
            "sigma": out[:, 3].reshape(*lead)}
