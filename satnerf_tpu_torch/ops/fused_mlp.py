"""The fused kernels of the SIREN variants: serving render, training step,
solar-correction pass, differentiable training render and the per-sample
field in ray and in point mode.

fused_render_rays — counterpart of satnerf_tpu/ops/pallas/fused_mlp.py:1066
(K2). Rays and per-ray depths go in, per-ray products come out: rgb, depth,
sun, sky, albedo, opacity, beta (sat-nerf) and, on request, the (R, S)
compositing weights.

fused_train_loss_grads — counterpart of fused_mlp.py:1804 (K1). Rays, depths,
sigma noise and target colors go in; the loss parts, the gradient of every
field parameter, the per-ray gradient of the transient embedding and, on
request, the compositing weights come out.

fused_sc_loss_grads — counterpart of fused_mlp.py:1719 (K3). Ray origins, sun
directions, depths and sigma noise go in; terms 2 and 3 of the S-NeRF
solar-correction loss and their gradient come out. The field is marched along
the sun direction; transparency and weights carry no gradient, so the
gradient reaches the weights through the sun-visibility head only.

fused_train_render_rays — counterpart of fused_mlp.py:1472 (K4). The serving
render with sigma noise, differentiable with respect to the field's
parameters and the transient embedding: a torch.autograd.Function whose
forward and backward are both kernel chains. The depth-supervision pass
renders its key-point rays through it.

fused_field_apply_rays — counterpart of fused_mlp.py:1152 (K5). Rays and
per-ray depths go in, the field's outputs at every sample come out (rgb,
sigma, sun_v, sky_rgb, beta), uncomposited; a torch.autograd.Function whose
backward takes a per-sample cotangent to the field's parameters and the
transient embedding. The plain renderer (render/render.py) runs over it in
the hierarchical depth-supervision pass.

fused_field_apply — counterpart of fused_mlp.py:799 (K6). The same field on
points already expanded, any leading shape; its backward also returns the
cotangent of xyz, sun_dir and t_embed. `--fused on` runs the trainer and the
server over it.

On the card all six are chains of hand-written CUDA kernels (csrc/), each
behind a wrapper here with a plain PyTorch version beside it:

  siren_dense         one dense layer, act(w0 * (X.W + b + E.C)), with the
                      small E operand (xyz, sun_dir or t) built from the rays
                      in-kernel; in training it also saves the sine's slope
  heads_composite     the narrow heads and the alpha compositor, a warp per
                      ray (serving; with sigma noise, K4's forward)
  composite_loss_bwd  narrow heads, compositor, loss and all their adjoints,
                      a block per ray: the samples side by side, the
                      transmittance and its adjoint as block scans (training;
                      `body="warp"` runs the earlier walk of a warp a ray)
  composite_bwd       the same from a given (R, 16) cotangent of the per-ray
                      products (K4's backward)
  sc_loss_bwd         sigma and sun_v heads, compositor forward, terms 2 and
                      3 and the sun_v head's adjoint, a warp per ray (K3)
  siren_dense_dgrad   dX (+)= (dY * slope) . W^T
  siren_dense_wgrad   dW, db, dC of one layer, and on request the gradient
                      of the E operand itself (t_grad for beta_0; xyz and
                      sun_dir too in point mode): a GEMM for dW (on wgmma
                      with db and dC in its epilogue) and, where it has
                      work, narrow_grads for db, dC and dE
  narrow_grads        the narrow gradients of one or more layers in one
                      launch, a block a range of whole rays (the chains join
                      sky_0's with beta_0's t_grad)
  field_heads         the narrow heads with their activations, per sample,
                      no compositor (K5 / K6 forward)
  field_heads_bwd     their backward from a (P, 16) cotangent (K5 / K6)

`_render_staged`, `_train_staged`, `_sc_staged`, `_field_staged` and the two
halves of `_TrainRender` and of `_FieldApply` chain them; the training chains
share one forward (`_chain_forward`) and one backward (`_chain_backward`). A wrapper given a CUDA
tensor launches its kernel or raises; given a CPU tensor it runs its plain
version. There is no fallback from one to the other. Every launch adds one
to LAUNCHES[name].

siren_dense, siren_dense_dgrad and siren_dense_wgrad (and the nerf
variant's nerf_dense_dgrad and nerf_dense_wgrad, ops/fused_nerf.py) each
have more than one mainloop on the card: wgmma (Hopper: TMA-fed
shared-memory stages, warpgroup products), wmma (warp-level tensor-core
fragments), simt (fp32 FMAs), and for siren_dense and the wgrad with K = 0
no GEMM ("k0": the elementwise kernel, narrow_grads alone). `dense_mainloop`
is the rule that picks one, the same rule as their C entries;
`mainloop="wmma"` or `"wgmma"` asks for one by hand (tests, chip_smoke.py)
and raises where it cannot run. Every launch of the five also adds one to
MAINLOOP_LAUNCHES[(name, mainloop)]. The wgrad's wgmma mainloop sums the
bias gradient and the E operand's dC in its epilogue, so narrow_grads runs
only where there is no GEMM, for dE, and beside wmma / simt
(`small_grads_mode`); each launch adds one to LAUNCHES["narrow_grads"].
`narrow="walk"` on the wgrad runs the column walk small_grads it replaced,
launched by the wgrad's C entry and counted in LAUNCHES["small_grads"].
At K = 0 siren_dense runs its elementwise kernel ("k0"), or the first one
it replaced with `mainloop="k0_v1"`, counted in MAINLOOP_LAUNCHES.

Weights follow the JAX kernel's precision split: matmul operands (weights,
activations, the E operand) in the compute dtype, sums and biases in fp32,
each activation stored in the compute dtype, as `_trunk_fwd` and
`_narrow_fwd` round them (fused_mlp.py:278,287,302). The backward keeps what
the JAX kernel keeps in fp32 — the slopes w0*cos(w0*pre), the cotangents
between layers, the weight-gradient sums — and rounds each cotangent to the
compute dtype before both of its products (fused_mlp.py:509-516).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from satnerf_tpu_torch.models.nerf import rounded_matmul
from satnerf_tpu_torch.render.composite import composite, ray_weights
from satnerf_tpu_torch.render.render import run_field
from satnerf_tpu_torch.train import losses as L

OUT_COLS = 16  # rgb 0:3 | depth 3 | sun 4 | sky 5:8 | beta 8 | albedo 9:12 | opacity 12
FIELD_COLS = 16  # per sample: rgb 0:3 | sigma 3 | sun_v 4 | sky 5:8 | beta 8
RAY_COLS = 16  # o 0:3 | d 3:6 | sun 6:9 | t 9:9+tau

# one count a kernel wrapper, those of the nerf variant (ops/fused_nerf.py) too
LAUNCHES = {"siren_dense": 0, "heads_composite": 0, "composite_loss_bwd": 0,
            "siren_dense_dgrad": 0, "siren_dense_wgrad": 0, "sc_loss_bwd": 0,
            "composite_bwd": 0, "field_heads": 0, "field_heads_bwd": 0,
            "nerf_dense": 0, "nerf_dense_dgrad": 0, "nerf_dense_wgrad": 0,
            "nerf_heads_composite": 0, "nerf_composite_loss_bwd": 0,
            "nerf_field_heads": 0, "nerf_field_heads_bwd": 0,
            # the narrow gradients (db, dC, dE): narrow_grads, launched by
            # siren_dense_wgrad's wrapper or a chain's joined launch, and the
            # column walk small_grads, by the wgrad's C entry on request
            "narrow_grads": 0, "small_grads": 0,
            # launched by nerf_dense_wgrad's wrapper where its GEMM does not
            # sum db (every mainloop but wgmma)
            "nerf_bias_grad": 0}

_ACT = {"none": 0, "sin": 1, "relu": 2}
_EXTRA = {None: (0, 0), "xyz": (1, 0), "sun": (2, 6), "t": (2, 9)}  # mode, column
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# (kernel, mainloop) -> launches, for the kernels of MAINLOOP_KERNELS
MAINLOOP_LAUNCHES: dict = {}
MAINLOOPS = ("wmma", "wgmma")  # the tensor-core mainloops `mainloop=` may ask for
# and at K = 0 (siren_dense): "k0" (the rule) or its first elementwise
# kernel, "k0_v1", kept to compare; None: the rule
K0_MAINLOOPS = ("k0", "k0_v1")
MAINLOOP_KERNELS = ("siren_dense", "siren_dense_dgrad", "siren_dense_wgrad",
                    "nerf_dense", "nerf_dense_dgrad", "nerf_dense_wgrad")
# The kernels whose simt mainloop (the rule's in fp32) is the pipelined SIMT
# GEMM of csrc/simt_gemm.cuh; siren_dense_wgrad and nerf_dense keep their
# first SIMT body (wgrad_simt, nerf_dense_simt)
SGEMM_KERNELS = ("siren_dense", "siren_dense_dgrad", "nerf_dense_dgrad",
                 "nerf_dense_wgrad")
# csrc/common.cuh MAINLOOP_*; 0: the rule
_MAINLOOP_CODE = {"wmma": 1, "wgmma": 2, "k0": 0, "k0_v1": 3}
DENSE_WGMMA_MAX_K = 512  # csrc/fused_render.cu FWD_MAX_K, fused_nerf.cu NDW_MAX_K

# The two bodies of composite_loss_bwd and composite_bwd (`body=`): a block
# a ray, the default, or the earlier walk of a warp a ray, kept to compare;
# (kernel, body) -> launches
COMPOSITE_BODIES = ("block", "warp")
_BODY_CODE = {"block": 0, "warp": 1}  # csrc/fused_train.cu BODY_*
BODY_LAUNCHES: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    MAINLOOP_LAUNCHES.clear()
    BODY_LAUNCHES.clear()


def _check_mainloop(mainloop) -> None:
    if mainloop is not None and mainloop not in MAINLOOPS + K0_MAINLOOPS:
        raise ValueError(f"mainloop must be None or one of "
                         f"{MAINLOOPS + K0_MAINLOOPS}, got {mainloop!r}")


def dense_mainloop(kernel: str, dtype: torch.dtype, k: int, n: int, *,
                   inputs_aligned: bool = True, outputs_aligned: bool = True,
                   e_rows: int = 0, mainloop: Optional[str] = None) -> str:
    """The mainloop a launch of siren_dense, siren_dense_dgrad,
    siren_dense_wgrad, nerf_dense, nerf_dense_dgrad or nerf_dense_wgrad takes
    on the card: the rule of their C entries (csrc/fused_render.cu,
    csrc/fused_train.cu, csrc/fused_nerf.cu), which the wrappers call to
    build what they pass.

    siren_dense and nerf_dense: k = K (0 for layer 0 and sky_0), n = N; the
    inputs are X and W (nerf_dense: and the encoding's weight C), the outputs
    Y and the saved slope. The dgrads: k = K (dX's columns), n = N (the
    reduction); the inputs are dY, the slope or the relu's mask Y, and W, the
    output dX. The wgrads: k = K (0 for layer 0, and sky_0), n = N; the
    inputs are X, dY and the slope or mask, the outputs (allocated by the
    wrapper) are always aligned. e_rows (nerf_dense and nerf_dense_wgrad) =
    the rows of the encoding weight (0: none). `*_aligned`: every such
    pointer is a multiple of 16 bytes.

      k0     siren_dense and siren_dense_wgrad with K = 0 (no GEMM);
             siren_dense also takes "k0_v1" there, its first elementwise
             kernel, by hand
      simt   fp32, and bf16 of shapes no tensor-core mainloop takes; for
             SGEMM_KERNELS the pipelined SIMT GEMM (csrc/simt_gemm.cuh)
      wgmma  bf16, K and N multiples of 64, inputs and outputs aligned;
             siren_dense and nerf_dense keep a 128-column slice of W in
             shared memory: K <= 512; the nerf kernels' encoding is one wgmma
             tile of its own: e_rows 0, 32 or 64 (K = 0, layer 0: the
             encoding alone)
      wmma   bf16, N (siren_dense, nerf_dense and the wgrads: and K) a
             multiple of 8, inputs aligned; nerf_dense's e_rows a multiple
             of 32

    mainloop "wmma" / "wgmma" asks for that one and raises ValueError where
    it cannot run; there is no other fallback.
    """
    _check_mainloop(mainloop)
    if kernel not in MAINLOOP_KERNELS:
        raise ValueError(f"{kernel} has one mainloop")
    bf16 = dtype == torch.bfloat16
    dgrad = kernel.endswith("_dgrad")
    if kernel in ("siren_dense", "siren_dense_wgrad") and k == 0:
        rule = "k0"
        takes = ("k0", "k0_v1") if kernel == "siren_dense" else ("k0",)
    else:
        mma_shape = (n % 8 == 0 and (dgrad or k % 8 == 0)
                     and (kernel != "nerf_dense" or e_rows % 32 == 0))
        enc_ok = e_rows in (0, 32, 64)
        forward = kernel in ("siren_dense", "nerf_dense")
        takes = tuple(name for name, ok in (
            ("wgmma", bf16 and k % 64 == 0 and n % 64 == 0 and inputs_aligned
             and outputs_aligned and enc_ok
             and (not forward or k <= DENSE_WGMMA_MAX_K)),
            ("wmma", bf16 and mma_shape and inputs_aligned)) if ok)
        rule = takes[0] if takes else "simt"
    if mainloop is None:
        return rule
    if mainloop not in takes:
        raise ValueError(f"{kernel}: mainloop {mainloop!r} does not take "
                         f"{dtype} K={k} N={n} e_rows={e_rows} (aligned inputs "
                         f"{inputs_aligned}, outputs {outputs_aligned})")
    return mainloop


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_cuda(dtype: torch.dtype, **tensors) -> None:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel dtype must be float32 or bfloat16, got {dtype}")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(name: str, *args, mainloop: Optional[str] = None,
            body: Optional[str] = None) -> None:
    from satnerf_tpu_torch.ops._build import load_library

    fn = getattr(load_library(), f"satnerf_{name}")
    err = fn(*args)
    LAUNCHES[name] += 1
    for counts, variant in ((MAINLOOP_LAUNCHES, mainloop), (BODY_LAUNCHES, body)):
        if variant is not None:
            counts[(name, variant)] = counts.get((name, variant), 0) + 1
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ---------------------------------------------------------------- siren_dense


def _extra_operand(rays16, samples: int, z, extra: str, n: int, dtype):
    """Materialized E operand (P, n), rounded to `dtype` (plain version)."""
    col = _EXTRA[extra][1]
    if extra == "xyz":
        e = rays16[:, None, 0:3] + rays16[:, None, 3:6] * z[:, :, None]
        e = e.reshape(-1, 3)
    else:
        e = rays16[:, col:col + n].repeat_interleave(samples, dim=0)
    return e.to(dtype).float()


def siren_dense_reference(x, weight, bias, rays16, samples: int, *,
                          extra: Optional[str] = None, extra_weight=None,
                          z=None, w0: float = 1.0, act: str = "sin",
                          save: bool = False):
    """Plain version of siren_dense: act(w0 * (x.weight + bias + E.C)).

    x (P, K) or None for K = 0; weight (K, N); bias (N,) fp32; rays16 (R, 16)
    fp32 with P = R * samples; extra in {None, "xyz", "sun", "t"} selects E
    (xyz = o + d*z needs z (R, S)); extra_weight (n, N). Returns (P, N) in the
    compute dtype (that of weight, else extra_weight); with save (sine layers
    only) also the slope w0 * cos(w0 * pre), (P, N) fp32, that the backward
    multiplies the layer's cotangent by.
    """
    if save and act != "sin":
        raise ValueError("only a sine layer has a slope to save")
    dtype = (weight if weight is not None else extra_weight).dtype
    p = rays16.shape[0] * samples
    if x is not None:
        pre = x.float() @ weight.float() + bias
    else:
        pre = bias.expand(p, -1).clone()
    if extra is not None:
        e = _extra_operand(rays16, samples, z, extra, extra_weight.shape[0],
                           dtype)
        pre = pre + e @ extra_weight.float()
    pre = w0 * pre
    slope = w0 * torch.cos(pre) if save else None
    if act == "sin":
        pre = torch.sin(pre)
    elif act == "relu":
        pre = torch.relu(pre)
    return (pre.to(dtype), slope) if save else pre.to(dtype)


def siren_dense(x, weight, bias, rays16, samples: int, *,
                extra: Optional[str] = None, extra_weight=None, z=None,
                w0: float = 1.0, act: str = "sin", save: bool = False,
                mainloop: Optional[str] = None):
    """One dense layer of the field; arguments as siren_dense_reference.

    CUDA tensors launch the siren_dense kernel, on the mainloop
    `dense_mainloop` gives (None: the rule; "wmma" / "wgmma" by hand); CPU
    tensors run the plain version.
    """
    _check_mainloop(mainloop)
    if rays16.device.type == "cpu":
        return siren_dense_reference(x, weight, bias, rays16, samples,
                                     extra=extra, extra_weight=extra_weight,
                                     z=z, w0=w0, act=act, save=save)
    if save and act != "sin":
        raise ValueError("only a sine layer has a slope to save")
    dtype = (weight if weight is not None else extra_weight).dtype
    _check_cuda(dtype, x=x, weight=weight, bias=bias, rays16=rays16, z=z,
                extra_weight=extra_weight)
    if rays16.dtype != torch.float32 or rays16.shape[1] != RAY_COLS:
        raise ValueError("rays16 must be (R, 16) float32")
    if bias.dtype != torch.float32:
        raise ValueError("bias must be float32")
    for name, t in (("x", x), ("weight", weight), ("extra_weight", extra_weight)):
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if extra == "xyz" and (z is None or z.dtype != torch.float32
                           or z.shape != (rays16.shape[0], samples)):
        raise ValueError("extra='xyz' needs z (R, samples) float32")
    p = rays16.shape[0] * samples
    n = bias.shape[0]
    k = 0 if x is None else x.shape[1]
    if x is not None and (x.shape[0] != p or weight.shape != (k, n)):
        raise ValueError(f"x {tuple(x.shape)} / weight {tuple(weight.shape)} "
                         f"do not fit P={p}, N={n}")
    if p >= 2 ** 31:
        raise ValueError(f"{p} points exceed the kernel's int32 indexing")
    mode, col = _EXTRA[extra]
    n_extra = 0 if extra is None else extra_weight.shape[0]
    if extra is not None and extra_weight.shape[1] != n:
        raise ValueError("extra_weight must be (n_extra, N)")
    y = torch.empty((p, n), dtype=dtype, device=rays16.device)
    slope = (torch.empty((p, n), dtype=torch.float32, device=rays16.device)
             if save else None)
    loop = dense_mainloop("siren_dense", dtype, k, n,
                          inputs_aligned=_aligned(x, weight),
                          outputs_aligned=_aligned(y, slope), mainloop=mainloop)
    _launch("siren_dense", _DTYPE_CODE[dtype], _ptr(x), k, _ptr(weight),
            _ptr(bias), _ptr(rays16), _ptr(z), samples, mode, col, n_extra,
            _ptr(extra_weight), float(w0), _ACT[act], _ptr(y), _ptr(slope),
            p, n, _MAINLOOP_CODE.get(loop, 0), _stream(rays16), mainloop=loop)
    return (y, slope) if save else y


# ------------------------------------------------------------ heads_composite


def _narrow_heads(h, r, s2, bh, skyh, wn, bn, rgb_padding: float, dtype=None):
    """Per-sample sigma, albedo, sun_v, beta and per-ray sky (plain). The
    operands are rounded to `dtype` (that of wn unless given)."""
    fh, dt = r.shape[1], (wn.dtype if dtype is None else dtype)

    def mm(x, rows):  # (P, K) @ (n, K).T -> (P, n)
        return rounded_matmul(x, rows, dt)

    sigma = F.softplus(mm(h, wn[0:1])[:, 0] + bn[0])
    albedo = torch.sigmoid(mm(r, wn[1:4, :fh]) + bn[1:4])
    albedo = albedo * (1 + 2 * rgb_padding) - rgb_padding
    sunv = torch.sigmoid(mm(s2, wn[4:5, :fh])[:, 0] + bn[4])
    sky = torch.sigmoid(mm(skyh, wn[5:8, :fh]) + bn[5:8])
    beta = (F.softplus(mm(bh, wn[8:9, :fh])[:, 0] + bn[8]) if bh is not None
            else torch.zeros_like(sunv))
    return sigma, albedo, sunv, sky, beta


def _heads_products(h, r, s2, bh, skyh, wn, bn, z, noise, rgb_padding, dtype):
    """((R, 16) products, (R, S) weights) of the narrow heads and the
    compositor (plain, differentiable)."""
    n_rays, n_s = z.shape
    sigma, albedo, sunv, sky, beta = _narrow_heads(h, r, s2, bh, skyh, wn, bn,
                                                   rgb_padding, dtype=dtype)
    _, _, w = ray_weights(sigma.reshape(n_rays, n_s), z, noise)
    albedo = albedo.reshape(n_rays, n_s, 3)
    sunv = sunv.reshape(n_rays, n_s, 1)
    beta = beta.reshape(n_rays, n_s, 1)
    sky = sky[:, None, :].expand(n_rays, n_s, 3)
    irr = sunv + (1.0 - sunv) * sky
    wc = w[..., None]
    out = torch.cat([
        torch.clamp((wc * albedo * irr).sum(1), 0.0, 1.0),
        (w * z).sum(1, keepdim=True), (wc * sunv).sum(1), (wc * sky).sum(1),
        (wc * beta).sum(1), (wc * albedo).sum(1), w.sum(1, keepdim=True),
        torch.zeros((n_rays, OUT_COLS - 13), dtype=torch.float32,
                    device=z.device)], dim=1)
    return out, w


def heads_composite_reference(h, r, s2, bh, skyh, wn, bn, z, *, noise=None,
                              rgb_padding: float = 0.001,
                              return_weights: bool = False):
    """Plain version of heads_composite.

    h (P, F), r/s2/bh (P, Fh) (bh None without the beta head), skyh (R, Fh),
    all in the compute dtype; wn (9, F) narrow weights in the compute dtype
    (rows: sigma, rgb_1 x3, sun_v_out, sky_1 x3, beta_1); bn (9,) fp32;
    z (R, S) fp32; noise (R, S) fp32 added to sigma before the relu, or None.
    Returns ((R, 16) products, (R, S) weights or None).
    """
    out, w = _heads_products(h, r, s2, bh, skyh, wn, bn, z, noise,
                             rgb_padding, wn.dtype)
    return out, (w if return_weights else None)


def heads_composite(h, r, s2, bh, skyh, wn, bn, z, *, noise=None,
                    rgb_padding: float = 0.001, return_weights: bool = False):
    """Narrow heads + compositing; arguments as heads_composite_reference.

    CUDA tensors launch the heads_composite kernel; CPU tensors run the
    plain version. Any number of samples a ray and any width (Fh at most
    F): where the narrow rows do not fit the shared memory a block may hold
    (F past 22,577 in bf16, 11,281 in fp32, at Fh = F / 2) the kernel reads
    them from global memory.
    """
    if z.device.type == "cpu":
        return heads_composite_reference(h, r, s2, bh, skyh, wn, bn, z,
                                         noise=noise, rgb_padding=rgb_padding,
                                         return_weights=return_weights)
    dtype = h.dtype
    _check_cuda(dtype, h=h, r=r, s2=s2, bh=bh, skyh=skyh, wn=wn, bn=bn, z=z,
                noise=noise)
    n_rays, n_s = z.shape
    p, feat = h.shape
    fh = r.shape[1]
    if z.dtype != torch.float32 or bn.dtype != torch.float32 or bn.numel() != 9:
        raise ValueError("z must be fp32 (R, S) and bn fp32 (9,)")
    if noise is not None and (noise.dtype != torch.float32
                              or noise.shape != z.shape):
        raise ValueError("noise must be fp32 (R, S)")
    if (p != n_rays * n_s or wn.shape != (9, feat) or skyh.shape != (n_rays, fh)
            or fh > feat):
        raise ValueError("heads_composite: inconsistent shapes")
    for name, t in (("r", r), ("s2", s2), ("bh", bh)):
        if t is not None and (t.shape != (p, fh) or t.dtype != dtype):
            raise ValueError(f"{name} must be ({p}, {fh}) {dtype}")
    for name, t in (("skyh", skyh), ("wn", wn)):
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}")
    out = torch.empty((n_rays, OUT_COLS), dtype=torch.float32, device=z.device)
    weights = (torch.empty((n_rays, n_s), dtype=torch.float32, device=z.device)
               if return_weights else None)
    _launch("heads_composite", _DTYPE_CODE[dtype], _ptr(h), feat, _ptr(r),
            _ptr(s2), _ptr(bh), _ptr(skyh), fh, _ptr(wn), _ptr(bn), _ptr(z),
            _ptr(noise), n_rays, n_s, float(rgb_padding), _ptr(out),
            _ptr(weights), _stream(z))
    return out, weights


# ----------------------------------------------------------- the whole render


def pack_rays(rays_o, rays_d, sun_dir, t_embed, tau: int):
    """(R, 16) fp32 [o | d | sun | t | 0], the layout of fused_mlp.py:1084."""
    n = rays_o.shape[0]
    parts = [rays_o, rays_d, sun_dir]
    if t_embed is not None:
        parts.append(t_embed)
    rays16 = torch.zeros((n, RAY_COLS), dtype=torch.float32, device=rays_o.device)
    rays16[:, :9 + (tau if t_embed is not None else 0)] = torch.cat(
        [p.float() for p in parts], dim=-1)
    return rays16


def pack_params(field, *, skip: int, use_beta: bool, dtype) -> dict:
    """RadianceField -> kernel operands: (in, out) weights in `dtype`,
    fp32 biases, the skip layer split into its xyz rows C and h rows, and the
    narrow heads packed as wn (9, F) / bn (9,)."""
    layers, feat = field.layers, field.feat
    fh = feat // 2

    def k(lin):
        return lin.weight.detach().t().contiguous().to(dtype)

    def b(lin):
        return lin.bias.detach().float().contiguous()

    fc = [field.fc_net[2 * i] for i in range(layers)]
    p = {"A": k(fc[0]), "bt": [b(l) for l in fc], "B": [], "C": None}
    for l in range(1, layers):
        w = k(fc[l])
        if l == skip:  # input was cat([xyz, h]): the first 3 rows act on xyz
            p["C"], w = w[:3].contiguous(), w[3:].contiguous()
        p["B"].append(w)
    p["Wfeat"], p["bfeat"] = k(field.feats_from_xyz), b(field.feats_from_xyz)
    rgb0, rgb1 = field.rgb_from_xyzdir[0], field.rgb_from_xyzdir[2]
    p["Wrgb0"], p["brgb0"] = k(rgb0), b(rgb0)
    sun = field.sun_v_net
    w = k(sun[0])
    p["Wsun0h"], p["Wsun0d"], p["bsun0"] = (w[:feat].contiguous(),
                                            w[feat:].contiguous(), b(sun[0]))
    p["Wsun1"], p["bsun1"] = k(sun[2]), b(sun[2])
    p["Wsun2"], p["bsun2"] = k(sun[4]), b(sun[4])
    sky0, sky1 = field.sky_color[0], field.sky_color[2]
    p["Wsky0"], p["bsky0"] = k(sky0), b(sky0)

    dev = fc[0].weight.device
    wn = torch.zeros((9, feat), dtype=torch.float32, device=dev)
    bn = torch.zeros((9,), dtype=torch.float32, device=dev)
    sig = field.sigma_from_xyz[0]
    wn[0], bn[0] = sig.weight.detach()[0], sig.bias.detach()[0]
    wn[1:4, :fh], bn[1:4] = rgb1.weight.detach(), rgb1.bias.detach()
    wn[4, :fh], bn[4] = sun[6].weight.detach()[0], sun[6].bias.detach()[0]
    wn[5:8, :fh], bn[5:8] = sky1.weight.detach(), sky1.bias.detach()
    if use_beta:
        beta0, beta1 = field.beta_from_xyz[0], field.beta_from_xyz[2]
        w = k(beta0)
        p["Wbeta0h"], p["Wbeta0t"] = w[:feat].contiguous(), w[feat:].contiguous()
        p["bbeta0"] = b(beta0)
        wn[8, :fh], bn[8] = beta1.weight.detach()[0], beta1.bias.detach()[0]
    p["wn"], p["bn"] = wn.to(dtype).contiguous(), bn
    return p


def _render_staged(p: dict, rays16, z, *, skip: int, use_beta: bool,
                   rgb_padding: float, return_weights: bool,
                   dense_fn=siren_dense, heads_fn=heads_composite):
    """The kernel chain: trunk, wide heads, heads_composite.
    Returns ((R, 16) products, (R, S) weights or None). dense_fn / heads_fn
    stand in for the two wrappers where a check wants to see each stage's
    inputs (chip_smoke.py compares every launch with its plain version)."""
    n_s = z.shape[1]

    def dense(x, w, bias, extra=None, ew=None, w0=1.0, act="sin"):
        return dense_fn(x, w, bias, rays16, n_s, extra=extra,
                        extra_weight=ew, z=z, w0=w0, act=act)

    h = dense(None, None, p["bt"][0], "xyz", p["A"], w0=30.0)
    for l, w in enumerate(p["B"], start=1):
        if l == skip:
            h = dense(h, w, p["bt"][l], "xyz", p["C"])
        else:
            h = dense(h, w, p["bt"][l])
    feats = dense(h, p["Wfeat"], p["bfeat"], act="none")
    r = dense(feats, p["Wrgb0"], p["brgb0"])
    s = dense(feats, p["Wsun0h"], p["bsun0"], "sun", p["Wsun0d"])
    s = dense(s, p["Wsun1"], p["bsun1"])
    s = dense(s, p["Wsun2"], p["bsun2"])
    bh = (dense(feats, p["Wbeta0h"], p["bbeta0"], "t", p["Wbeta0t"])
          if use_beta else None)
    del feats
    # sky_0 sees sun_dir only, so it runs once a ray (samples = 1)
    skyh = dense_fn(None, None, p["bsky0"], rays16, 1, extra="sun",
                    extra_weight=p["Wsky0"], act="relu")
    return heads_fn(h, r, s, bh, skyh, p["wn"], p["bn"], z,
                    rgb_padding=rgb_padding, return_weights=return_weights)


def _products(out, weights, use_beta: bool) -> dict:
    res = {"rgb": out[:, 0:3], "depth": out[:, 3], "sun": out[:, 4:5],
           "sky": out[:, 5:8], "albedo": out[:, 9:12], "opacity": out[:, 12]}
    if use_beta:
        res["beta"] = out[:, 8:9]
    if weights is not None:
        res["weights"] = weights
    return res


def fused_render_rays_reference(params, rays_o, rays_d, sun_dir, t_embed,
                                z_vals, *, layers: int = 8, feat: int = 512,
                                skip: int = 4, use_beta: bool = True,
                                rgb_padding: float = 0.001, tau: int = 4,
                                dtype=torch.bfloat16,
                                return_weights: bool = False,
                                noise=None) -> dict:
    """Plain version of fused_render_rays: the field module on o + d*z, then
    render/composite.py (with the sigma noise, when given), then the per-ray
    integrals sum_s w_s * q_s that satnerf_tpu/train/system.py:294-300
    describes. Differentiable where the caller lets autograd record."""
    _check_field(params, layers, feat, skip, use_beta, tau, rgb_padding)
    res = run_field(params, rays_o, rays_d, None, sun_dir,
                    t_embed if use_beta else None, z_vals, shadow=True,
                    dtype=dtype, noise=noise)
    w = res["weights"]

    def integ(q):
        return (w[..., None] * q).sum(-2)

    out = {"rgb": res["rgb"], "depth": res["depth"], "sun": integ(res["sun"]),
           "sky": integ(res["sky"]), "albedo": integ(res["albedo"]),
           "opacity": w.sum(-1)}
    if use_beta:
        out["beta"] = integ(res["beta"])
    if return_weights:
        out["weights"] = w
    return out


def _check_field(field, layers, feat, skip, use_beta, tau, rgb_padding):
    got = (field.layers, field.feat, field.skips, field.use_beta,
           field.siren and field.use_shadow, field.rgb_padding)
    want = (layers, feat, (skip,), use_beta, True, rgb_padding)
    if got != want or (use_beta and field.t_dim != tau):
        raise ValueError(f"field (layers, feat, skips, use_beta, siren shadow "
                         f"variant, rgb_padding) = {got} does not match {want}")


def _check_card_call(name, field, z_vals, sun_dir, t_embed, layers, feat, skip,
                     use_beta, tau, rgb_padding):
    """What every kernel chain asks of its caller before it packs anything."""
    if z_vals.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {z_vals.device}")
    _check_field(field, layers, feat, skip, use_beta, tau, rgb_padding)
    if sun_dir is None or (use_beta and t_embed is None):
        raise ValueError("the shadow variants need sun_dir (and t_embed for "
                         "sat-nerf)")
    if tau > RAY_COLS - 9:
        raise ValueError(f"tau={tau} does not fit the 16-column ray layout")


def fused_render_rays(params, rays_o, rays_d, sun_dir, t_embed, z_vals, *,
                      layers: int = 8, feat: int = 512, skip: int = 4,
                      use_beta: bool = True, rgb_padding: float = 0.001,
                      tau: int = 4, dtype=torch.bfloat16,
                      return_weights: bool = False) -> dict:
    """Serving path: render rays to per-ray products.

    params: the s-nerf / sat-nerf RadianceField. rays_o, rays_d, sun_dir
    (R, 3); t_embed (R, tau) (sat-nerf); z_vals (R, S). Returns
    {"rgb": (R,3), "depth": (R,), "sun": (R,1), "sky": (R,3),
    "albedo": (R,3), "opacity": (R,)} plus "beta" (R,1) for sat-nerf and
    "weights" (R,S) when return_weights — the same dict as the JAX kernel.

    On CUDA tensors this launches the siren_dense / heads_composite chain
    under torch.inference_mode(): its outputs carry no grad_fn (training
    goes through fused_train_loss_grads and fused_train_render_rays). On CPU
    tensors it runs fused_render_rays_reference.
    """
    if z_vals.device.type == "cpu":
        return fused_render_rays_reference(
            params, rays_o, rays_d, sun_dir, t_embed, z_vals, layers=layers,
            feat=feat, skip=skip, use_beta=use_beta, rgb_padding=rgb_padding,
            tau=tau, dtype=dtype, return_weights=return_weights)
    _check_card_call("fused_render_rays", params, z_vals, sun_dir, t_embed,
                     layers, feat, skip, use_beta, tau, rgb_padding)
    with torch.inference_mode():
        rays16 = pack_rays(rays_o, rays_d, sun_dir,
                           t_embed if use_beta else None, tau)
        z = z_vals.float().contiguous()
        packed = pack_params(params, skip=skip, use_beta=use_beta, dtype=dtype)
        out, weights = _render_staged(packed, rays16, z, skip=skip,
                                      use_beta=use_beta,
                                      rgb_padding=rgb_padding,
                                      return_weights=return_weights)
    return _products(out, weights, use_beta)


# ======================================================== the training step
#
# K1, fused_train_loss_grads: the forward chain with saved slopes, then
# composite_loss_bwd, then a dgrad and a wgrad launch per dense layer.


def _cotangent(dy, slope, dtype):
    """(G, round(G)) for G = dy * slope in fp32 (slope None: a linear layer)."""
    g = dy if slope is None else dy * slope
    return g, g.to(dtype).float()


# ---------------------------------------------------------- siren_dense_dgrad


def siren_dense_dgrad_reference(dy, slope, weight, *, out=None):
    """Plain version of siren_dense_dgrad: round(dy * slope) @ weight.T.

    dy, slope (P, N) fp32 (slope None for a linear layer); weight (K, N) in
    the compute dtype. Returns dX (P, K) fp32, added onto `out` when given.
    """
    _, gb = _cotangent(dy, slope, weight.dtype)
    dx = gb @ weight.float().t()
    return dx if out is None else out.add_(dx)


def siren_dense_dgrad(dy, slope, weight, *, out=None,
                      mainloop: Optional[str] = None):
    """The input cotangent of one dense layer; arguments as
    siren_dense_dgrad_reference. CUDA tensors launch the kernel on the
    mainloop `dense_mainloop` gives (None: the rule; "wmma" / "wgmma" by
    hand)."""
    _check_mainloop(mainloop)
    if dy.device.type == "cpu":
        return siren_dense_dgrad_reference(dy, slope, weight, out=out)
    dtype = weight.dtype
    _check_cuda(dtype, dy=dy, slope=slope, weight=weight, out=out)
    p, n = dy.shape
    k = weight.shape[0]
    if dy.dtype != torch.float32 or weight.shape != (k, n):
        raise ValueError("dy must be (P, N) fp32 and weight (K, N)")
    if slope is not None and (slope.shape != dy.shape
                              or slope.dtype != torch.float32):
        raise ValueError("slope must match dy, fp32")
    if out is not None and (out.shape != (p, k) or out.dtype != torch.float32):
        raise ValueError("out must be (P, K) fp32")
    dx = out if out is not None else torch.empty(
        (p, k), dtype=torch.float32, device=dy.device)
    loop = dense_mainloop("siren_dense_dgrad", dtype, k, n,
                          inputs_aligned=_aligned(dy, slope, weight),
                          outputs_aligned=_aligned(dx), mainloop=mainloop)
    _launch("siren_dense_dgrad", _DTYPE_CODE[dtype], _ptr(dy), _ptr(slope),
            _ptr(weight), _ptr(dx), int(out is not None), p, n, k,
            _MAINLOOP_CODE.get(loop, 0), _stream(dy), mainloop=loop)
    return dx


# ---------------------------------------------------------- siren_dense_wgrad


def _wgrad_dtype(x, extra_weight, dy) -> torch.dtype:
    """The compute dtype of a wgrad: X's, else C's; a layer with only a
    bias has no product to round and sums db in fp32 (dy's dtype)."""
    return next(t for t in (x, extra_weight, dy) if t is not None).dtype


def siren_dense_wgrad_reference(x, dy, slope, rays16, samples: int, *,
                                extra: Optional[str] = None, extra_weight=None,
                                z=None, extra_grad: bool = False):
    """Plain version of siren_dense_wgrad, the parameter gradients of
    y = act(w0 * (x.W + b + E.C)) given its cotangent dy and saved slope.

    x (P, K) in the compute dtype or None (K = 0; with neither x nor E the
    layer has a bias alone); dy, slope (P, N) fp32; rays16, samples, extra,
    extra_weight, z as siren_dense. Returns
    (dW (K, N) or None, db (N,), dC (n, N) or None, dE (R, n) or None), all
    fp32: dW = x.T @ round(G), db = sum G (unrounded), dC = E.T @ round(G),
    and with extra_grad the per-ray gradient of the E operand itself,
    dE = sum over the ray's samples of round(G) @ C.T.
    """
    dtype = _wgrad_dtype(x, extra_weight, dy)
    g, gb = _cotangent(dy, slope, dtype)
    dw = x.float().t() @ gb if x is not None else None
    db = g.sum(0)
    dc = de = None
    if extra is not None:
        n_e = extra_weight.shape[0]
        e = _extra_operand(rays16, samples, z, extra, n_e, dtype)
        dc = e.t() @ gb
        if extra_grad:
            de = (gb @ extra_weight.float().t()).reshape(-1, samples, n_e).sum(1)
    return dw, db, dc, de


# csrc/fused_train.cu SMALL_*: whether the walk small_grads runs, and sums db
_SMALL_CODE = {"none": 0, "no_db": 1, "db": 2}
WGRAD_TILE = (128, 256)  # csrc/fused_train.cu WGR_N, WGR_K: a block's tile of dW^T
WGRAD_STAGE_POINTS = 32  # WGR_P: a split is a multiple of it
# csrc/dense_bwd_wgmma.cuh: the widest E the wgmma wgrad folds, and the most
# points a folding block holds E of (its split is cut to it)
FOLD_MAX, FOLD_SPLIT = 4, 4096
# The two bodies of the narrow gradients (`narrow=` on siren_dense_wgrad):
# narrow_grads, the default, or the column walk small_grads, kept to compare
NARROW_BODIES = ("rays", "walk")
NARROW_MAX_JOBS = 4  # csrc/fused_train.cu: the layers a narrow_grads launch takes
NARROW_MAX_N = 512


def small_grads_mode(mainloop: str, extra: Optional[str], narrow: str = "rays",
                     n_extra: int = 3) -> str:
    """Who forms the narrow gradients (db, dC) of a siren_dense_wgrad launch
    whose GEMM took `mainloop` (as dense_mainloop answers), with an E
    operand of n_extra columns (extra None: none), on the narrow body asked
    for.

    narrow="rays" (the rule):
      none   wgmma without an E operand: the GEMM's epilogue sums db
      fold   wgmma with an E operand of at most FOLD_MAX columns: the
             epilogue also forms dC (the fold)
      dc     wgmma with a wider E operand: narrow_grads forms dC
      db     wmma, simt or k0 (no GEMM): narrow_grads sums db, and dC where
             there is an E operand
    narrow="walk" (small_grads, launched by the wgrad's C entry after the
    GEMM, as before narrow_grads):
      none   wgmma without an E operand
      no_db  wgmma with an E operand: small_grads forms dC only
      db     wmma, simt or k0: small_grads sums db, and dC

    dE, where it is asked for, is a narrow_grads job of its own ("rays") or
    small_grads' work too ("walk"; then "none" cannot give it). The C entry
    refuses what this does not allow."""
    _check_narrow_body(narrow)
    if mainloop != "wgmma":
        return "db"
    if extra is None:
        return "none"
    if narrow == "walk":
        return "no_db"
    return "fold" if n_extra <= FOLD_MAX else "dc"


def _check_narrow_body(narrow: str) -> None:
    if narrow not in NARROW_BODIES:
        raise ValueError(f"narrow must be one of {NARROW_BODIES}, got {narrow!r}")


def wgrad_split(p: int, k: int, n: int, sms: int, e_rows: int = 0) -> int:
    """Points a block of the wgmma wgrad (siren_dense_wgrad and
    nerf_dense_wgrad) sums over: the points of a layer cut into as many
    ranges as one block an SM leaves room for beside the layer's tiles (one
    wave; every range a multiple of WGRAD_STAGE_POINTS). A tile is
    WGRAD_TILE of dW^T, or 128 columns of dC^T against the encoding (e_rows
    > 0: one more k tile). At 65,536 points: 4,096 a block for 512 x 512 (8
    tiles, 128 blocks), 2,016 for 512 x 256 (4 tiles, 132 blocks), 1,024 for
    256 x 256 (2 tiles, 128 blocks), and for the nerf variant's encoding
    layers 2,016 (the skip layer, 256 x 256 and 64 rows: 4 tiles), 1,024
    (rgb_0, 256 x 128 and 32 rows; layer 0, the 64 rows alone: 2 tiles)."""
    tiles = -(-n // WGRAD_TILE[0]) * max(1, -(-k // WGRAD_TILE[1]) + (e_rows > 0))
    per = -(-p // max(1, sms // tiles))
    step = WGRAD_STAGE_POINTS
    return max(step, -(-per // step) * step)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class NarrowJob:
    """One layer's narrow gradients for narrow_grads: its cotangent dy and
    slope (P, N) fp32 (slope None: a linear layer), the rays and samples,
    its E operand (extra, extra_weight (n_extra, N), z as siren_dense), the
    compute dtype, and which of db, dC, dE are asked for. Its outputs
    (zero-filled, fp32) are allocated with it: db (N,), dc (n_extra, N), de
    (R, n_extra), None where not asked."""

    def __init__(self, dy, slope, rays16, samples: int, *, extra=None,
                 extra_weight=None, z=None, dtype, db: bool, dc: bool,
                 de: bool):
        self.dy, self.slope, self.rays16, self.samples = dy, slope, rays16, samples
        self.extra, self.extra_weight, self.z, self.dtype = extra, extra_weight, z, dtype
        n = dy.shape[1]
        n_e = 0 if extra is None else extra_weight.shape[0]
        if (dc or de) and extra is None:
            raise ValueError("dC and dE need an E operand")

        def zeros(want, *shape):
            return (torch.zeros(shape, dtype=torch.float32, device=dy.device)
                    if want else None)

        self.db = zeros(db, n)
        self.dc = zeros(dc, n_e, n)
        self.de = zeros(de, rays16.shape[0], n_e)


def narrow_grads_reference(job: NarrowJob) -> tuple:
    """Plain version of narrow_grads for one job: (db, dc, de) as
    siren_dense_wgrad_reference forms them, None where not asked."""
    g, gb = _cotangent(job.dy, job.slope, job.dtype)
    db = g.sum(0) if job.db is not None else None
    dc = de = None
    if job.dc is not None or job.de is not None:
        n_e = job.extra_weight.shape[0]
        if job.dc is not None:
            e = _extra_operand(job.rays16, job.samples, job.z, job.extra, n_e,
                               job.dtype)
            dc = e.t() @ gb
        if job.de is not None:
            de = (gb @ job.extra_weight.float().t()).reshape(
                -1, job.samples, n_e).sum(1)
    return db, dc, de


def narrow_grads(jobs: list) -> None:
    """Launch narrow_grads on CUDA jobs (NarrowJob), at most NARROW_MAX_JOBS
    layers a launch, all of one compute dtype: each job's db, dc and de are
    filled in place (the kernel's atomics add into their zeros). Every
    launch adds one to LAUNCHES["narrow_grads"]. CPU jobs are filled by the
    plain version."""
    for at in range(0, len(jobs), NARROW_MAX_JOBS):
        group = jobs[at:at + NARROW_MAX_JOBS]
        if group[0].dy.device.type == "cpu":
            for job in group:
                for out, v in zip((job.db, job.dc, job.de),
                                  narrow_grads_reference(job)):
                    if out is not None:
                        out.copy_(v)
            continue
        dtype = group[0].dtype
        words = []
        for job in group:
            _check_cuda(job.dtype, dy=job.dy, slope=job.slope,
                        rays16=job.rays16, z=job.z,
                        extra_weight=job.extra_weight)
            p, n = job.dy.shape
            if job.dtype != dtype:
                raise ValueError("the jobs of a narrow_grads launch share a dtype")
            if n > NARROW_MAX_N:
                raise ValueError(f"narrow_grads takes at most {NARROW_MAX_N} "
                                 f"columns, got {n}")
            mode, col = _EXTRA[job.extra]
            n_e = 0 if job.extra is None else job.extra_weight.shape[0]
            words += [_ptr(job.dy) or 0, _ptr(job.slope) or 0,
                      _ptr(job.rays16) or 0, _ptr(job.z) or 0,
                      _ptr(job.extra_weight) or 0, _ptr(job.db) or 0,
                      _ptr(job.dc) or 0, _ptr(job.de) or 0,
                      p, n, job.samples, mode, col, n_e]
        buf = (ctypes.c_longlong * len(words))(*words)
        _launch("narrow_grads", _DTYPE_CODE[dtype], len(group),
                ctypes.addressof(buf), _stream(group[0].dy))


def siren_dense_wgrad(x, dy, slope, rays16, samples: int, *,
                      extra: Optional[str] = None, extra_weight=None, z=None,
                      extra_grad: bool = False, mainloop: Optional[str] = None,
                      split: Optional[int] = None, narrow: str = "rays",
                      defer: Optional[list] = None):
    """The parameter gradients of one dense layer; arguments and returns as
    siren_dense_wgrad_reference. CUDA tensors launch the GEMM (K > 0) on the
    mainloop `dense_mainloop` gives (None: the rule; "wmma" / "wgmma" by
    hand), with dC folded into its epilogue where `small_grads_mode` says,
    and the narrow gradients left over on the body asked for: narrow="rays"
    a narrow_grads job, launched here or, given a list as `defer`, appended
    to it for the caller's one launch of several layers (narrow_grads; the
    returned db, dC, dE are filled then); narrow="walk" small_grads after
    the GEMM, by the C entry. CPU tensors run the plain version. split:
    points a block of the wgmma mainloop (None: `wgrad_split`, at most
    FOLD_SPLIT where dC is folded; a positive multiple of
    WGRAD_STAGE_POINTS), for measuring: past FOLD_SPLIT narrow_grads forms
    dC in place of the fold."""
    _check_mainloop(mainloop)
    _check_narrow_body(narrow)
    if dy.device.type == "cpu":
        return siren_dense_wgrad_reference(
            x, dy, slope, rays16, samples, extra=extra,
            extra_weight=extra_weight, z=z, extra_grad=extra_grad)
    dtype = _wgrad_dtype(x, extra_weight, dy)
    _check_cuda(dtype, x=x, dy=dy, slope=slope, rays16=rays16, z=z,
                extra_weight=extra_weight)
    p, n = dy.shape
    k = 0 if x is None else x.shape[1]
    if dy.dtype != torch.float32 or p != rays16.shape[0] * samples:
        raise ValueError("dy must be (R * samples, N) fp32")
    if slope is not None and (slope.shape != dy.shape
                              or slope.dtype != torch.float32):
        raise ValueError("slope must match dy, fp32")
    if x is not None and (x.shape[0] != p or x.dtype != dtype):
        raise ValueError(f"x must be ({p}, K) {dtype}")
    if extra == "xyz" and (z is None or z.shape != (rays16.shape[0], samples)):
        raise ValueError("extra='xyz' needs z (R, samples)")
    if extra_grad and extra is None:
        raise ValueError("extra_grad needs an E operand")
    mode, col = _EXTRA[extra]
    n_extra = 0 if extra is None else extra_weight.shape[0]
    if extra is not None and (extra_weight.shape[1] != n
                              or extra_weight.dtype != dtype):
        raise ValueError(f"extra_weight must be (n_extra, N) {dtype}")
    loop = dense_mainloop("siren_dense_wgrad", dtype, k, n,
                          inputs_aligned=_aligned(x, dy, slope),
                          mainloop=mainloop)
    plan = small_grads_mode(loop, extra, narrow, n_extra)
    if loop != "wgmma":
        split = 0
    elif split is None:
        split = wgrad_split(p, k, n, _sm_count(dy.device.index or 0))
        if plan == "fold":
            split = min(split, FOLD_SPLIT)
    elif split <= 0 or split % WGRAD_STAGE_POINTS:
        raise ValueError(f"split must be a positive multiple of "
                         f"{WGRAD_STAGE_POINTS}, got {split}")
    elif plan == "fold" and split > FOLD_SPLIT:
        plan = "dc"  # a folding block holds E of FOLD_SPLIT points at most

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dy.device)

    walk = narrow == "walk"
    dw = zeros(k, n) if x is not None else None
    job = None
    if not walk and (plan in ("db", "dc") or extra_grad):
        job = NarrowJob(dy, slope, rays16, samples, extra=extra,
                        extra_weight=extra_weight, z=z, dtype=dtype,
                        db=plan == "db", dc=plan in ("db", "dc") and extra is not None,
                        de=extra_grad)
    db = job.db if job is not None and job.db is not None else zeros(n)
    dc = (job.dc if job is not None and job.dc is not None
          else zeros(n_extra, n) if extra is not None else None)
    de = (job.de if job is not None else
          zeros(rays16.shape[0], n_extra) if extra_grad else None)
    if k > 0 or walk:  # with narrow="rays" a layer without X has no GEMM to launch
        _launch("siren_dense_wgrad", _DTYPE_CODE[dtype], _ptr(x), k, _ptr(dy),
                _ptr(slope), _ptr(rays16), _ptr(z), samples, mode, col, n_extra,
                _ptr(extra_weight), _ptr(dw), _ptr(db), _ptr(dc),
                _ptr(de) if walk else None, p, n,
                _MAINLOOP_CODE.get(loop, 0), split,
                _SMALL_CODE[plan if walk else "none"], int(plan == "fold"),
                _stream(dy), mainloop=loop)
        if walk and plan != "none":
            LAUNCHES["small_grads"] += 1
    if job is not None:
        if defer is not None:
            defer.append(job)
        else:
            narrow_grads([job])
    return dw, db, dc, de


# --------------------------------------------------------- composite_loss_bwd


def _narrow_adjoint(fn, h, r, s2, bh, skyh, wn, bn) -> tuple:
    """Differentiate a scalar of the narrow heads' inputs by autograd.

    fn(hf, rf, sf, bf, skyf, wn_l, bn_l) -> (scalar, aux) runs on fp32 leaves
    of the activations and the narrow weights (matmul operands are rounded to
    wn's dtype inside, models/nerf.py rounded_matmul). Returns ({d_h, d_r,
    d_s2, d_bh, d_skyh (through sky_0's relu), dwn, dbn}, aux); r, bh and skyh
    may be None, and a leaf the scalar does not reach gets zeros.
    """
    leaves = {k: v.detach().float().requires_grad_(True)
              for k, v in (("h", h), ("r", r), ("s2", s2), ("bh", bh),
                           ("skyh", skyh), ("wn", wn)) if v is not None}
    leaves["bn"] = bn.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        scalar, aux = fn(leaves["h"], leaves.get("r"), leaves["s2"],
                         leaves.get("bh"), leaves.get("skyh"), leaves["wn"],
                         leaves["bn"])
        grads = torch.autograd.grad(scalar, list(leaves.values()),
                                    allow_unused=True)
    g = {k: (torch.zeros_like(a) if d is None else d)
         for (k, a), d in zip(leaves.items(), grads)}
    cot = {f"d_{k}": g.get(k) for k in ("h", "r", "s2", "bh", "skyh")}
    if skyh is not None:
        cot["d_skyh"] = cot["d_skyh"] * (leaves["skyh"].detach() > 0)
    cot["dwn"], cot["dbn"] = g["wn"], g["bn"]
    return cot, aux


def composite_loss_bwd_reference(h, r, s2, bh, skyh, wn, bn, z, noise, gt,
                                 wmix: float, *, rgb_padding: float = 0.001,
                                 beta_min: float = L.BETA_MIN,
                                 return_weights: bool = False) -> dict:
    """Plain version of composite_loss_bwd, by autograd.

    h (P, F), r/s2/bh (P, Fh) (bh None without the beta head), skyh (R, Fh),
    wn (9, F) in the compute dtype; bn (9,), z (R, S), noise (R, S) or None,
    gt (R, 3) fp32; wmix the beta warm-up gate. The narrow heads, the
    compositor and the losses of train/losses.py run forward; the mixed loss
    wmix * (color_sat + logbeta) + (1 - wmix) * mse (the MSE alone without
    the beta head) is differentiated. Returns fp32 tensors:
      loss_sums (3,) [sum 0.5 sq / beta^2, sum log beta, sum sq] over rays
      d_h (P, F) the sigma head's share of h's cotangent; d_r, d_s2, d_bh
      (P, Fh); d_skyh (R, Fh), already through sky_0's relu
      dwn (9, F), dbn (9,); weights (R, S) or None
    """
    n_rays, n_s = z.shape
    use_beta = bh is not None

    def loss(hf, rf, sf, bf, skyf, wn_l, bn_l):
        sigma, albedo, sunv, sky, beta = _narrow_heads(
            hf, rf, sf, bf, skyf, wn_l, bn_l, rgb_padding, dtype=wn.dtype)
        out = {"rgb": albedo.reshape(n_rays, n_s, 3),
               "sigma": sigma.reshape(n_rays, n_s),
               "sun_v": sunv.reshape(n_rays, n_s, 1),
               "sky_rgb": sky[:, None, :].expand(n_rays, n_s, 3)}
        if use_beta:
            out["beta"] = beta.reshape(n_rays, n_s, 1)
        res = {f"{k}_coarse": v for k, v in
               composite(out, z, noise=noise, shadow=True).items()}
        sq = ((res["rgb_coarse"] - gt) ** 2).sum(1)
        mse, _ = L.snerf_loss(res, gt, 0.0)
        weights = res["weights_coarse"].detach()
        if not use_beta:
            zero = sq.new_zeros(())
            return mse, (torch.stack([zero, zero, sq.sum()]).detach(), weights)
        color, logbeta = L.uncertainty_aware_terms(res, gt, "coarse")
        b = (res["weights_coarse"][..., None] * res["beta_coarse"]).sum(-2)
        b = b[:, 0] + beta_min
        sums = torch.stack([(0.5 * sq / b ** 2).sum(), torch.log(b).sum(),
                            sq.sum()])
        return (wmix * (color + logbeta) + (1.0 - wmix) * mse,
                (sums.detach(), weights))

    res, (sums, weights) = _narrow_adjoint(loss, h, r, s2, bh, skyh, wn, bn)
    res["loss_sums"] = sums
    res["weights"] = weights if return_weights else None
    return res


def _check_narrow(name, h, r, s2, bh, skyh, wn, bn, z, noise):
    """Shapes and dtypes the per-ray kernels share; returns (R, S, P, F, Fh)."""
    dtype = h.dtype
    n_rays, n_s = z.shape
    p, feat = h.shape
    fh = s2.shape[1]
    if p != n_rays * n_s or wn.shape != (9, feat) or (
            skyh is not None and skyh.shape != (n_rays, fh)):
        raise ValueError(f"{name}: inconsistent shapes")
    for what, t, shape in (("z", z, (n_rays, n_s)),
                           ("noise", noise, (n_rays, n_s)), ("bn", bn, (9,))):
        if t is not None and (t.dtype != torch.float32 or t.shape != shape):
            raise ValueError(f"{what} must be {shape} fp32")
    for what, t in (("r", r), ("s2", s2), ("bh", bh)):
        if t is not None and (t.shape != (p, fh) or t.dtype != dtype):
            raise ValueError(f"{what} must be ({p}, {fh}) {dtype}")
    for what, t in (("skyh", skyh), ("wn", wn)):
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{what} must be {dtype}")
    return n_rays, n_s, p, feat, fh


# csrc/hopper.cuh SMEM_OPTIN_BYTES: the most shared memory a block may opt
# into on the H100 (227 KB); csrc/fused_train.cu CLB2_*, CLB_*: the block
# body's threads, warps and block sums, the warp body's warps and values a
# sample
SMEM_OPTIN_BYTES = 232448
# the widest trunk (F, and 2 Fh) the heads' adjoints (composite_loss_bwd,
# composite_bwd, field_heads_bwd) and field_heads hold
HEADS_MAX_FEATURES = 512
_CLB2_THREADS, _CLB2_WARPS, _CLB2_SUMS = 256, 8, 9
_CLB_WARPS, _CLB_SAMPLE_VALS = 4, 10


def _composite_smem_bytes(feat: int, fh: int, n_s: int, body: str) -> int:
    """The dynamic shared memory a launch of composite_loss_bwd /
    composite_bwd asks for: csrc/fused_train.cu clb2_smem_floats (the block
    body) and the warp body's CLB_WARPS * CLB_SAMPLE_VALS * S floats."""
    if body == "warp":
        return 4 * _CLB_WARPS * _CLB_SAMPLE_VALS * n_s
    pad8 = lambda v: -(-v // 8) * 8  # noqa: E731
    floats = (pad8(feat) + 8 * pad8(fh) + 12 * n_s + _CLB2_WARPS * _CLB2_SUMS
              + 4 + feat + 5 * fh + (n_s if n_s > _CLB2_THREADS else 0))
    return 4 * floats


def composite_max_samples(feat: int, fh: int, body: str = "block") -> int:
    """The most samples a ray composite_loss_bwd and composite_bwd take on
    the card with the body asked for, at a trunk of `feat` features and
    heads of `fh`: the largest S whose shared memory (the per-sample values
    of the ray, and the block body's narrow weights and sums) fits the 227
    KB a block may opt into. The C entry refuses past it by the same rule.
    The main path's 8 x 512 field: 4,129 (block), 1,452 (warp)."""
    _check_body(body)
    return _largest_fitting(lambda n_s: _composite_smem_bytes(feat, fh, n_s, body))


def _largest_fitting(nbytes) -> int:
    """The largest S with nbytes(S) within SMEM_OPTIN_BYTES; nbytes grows
    with S."""
    lo, hi = 0, SMEM_OPTIN_BYTES
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if nbytes(mid) <= SMEM_OPTIN_BYTES:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _refuse_samples(name: str, n_s: int, limit: int, who: str, feat: int,
                    fh: int) -> None:
    if n_s > limit:
        raise ValueError(
            f"{name}: {n_s} samples a ray do not fit the {SMEM_OPTIN_BYTES} "
            f"bytes (227 KB) of shared memory a block may hold; {who} takes "
            f"at most {limit} at F={feat}, Fh={fh}")


def _check_samples(name: str, feat: int, fh: int, n_s: int, body: str) -> None:
    _refuse_samples(name, n_s, composite_max_samples(feat, fh, body),
                    f"the {body} body", feat, fh)


def _adjoint_buffers(name, n_rays, p, feat, fh, use_beta, dev) -> dict:
    """The fp32 outputs the narrow heads' adjoints write (both
    instantiations of the compositor's, and field_heads_bwd): the cotangents
    of h, r, s2, bh, skyh, and dwn / dbn zero-filled for the kernel's
    atomics."""
    if feat > HEADS_MAX_FEATURES:
        raise ValueError(f"{name} holds at most {HEADS_MAX_FEATURES} features")

    def f32(*shape, make=torch.empty):
        return make(shape, dtype=torch.float32, device=dev)

    return {"d_h": f32(p, feat), "d_r": f32(p, fh), "d_s2": f32(p, fh),
            "d_bh": f32(p, fh) if use_beta else None,
            "d_skyh": f32(n_rays, fh), "dwn": f32(9, feat, make=torch.zeros),
            "dbn": f32(9, make=torch.zeros)}


def _check_body(body: str) -> None:
    if body not in COMPOSITE_BODIES:
        raise ValueError(f"body must be one of {COMPOSITE_BODIES}, got {body!r}")


def composite_loss_bwd(h, r, s2, bh, skyh, wn, bn, z, noise, gt, wmix: float,
                       *, rgb_padding: float = 0.001,
                       beta_min: float = L.BETA_MIN,
                       return_weights: bool = False,
                       body: str = "block") -> dict:
    """Narrow heads, compositor, loss and their adjoints; arguments and
    returns as composite_loss_bwd_reference. CUDA tensors launch the kernel
    with the body asked for: "block" (a block a ray) or "warp" (the walk of
    a warp a ray, to compare), counted in BODY_LAUNCHES; either takes as
    many samples a ray as its shared memory holds (composite_max_samples)."""
    _check_body(body)
    if z.device.type == "cpu":
        return composite_loss_bwd_reference(
            h, r, s2, bh, skyh, wn, bn, z, noise, gt, wmix,
            rgb_padding=rgb_padding, beta_min=beta_min,
            return_weights=return_weights)
    dtype = h.dtype
    _check_cuda(dtype, h=h, r=r, s2=s2, bh=bh, skyh=skyh, wn=wn, bn=bn, z=z,
                noise=noise, gt=gt)
    n_rays, n_s, p, feat, fh = _check_narrow("composite_loss_bwd", h, r, s2,
                                             bh, skyh, wn, bn, z, noise)
    if gt.dtype != torch.float32 or gt.shape != (n_rays, 3):
        raise ValueError(f"gt must be ({n_rays}, 3) fp32")
    _check_samples("composite_loss_bwd", feat, fh, n_s, body)
    res = _adjoint_buffers("composite_loss_bwd", n_rays, p, feat, fh,
                           bh is not None, z.device)
    res["loss_sums"] = torch.zeros(3, dtype=torch.float32, device=z.device)
    res["weights"] = (torch.empty((n_rays, n_s), dtype=torch.float32,
                                  device=z.device) if return_weights else None)
    _launch("composite_loss_bwd", _DTYPE_CODE[dtype], _ptr(h), feat, _ptr(r),
            _ptr(s2), _ptr(bh), _ptr(skyh), fh, _ptr(wn), _ptr(bn), _ptr(z),
            _ptr(noise), _ptr(gt), n_rays, n_s, float(rgb_padding),
            float(beta_min), float(wmix), _ptr(res["loss_sums"]),
            _ptr(res["weights"]), _ptr(res["d_h"]), _ptr(res["d_r"]),
            _ptr(res["d_s2"]), _ptr(res["d_bh"]), _ptr(res["d_skyh"]),
            _ptr(res["dwn"]), _ptr(res["dbn"]), _BODY_CODE[body], _stream(z),
            body=body)
    return res


# -------------------------------------------------------------- composite_bwd


def composite_bwd_reference(h, r, s2, bh, skyh, wn, bn, z, noise, g, *,
                            rgb_padding: float = 0.001) -> dict:
    """Plain version of composite_bwd, by autograd: the vector-Jacobian
    product of heads_composite_reference's (R, 16) products with the cotangent
    g (R, 16) fp32, all seven products honoured (rgb through its clip, depth,
    sun, sky, beta, albedo, opacity). Other arguments as
    composite_loss_bwd_reference. Returns its d_h, d_r, d_s2, d_bh, d_skyh,
    dwn, dbn."""
    def contracted(hf, rf, sf, bf, skyf, wn_l, bn_l):
        out, _ = _heads_products(hf, rf, sf, bf, skyf, wn_l, bn_l, z, noise,
                                 rgb_padding, wn.dtype)
        return (out * g).sum(), None

    return _narrow_adjoint(contracted, h, r, s2, bh, skyh, wn, bn)[0]


def composite_bwd(h, r, s2, bh, skyh, wn, bn, z, noise, g, *,
                  rgb_padding: float = 0.001, body: str = "block") -> dict:
    """The adjoint of heads_composite from a given cotangent; arguments and
    returns as composite_bwd_reference. CUDA tensors launch the kernel with
    the body asked for, as composite_loss_bwd."""
    _check_body(body)
    if z.device.type == "cpu":
        return composite_bwd_reference(h, r, s2, bh, skyh, wn, bn, z, noise,
                                       g, rgb_padding=rgb_padding)
    dtype = h.dtype
    _check_cuda(dtype, h=h, r=r, s2=s2, bh=bh, skyh=skyh, wn=wn, bn=bn, z=z,
                noise=noise, g=g)
    n_rays, n_s, p, feat, fh = _check_narrow("composite_bwd", h, r, s2, bh,
                                             skyh, wn, bn, z, noise)
    if g.dtype != torch.float32 or g.shape != (n_rays, OUT_COLS):
        raise ValueError(f"g must be ({n_rays}, {OUT_COLS}) fp32")
    _check_samples("composite_bwd", feat, fh, n_s, body)
    res = _adjoint_buffers("composite_bwd", n_rays, p, feat, fh,
                           bh is not None, z.device)
    _launch("composite_bwd", _DTYPE_CODE[dtype], _ptr(h), feat, _ptr(r),
            _ptr(s2), _ptr(bh), _ptr(skyh), fh, _ptr(wn), _ptr(bn), _ptr(z),
            _ptr(noise), _ptr(g), n_rays, n_s, float(rgb_padding),
            _ptr(res["d_h"]), _ptr(res["d_r"]), _ptr(res["d_s2"]),
            _ptr(res["d_bh"]), _ptr(res["d_skyh"]), _ptr(res["dwn"]),
            _ptr(res["dbn"]), _BODY_CODE[body], _stream(z), body=body)
    return res


# ---------------------------------------------------------------- sc_loss_bwd


def sc_loss_bwd_reference(h, s2, wn, bn, z, noise, lam3: float) -> dict:
    """Plain version of sc_loss_bwd, by autograd over the sigma and sun_v
    heads, render/composite.py ray_weights and
    train/losses.solar_correction_terms.

    h (P, F) the trunk output and s2 (P, Fh) the sun_v hidden, both along
    the SUN rays, and wn (9, F) in the compute dtype (rows 0 and 4 are read);
    bn (9,), z (R, S), noise (R, S) or None fp32; lam3 = lambda_sc / 3.
    Returns fp32 tensors:
      sums (2,) [sum_r sum_s (T - sun_v)^2, sum_r (1 - sum_s w * sun_v)]
      d_s2 (P, Fh) the cotangent of s2 of lam3 / R * (sums[0] + sums[1]),
      already through the sun_v output's sigmoid
      dwn (9, F), dbn (9,): zero outside row 4
    Transparency and weights are detached, so nothing reaches h.
    """
    n_rays, n_s = z.shape
    fh = s2.shape[1]

    def terms(hf, rf, sf, bf, skyf, wn_l, bn_l):
        dt = wn.dtype
        sigma = F.softplus(rounded_matmul(hf, wn_l[0:1], dt)[:, 0] + bn_l[0])
        sunv = torch.sigmoid(rounded_matmul(sf, wn_l[4:5, :fh], dt)[:, 0]
                             + bn_l[4]).reshape(n_rays, n_s)
        _, trans, w = ray_weights(sigma.reshape(n_rays, n_s), z, noise)
        res = {"sun_sc_coarse": sunv[..., None],
               "transparency_sc_coarse": trans, "weights_sc_coarse": w}
        t2, t3 = L.solar_correction_terms(res, "coarse", 3.0 * lam3)
        trans, w = trans.detach(), w.detach()
        sums = torch.stack([((trans - sunv) ** 2).sum(),
                            (1.0 - (w * sunv).sum(1)).sum()])
        return t2 + t3, sums.detach()

    cot, sums = _narrow_adjoint(terms, h, None, s2, None, None, wn, bn)
    return {"sums": sums, "d_s2": cot["d_s2"], "dwn": cot["dwn"],
            "dbn": cot["dbn"]}


# csrc/fused_aux.cu: the block sums of sc_loss_bwd (term 2, w sun_v, dbn[4])
_SC_SUMS = 3


def _sc_smem_bytes(feat: int, fh: int, n_s: int) -> int:
    """The dynamic shared memory a launch of sc_loss_bwd asks for:
    csrc/fused_aux.cu sc_smem_floats (the block sums' scratch in doubles;
    w_sigma, w_sun and each of the 8 warps' column sums of dWn row 4, rows
    padded to a multiple of 8; sigma, sun_v and the rounded cotangent a
    sample)."""
    pad8 = lambda v: -(-v // 8) * 8  # noqa: E731
    return 4 * (2 * _CLB2_WARPS * _SC_SUMS + pad8(feat)
                + (1 + _CLB2_WARPS) * pad8(fh) + 3 * n_s)


@functools.lru_cache(maxsize=None)
def sc_max_samples(feat: int, fh: int) -> int:
    """The most samples a ray sc_loss_bwd takes on the card at a trunk of
    `feat` features and a sun_v hidden layer of `fh`: the largest S whose
    shared memory (three floats a sample, the two weight rows and the warps'
    sums of dWn row 4) fits the 227 KB a block may opt into. The C entry refuses past it by the same
    rule. The main path's 8 x 512 field: 18,416."""
    return _largest_fitting(lambda n_s: _sc_smem_bytes(feat, fh, n_s))


def _check_sc_samples(feat: int, fh: int, n_s: int) -> None:
    _refuse_samples("sc_loss_bwd", n_s, sc_max_samples(feat, fh), "the kernel",
                    feat, fh)


def sc_loss_bwd(h, s2, wn, bn, z, noise, lam3: float) -> dict:
    """The solar-correction terms and the sun_v head's adjoint; arguments and
    returns as sc_loss_bwd_reference. CUDA tensors launch the kernel; more
    samples a ray than sc_max_samples are refused (ValueError)."""
    if z.device.type == "cpu":
        return sc_loss_bwd_reference(h, s2, wn, bn, z, noise, lam3)
    dtype = h.dtype
    _check_cuda(dtype, h=h, s2=s2, wn=wn, bn=bn, z=z, noise=noise)
    n_rays, n_s, p, feat, fh = _check_narrow("sc_loss_bwd", h, None, s2, None,
                                             None, wn, bn, z, noise)
    if fh > feat:
        raise ValueError(f"sc_loss_bwd: the sun_v hidden layer ({fh}) is "
                         f"wider than the trunk ({feat})")
    _check_sc_samples(feat, fh, n_s)
    dev = z.device
    res = {"sums": torch.zeros(2, dtype=torch.float32, device=dev),
           "d_s2": torch.empty((p, fh), dtype=torch.float32, device=dev),
           "dwn": torch.zeros((9, feat), dtype=torch.float32, device=dev),
           "dbn": torch.zeros(9, dtype=torch.float32, device=dev)}
    _launch("sc_loss_bwd", _DTYPE_CODE[dtype], _ptr(h), feat, _ptr(s2), fh,
            _ptr(wn), _ptr(bn), _ptr(z), _ptr(noise), n_rays, n_s,
            float(lam3) / n_rays, _ptr(res["sums"]), _ptr(res["d_s2"]),
            _ptr(res["dwn"]), _ptr(res["dbn"]), _stream(z))
    return res


# ------------------------------------------------------------ the training chains


class TrainOps:
    """The stage functions the training chains run. A check swaps in its own
    to see each launch's inputs, as `_render_staged` allows."""

    dense = staticmethod(siren_dense)
    composite = staticmethod(composite_loss_bwd)
    sc = staticmethod(sc_loss_bwd)
    dgrad = staticmethod(siren_dense_dgrad)
    wgrad = staticmethod(siren_dense_wgrad)
    narrow = staticmethod(narrow_grads)


def _chain_forward(p: dict, rays16, z, *, skip: int, use_beta: bool,
                   sun_only: bool = False, ops=TrainOps) -> dict:
    """The field's dense layers with every sine layer's slope saved: the
    forward half K1, K3 and K4 share. p: pack_params output. With sun_only
    (K3) the rgb, beta and sky heads, which terms 2 and 3 do not read, are
    left out. Returns the activations and slopes `_chain_backward` needs."""
    n_s = z.shape[1]

    def dense(x, w, bias, extra=None, ew=None, w0=1.0):
        return ops.dense(x, w, bias, rays16, n_s, extra=extra, extra_weight=ew,
                         z=z, w0=w0, act="sin", save=True)

    a = {"hs": [], "slopes": []}
    h, c = dense(None, None, p["bt"][0], "xyz", p["A"], w0=30.0)
    a["hs"].append(h), a["slopes"].append(c)
    for l, w in enumerate(p["B"], start=1):
        h, c = (dense(h, w, p["bt"][l], "xyz", p["C"]) if l == skip
                else dense(h, w, p["bt"][l]))
        a["hs"].append(h), a["slopes"].append(c)
    a["h"] = h
    feats = a["feats"] = ops.dense(h, p["Wfeat"], p["bfeat"], rays16, n_s,
                                   act="none")
    if not sun_only:
        a["r"], a["c_r"] = dense(feats, p["Wrgb0"], p["brgb0"])
    a["s0"], a["c_s0"] = dense(feats, p["Wsun0h"], p["bsun0"], "sun",
                               p["Wsun0d"])
    a["s1"], a["c_s1"] = dense(a["s0"], p["Wsun1"], p["bsun1"])
    a["s2"], a["c_s2"] = dense(a["s1"], p["Wsun2"], p["bsun2"])
    if sun_only:
        return a
    a["bh"] = a["c_bh"] = None
    if use_beta:
        a["bh"], a["c_bh"] = dense(feats, p["Wbeta0h"], p["bbeta0"], "t",
                                   p["Wbeta0t"])
    # sky_0 sees sun_dir only, so it runs once a ray (samples = 1)
    a["skyh"] = ops.dense(None, None, p["bsky0"], rays16, 1, extra="sun",
                          extra_weight=p["Wsky0"], act="relu")
    return a


def _chain_backward(p: dict, a: dict, cot: dict, rays16, z, *, skip: int,
                    use_beta: bool, ops=TrainOps,
                    input_grads: Optional[dict] = None):
    """A dgrad and a wgrad launch per dense layer: the backward half K1, K3,
    K4, K5 and K6 share. a: `_chain_forward`'s output; cot: the per-ray stage's
    d_h, d_r, d_s2, d_bh, d_skyh, dwn, dbn, each fp32 and in its own buffers
    (wgrad sums by atomics into zero-filled tensors it allocates itself, so
    nothing accumulates across passes). A head whose cotangent is missing or
    None (K3: all but sun_v) is skipped and gets no entry in g. Given a
    dict as input_grads (K6), every layer with an E operand is also asked for
    the gradient of E, and the per-ray sums are left in it: "xyz" (R, 3) from
    layer 0 and the skip layer, "sun" (R, 3) from sun_v_0 and sky_0. The
    narrow gradients the heads leave to narrow_grads (sun_v_0's, sky_0's,
    beta_0's t_grad) go in one launch after beta_0. Returns (g in the layout
    of p, t_grad (R, tau) or None)."""
    n_s = z.shape[1]
    want_in = input_grads is not None
    g = {"wn": cot["dwn"], "bn": cot["dbn"], "B": [None] * len(p["B"]),
         "bt": [None] * len(p["bt"]), "C": None}
    feats, d_feats = a["feats"], None
    heads_narrow = []  # the heads' narrow_grads jobs, launched together

    def wgrad(x, dy, slope, extra=None, ew=None, samples=n_s, extra_grad=False,
              defer=None):
        return ops.wgrad(x, dy, slope, rays16, samples, extra=extra,
                         extra_weight=ew, z=z, extra_grad=extra_grad,
                         defer=defer)

    # heads, in the JAX kernel's order: rgb, sun, sky, beta
    if cot.get("d_r") is not None:
        g["Wrgb0"], g["brgb0"], _, _ = wgrad(feats, cot["d_r"], a["c_r"])
        d_feats = ops.dgrad(cot["d_r"], a["c_r"], p["Wrgb0"])
    g["Wsun2"], g["bsun2"], _, _ = wgrad(a["s1"], cot["d_s2"], a["c_s2"])
    d_s1 = ops.dgrad(cot["d_s2"], a["c_s2"], p["Wsun2"])
    g["Wsun1"], g["bsun1"], _, _ = wgrad(a["s0"], d_s1, a["c_s1"])
    d_s0 = ops.dgrad(d_s1, a["c_s1"], p["Wsun1"])
    g["Wsun0h"], g["bsun0"], g["Wsun0d"], d_sun = wgrad(
        feats, d_s0, a["c_s0"], "sun", p["Wsun0d"], extra_grad=want_in,
        defer=heads_narrow)
    d_feats = ops.dgrad(d_s0, a["c_s0"], p["Wsun0h"], out=d_feats)
    d_sun_sky = None
    if cot.get("d_skyh") is not None:
        _, g["bsky0"], g["Wsky0"], d_sun_sky = wgrad(
            None, cot["d_skyh"], None, "sun", p["Wsky0"], samples=1,
            extra_grad=want_in, defer=heads_narrow)
    t_grad = None
    if use_beta and cot.get("d_bh") is not None:
        g["Wbeta0h"], g["bbeta0"], g["Wbeta0t"], t_grad = wgrad(
            feats, cot["d_bh"], a["c_bh"], "t", p["Wbeta0t"], extra_grad=True,
            defer=heads_narrow)
        d_feats = ops.dgrad(cot["d_bh"], a["c_bh"], p["Wbeta0h"], out=d_feats)
    if heads_narrow:
        ops.narrow(heads_narrow)
    if want_in and d_sun_sky is not None:
        d_sun = d_sun + d_sun_sky

    # feats and sigma meet in the trunk output
    g["Wfeat"], g["bfeat"], _, _ = wgrad(a["h"], d_feats, None)
    d_h = ops.dgrad(d_feats, None, p["Wfeat"], out=cot.get("d_h"))

    hs, slopes = a["hs"], a["slopes"]
    d_xyz_skip = None
    for l in range(len(p["B"]), 0, -1):
        if l == skip:
            g["B"][l - 1], g["bt"][l], g["C"], d_xyz_skip = wgrad(
                hs[l - 1], d_h, slopes[l], "xyz", p["C"], extra_grad=want_in)
        else:
            g["B"][l - 1], g["bt"][l], _, _ = wgrad(hs[l - 1], d_h, slopes[l])
        d_h = ops.dgrad(d_h, slopes[l], p["B"][l - 1])
    _, g["bt"][0], g["A"], d_xyz = wgrad(None, d_h, slopes[0], "xyz", p["A"],
                                         extra_grad=want_in)
    if want_in:
        input_grads["sun"] = d_sun
        input_grads["xyz"] = (d_xyz if d_xyz_skip is None
                              else d_xyz + d_xyz_skip)
    return g, t_grad


def _train_staged(p: dict, rays16, z, noise, gt, wmix: float, *, skip: int,
                  use_beta: bool, rgb_padding: float, beta_min: float,
                  return_weights: bool, ops=TrainOps):
    """The kernel chain of one training step (K1): the forward with saved
    slopes, composite_loss_bwd, the backward. p: pack_params output.
    Returns (loss_sums (3,), g, t_grad (R, tau) or None, weights or None)
    with g the gradients in the layout of p (fp32)."""
    a = _chain_forward(p, rays16, z, skip=skip, use_beta=use_beta, ops=ops)
    out = ops.composite(a["h"], a["r"], a["s2"], a["bh"], a["skyh"], p["wn"],
                        p["bn"], z, noise, gt, wmix, rgb_padding=rgb_padding,
                        beta_min=beta_min, return_weights=return_weights)
    g, t_grad = _chain_backward(p, a, out, rays16, z, skip=skip,
                                use_beta=use_beta, ops=ops)
    return out["loss_sums"], g, t_grad, out["weights"]


def _sc_staged(p: dict, rays16, z, noise, lam3: float, *, skip: int,
               use_beta: bool, ops=TrainOps):
    """The kernel chain of the solar-correction pass (K3). rays16 holds the
    sun direction in its direction columns too (the march direction is the
    sun direction). Forward: trunk, feats, sun_v_0..2 (12 launches);
    sc_loss_bwd; backward through sun_v_2..0, feats and the trunk (12 wgrad,
    11 dgrad). The rgb, sky and beta heads do not enter terms 2 and 3: their
    layers are left out of the chain and their gradients returned as zeros,
    as are the narrow rows other than sun_v's. Returns (sums (2,), g)."""
    a = _chain_forward(p, rays16, z, skip=skip, use_beta=use_beta,
                       sun_only=True, ops=ops)
    out = ops.sc(a["h"], a["s2"], p["wn"], p["bn"], z, noise, lam3)
    g, _ = _chain_backward(p, a, out, rays16, z, skip=skip, use_beta=use_beta,
                           ops=ops)
    for k, w in p.items():  # the heads the chain left out
        if k not in g:
            g[k] = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    return out["sums"], g


def unpack_grads(g: dict, field, *, skip: int, use_beta: bool) -> dict:
    """Kernel-layout gradients -> {parameter name: gradient shaped like the
    parameter}, keyed as field.named_parameters(). Undoes every split of
    pack_params: the skip layer's xyz rows C and h rows, sun_v_net.0's h and
    sun_dir rows, beta_from_xyz.0's h and t rows, the nine narrow rows of
    wn / bn. Counterpart of fused_mlp.py:224."""
    fh = field.feat // 2
    out = {}

    def put(name, kernel_w, bias):  # (in, out) -> Linear.weight (out, in)
        out[f"{name}.weight"] = kernel_w.t().contiguous()
        out[f"{name}.bias"] = bias

    put("fc_net.0", g["A"], g["bt"][0])
    for l in range(1, field.layers):
        w = g["B"][l - 1]
        if l == skip:
            w = torch.cat([g["C"], w], dim=0)
        put(f"fc_net.{2 * l}", w, g["bt"][l])
    wn, bn = g["wn"], g["bn"]
    out["sigma_from_xyz.0.weight"], out["sigma_from_xyz.0.bias"] = wn[0:1], bn[0:1]
    put("feats_from_xyz", g["Wfeat"], g["bfeat"])
    put("rgb_from_xyzdir.0", g["Wrgb0"], g["brgb0"])
    out["rgb_from_xyzdir.2.weight"], out["rgb_from_xyzdir.2.bias"] = wn[1:4, :fh], bn[1:4]
    put("sun_v_net.0", torch.cat([g["Wsun0h"], g["Wsun0d"]], dim=0), g["bsun0"])
    put("sun_v_net.2", g["Wsun1"], g["bsun1"])
    put("sun_v_net.4", g["Wsun2"], g["bsun2"])
    out["sun_v_net.6.weight"], out["sun_v_net.6.bias"] = wn[4:5, :fh], bn[4:5]
    put("sky_color.0", g["Wsky0"], g["bsky0"])
    out["sky_color.2.weight"], out["sky_color.2.bias"] = wn[5:8, :fh], bn[5:8]
    if use_beta:
        put("beta_from_xyz.0", torch.cat([g["Wbeta0h"], g["Wbeta0t"]], dim=0),
            g["bbeta0"])
        out["beta_from_xyz.2.weight"], out["beta_from_xyz.2.bias"] = wn[8:9, :fh], bn[8:9]
    return out


def _loss_parts(sums, n_rays: int) -> dict:
    """fused_mlp.py:1915-1919."""
    return {"color_sat": sums[0] / (3.0 * n_rays),
            "logbeta": (3.0 + sums[1] / n_rays) / 2.0,
            "mse": sums[2] / (3.0 * n_rays)}


def fused_train_loss_grads_reference(params, rays_o, rays_d, sun_dir, t_embed,
                                     z_vals, noise, gt_rgb, use_beta_w, *,
                                     layers: int = 8, feat: int = 512,
                                     skip: int = 4, use_beta: bool = True,
                                     rgb_padding: float = 0.001,
                                     beta_min: float = L.BETA_MIN, tau: int = 4,
                                     dtype=torch.bfloat16,
                                     return_weights: bool = False):
    """Plain version of fused_train_loss_grads: the field module on o + d*z,
    render/composite.py, train/losses.py and torch.autograd.grad. The field's
    matmuls round their operands, and in the backward their cotangents, to
    `dtype` where the JAX kernel does (models/nerf.py rounded_matmul).
    Used by the tests and by CPU systems."""
    _check_field(params, layers, feat, skip, use_beta, tau, rgb_padding)
    if beta_min != L.BETA_MIN:
        raise ValueError("the plain version takes its beta_min from "
                         "train/losses.py")
    n_rays = z_vals.shape[0]
    wmix = float(use_beta_w) if use_beta else 0.0
    leaves = list(params.parameters())
    t_leaf = None
    if use_beta:
        t_leaf = t_embed.detach().float().requires_grad_(True)
    with torch.enable_grad():
        res = run_field(params, rays_o.float(), rays_d.float(), None,
                        sun_dir.float(), t_leaf, z_vals.float(), shadow=True,
                        dtype=dtype, noise=noise)
        res = {f"{k}_coarse": v for k, v in res.items()}
        gt = gt_rgb.float()
        mse, _ = L.snerf_loss(res, gt, 0.0)
        sq = ((res["rgb_coarse"] - gt) ** 2).sum()
        if use_beta:
            color, logbeta = L.uncertainty_aware_terms(res, gt, "coarse")
            parts = {"color_sat": color, "logbeta": logbeta, "mse": mse}
            loss = wmix * (color + logbeta) + (1.0 - wmix) * mse
        else:
            parts = _loss_parts(torch.stack([sq.new_zeros(()),
                                             sq.new_zeros(()), sq]), n_rays)
            loss = mse
        grads = torch.autograd.grad(
            loss, leaves + ([t_leaf] if use_beta else []), allow_unused=True)
    names = [n for n, _ in params.named_parameters()]
    param_grads = {n: (torch.zeros_like(q) if g is None else g)
                   for n, g, q in zip(names, grads, leaves)}
    parts = {k: v.detach() for k, v in parts.items()}
    t_grad = (grads[-1] if use_beta
              else torch.zeros((n_rays, tau), device=z_vals.device))
    if return_weights:
        return parts, param_grads, t_grad, res["weights_coarse"].detach()
    return parts, param_grads, t_grad


def fused_train_loss_grads(params, rays_o, rays_d, sun_dir, t_embed, z_vals,
                           noise, gt_rgb, use_beta_w, *, layers: int = 8,
                           feat: int = 512, skip: int = 4,
                           use_beta: bool = True, rgb_padding: float = 0.001,
                           beta_min: float = L.BETA_MIN, tau: int = 4,
                           dtype=torch.bfloat16, return_weights: bool = False):
    """Training path: the primary pass' loss and gradients.

    params: the s-nerf / sat-nerf RadianceField. rays_o, rays_d, sun_dir
    (R, 3); t_embed (R, tau) (sat-nerf); z_vals (R, S); noise (R, S) sigma
    noise or None; gt_rgb (R, 3); use_beta_w the beta warm-up gate in [0, 1]
    (ignored without the beta head). Returns (parts, param_grads, t_grad):
      parts        {"color_sat", "logbeta", "mse"} scalar loss components
      param_grads  {parameter name: gradient} keyed as
                   params.named_parameters(), of
                   wmix * (color_sat + logbeta) + (1 - wmix) * mse
                   (of mse without the beta head)
      t_grad       (R, tau) per-ray gradient of t_embed, to be summed onto
                   the embedding table by image id
    and with return_weights a fourth, the (R, S) compositing weights.

    On CUDA tensors this launches the kernel chain `_train_staged`; nothing
    in it goes through autograd, and the weights are packed anew from
    `params` on every call. On CPU tensors it runs
    fused_train_loss_grads_reference.
    """
    kw = dict(layers=layers, feat=feat, skip=skip, use_beta=use_beta,
              rgb_padding=rgb_padding, beta_min=beta_min, tau=tau, dtype=dtype,
              return_weights=return_weights)
    if z_vals.device.type == "cpu":
        return fused_train_loss_grads_reference(
            params, rays_o, rays_d, sun_dir, t_embed, z_vals, noise, gt_rgb,
            use_beta_w, **kw)
    _check_card_call("fused_train_loss_grads", params, z_vals, sun_dir,
                     t_embed, layers, feat, skip, use_beta, tau, rgb_padding)
    n_rays = z_vals.shape[0]
    with torch.no_grad():
        rays16 = pack_rays(rays_o, rays_d, sun_dir,
                           t_embed if use_beta else None, tau)
        z = z_vals.float().contiguous()
        nz = None if noise is None else noise.float().contiguous()
        gt = gt_rgb.float().contiguous()
        packed = pack_params(params, skip=skip, use_beta=use_beta, dtype=dtype)
        sums, g, t_grad, weights = _train_staged(
            packed, rays16, z, nz, gt, float(use_beta_w) if use_beta else 0.0,
            skip=skip, use_beta=use_beta, rgb_padding=rgb_padding,
            beta_min=beta_min, return_weights=return_weights)
        parts = _loss_parts(sums, n_rays)
        param_grads = unpack_grads(g, params, skip=skip, use_beta=use_beta)
        if t_grad is None:
            t_grad = torch.zeros((n_rays, tau), device=z.device)
    if return_weights:
        return parts, param_grads, t_grad, weights
    return parts, param_grads, t_grad


# ================================================= the solar-correction pass
#
# K3, fused_sc_loss_grads: the forward chain along the sun rays (trunk, feats,
# sun_v head), sc_loss_bwd, then the backward through the same layers.


def fused_sc_loss_grads_reference(params, rays_o, sun_dir, t_embed, z_vals,
                                  noise, lambda_sc: float, *, layers: int = 8,
                                  feat: int = 512, skip: int = 4,
                                  use_beta: bool = True,
                                  rgb_padding: float = 0.001, tau: int = 4,
                                  dtype=torch.bfloat16):
    """Plain version of fused_sc_loss_grads: the field module on
    o + sun_dir * z with sun_dir as its sun input too, render/composite.py,
    train/losses.solar_correction_terms (which detaches transparency and
    weights) and torch.autograd.grad."""
    _check_field(params, layers, feat, skip, use_beta, tau, rgb_padding)
    leaves = list(params.parameters())
    sun = sun_dir.float()
    with torch.enable_grad():
        res = run_field(params, rays_o.float(), sun, None, sun,
                        t_embed.detach().float() if use_beta else None,
                        z_vals.float(), shadow=True, dtype=dtype, noise=noise)
        t2, t3 = L.solar_correction_terms(
            {"sun_sc_coarse": res["sun"],
             "transparency_sc_coarse": res["transparency"],
             "weights_sc_coarse": res["weights"]}, "coarse", lambda_sc)
        grads = torch.autograd.grad(t2 + t3, leaves, allow_unused=True)
    param_grads = {n: (torch.zeros_like(q) if g is None else g)
                   for (n, q), g in zip(params.named_parameters(), grads)}
    return {"term2": t2.detach(), "term3": t3.detach()}, param_grads


def fused_sc_loss_grads(params, rays_o, sun_dir, t_embed, z_vals, noise,
                        lambda_sc: float, *, layers: int = 8, feat: int = 512,
                        skip: int = 4, use_beta: bool = True,
                        rgb_padding: float = 0.001, tau: int = 4,
                        dtype=torch.bfloat16):
    """The secondary, sun-ray pass of the solar correction.

    params: the s-nerf / sat-nerf RadianceField. rays_o, sun_dir (R, 3);
    t_embed (R, tau) (sat-nerf; it gets no gradient: only the beta head reads
    it, and beta has no solar-correction cotangent); z_vals (R, S), the
    primary pass's depths; noise (R, S), this pass's own sigma noise, or
    None. Returns (parts, param_grads): parts = {"term2", "term3"}, already
    scaled by lambda_sc / 3 and averaged over the R rays, and the gradient of
    term2 + term3 keyed as params.named_parameters(). Transparency and
    weights carry no gradient (reference metrics.py:27-34), so every
    parameter outside the trunk, feats_from_xyz and sun_v_net gets zeros.

    On CUDA tensors this launches the kernel chain `_sc_staged`; on CPU
    tensors it runs fused_sc_loss_grads_reference.
    """
    kw = dict(layers=layers, feat=feat, skip=skip, use_beta=use_beta,
              rgb_padding=rgb_padding, tau=tau, dtype=dtype)
    if z_vals.device.type == "cpu":
        return fused_sc_loss_grads_reference(params, rays_o, sun_dir, t_embed,
                                             z_vals, noise, lambda_sc, **kw)
    _check_card_call("fused_sc_loss_grads", params, z_vals, sun_dir, t_embed,
                     layers, feat, skip, use_beta, tau, rgb_padding)
    n_rays = z_vals.shape[0]
    lam3 = float(lambda_sc) / 3.0
    with torch.no_grad():
        rays16 = pack_rays(rays_o, sun_dir, sun_dir,
                           t_embed if use_beta else None, tau)
        z = z_vals.float().contiguous()
        nz = None if noise is None else noise.float().contiguous()
        packed = pack_params(params, skip=skip, use_beta=use_beta, dtype=dtype)
        sums, g = _sc_staged(packed, rays16, z, nz, lam3, skip=skip,
                             use_beta=use_beta)
        parts = {"term2": lam3 * sums[0] / n_rays,
                 "term3": lam3 * sums[1] / n_rays}
        param_grads = unpack_grads(g, params, skip=skip, use_beta=use_beta)
    return parts, param_grads


# ================================================== the differentiable render
#
# K4, fused_train_render_rays: forward = the training chain's forward and
# heads_composite with noise; backward = composite_bwd and the training
# chain's backward.


class _TrainRender(torch.autograd.Function):
    """(t_embed, the field's parameters) -> (R, 16) products on the card.
    The forward keeps the chain's activations and fp32 slopes on the node
    (about 1.4 GB at 65,536 points of an 8 x 512 field); the backward frees
    them when it has run, and so does dropping the graph."""

    @staticmethod
    def forward(ctx, field, cfg: dict, rays_o, rays_d, sun_dir, z, noise,
                t_embed, *weights):
        skip, use_beta = cfg["skip"], cfg["use_beta"]
        rays16 = pack_rays(rays_o, rays_d, sun_dir, t_embed, cfg["tau"])
        packed = pack_params(field, skip=skip, use_beta=use_beta,
                             dtype=cfg["dtype"])
        a = _chain_forward(packed, rays16, z, skip=skip, use_beta=use_beta)
        out, _ = heads_composite(a["h"], a["r"], a["s2"], a["bh"], a["skyh"],
                                 packed["wn"], packed["bn"], z, noise=noise,
                                 rgb_padding=cfg["rgb_padding"])
        ctx.field, ctx.cfg = field, cfg
        ctx.chain = (packed, rays16, z, noise, a)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        packed, rays16, z, noise, a = ctx.chain
        ctx.chain = None  # the slopes go as soon as the backward has read them
        cfg = ctx.cfg
        skip, use_beta = cfg["skip"], cfg["use_beta"]
        cot = composite_bwd(a["h"], a["r"], a["s2"], a["bh"], a["skyh"],
                            packed["wn"], packed["bn"], z, noise,
                            g.float().contiguous(),
                            rgb_padding=cfg["rgb_padding"])
        gk, t_grad = _chain_backward(packed, a, cot, rays16, z, skip=skip,
                                     use_beta=use_beta)
        grads = unpack_grads(gk, ctx.field, skip=skip, use_beta=use_beta)
        return (None,) * 7 + (t_grad,) + tuple(
            grads[n] for n, _ in ctx.field.named_parameters())


def fused_train_render_rays_reference(params, rays_o, rays_d, sun_dir, t_embed,
                                      z_vals, noise=None, **kw) -> dict:
    """Plain version of fused_train_render_rays: fused_render_rays_reference
    with the sigma noise, left to plain autograd (the field's matmuls round
    their cotangents where the kernels do, models/nerf.py rounded_matmul)."""
    return fused_render_rays_reference(params, rays_o, rays_d, sun_dir,
                                       t_embed, z_vals, noise=noise, **kw)


def fused_train_render_rays(params, rays_o, rays_d, sun_dir, t_embed, z_vals,
                            noise=None, *, layers: int = 8, feat: int = 512,
                            skip: int = 4, use_beta: bool = True,
                            rgb_padding: float = 0.001, tau: int = 4,
                            dtype=torch.bfloat16) -> dict:
    """Training path: the render of rays to per-ray products, differentiable.

    Arguments as fused_render_rays, plus noise (R, S), the training sigma
    noise, or None. Returns {"rgb" (R, 3), "depth" (R,), "sun" (R, 1), "sky"
    (R, 3), "albedo" (R, 3), "opacity" (R,)} and "beta" (R, 1) for sat-nerf,
    where beta is the weight-integrated per-ray uncertainty. Gradients flow
    to the parameters of `params` and to t_embed; z_vals and noise get none.

    On CUDA tensors forward and backward are kernel chains (`_TrainRender`);
    on CPU tensors it runs fused_train_render_rays_reference.
    """
    kw = dict(layers=layers, feat=feat, skip=skip, use_beta=use_beta,
              rgb_padding=rgb_padding, tau=tau, dtype=dtype)
    if z_vals.device.type == "cpu":
        return fused_train_render_rays_reference(params, rays_o, rays_d,
                                                 sun_dir, t_embed, z_vals,
                                                 noise, **kw)
    _check_card_call("fused_train_render_rays", params, z_vals, sun_dir,
                     t_embed, layers, feat, skip, use_beta, tau, rgb_padding)
    cfg = dict(skip=skip, use_beta=use_beta, rgb_padding=rgb_padding, tau=tau,
               dtype=dtype)
    out = _TrainRender.apply(
        params, cfg, rays_o.detach(), rays_d.detach(), sun_dir.detach(),
        z_vals.detach().float().contiguous(),
        None if noise is None else noise.detach().float().contiguous(),
        t_embed if use_beta else None, *params.parameters())
    return _products(out, None, use_beta)


# ====================================================== the per-sample field
#
# K5, fused_field_apply_rays, and K6, fused_field_apply: forward = the dense
# chain and field_heads; backward = field_heads_bwd and the training chain's
# backward. K6 is K5 on points that are their own rays: samples = 1,
# rays16 = [xyz | 0 | sun | t] and z = 0, so the E operand o + d*z is xyz.


def field_heads_reference(h, r, s2, bh, skyh, wn, bn, samples: int, *,
                          rgb_padding: float = 0.001, dtype=None):
    """Plain version of field_heads (differentiable).

    h (P, F), r/s2/bh (P, Fh) (bh None without the beta head), skyh (R, Fh)
    with P = R * samples, wn (9, F) in the compute dtype (`dtype`, else
    wn's); bn (9,) fp32. Returns (P, 16) fp32, per sample: rgb 0:3 (padded),
    sigma 3 (softplus, before noise and relu), sun_v 4, sky 5:8 (the ray's),
    beta 8 (0 without the beta head), zeros after.
    """
    sigma, rgb, sunv, sky, beta = _narrow_heads(h, r, s2, bh, skyh, wn, bn,
                                                rgb_padding, dtype=dtype)
    sky = sky.repeat_interleave(samples, dim=0)
    pad = torch.zeros((h.shape[0], FIELD_COLS - 9), dtype=torch.float32,
                      device=h.device)
    return torch.cat([rgb, sigma[:, None], sunv[:, None], sky, beta[:, None],
                      pad], dim=1)


def _check_field_heads(name, h, r, s2, bh, skyh, wn, bn, samples: int):
    """Shapes and dtypes field_heads and its backward share; (R, P, F, Fh)."""
    dtype = h.dtype
    p, feat = h.shape
    fh = s2.shape[1]
    if samples < 1 or p % samples or p >= 2 ** 31:
        raise ValueError(f"{name}: {p} points are not rays of {samples} "
                         f"samples (or exceed the kernel's int32 indexing)")
    n_rays = p // samples
    if feat > HEADS_MAX_FEATURES or 2 * fh > HEADS_MAX_FEATURES:
        raise ValueError(f"{name} holds at most {HEADS_MAX_FEATURES} features")
    if (wn.shape != (9, feat) or skyh.shape != (n_rays, fh)
            or bn.shape != (9,) or bn.dtype != torch.float32):
        raise ValueError(f"{name}: inconsistent shapes")
    for what, t in (("r", r), ("s2", s2), ("bh", bh)):
        if t is not None and (t.shape != (p, fh) or t.dtype != dtype):
            raise ValueError(f"{what} must be ({p}, {fh}) {dtype}")
    for what, t in (("skyh", skyh), ("wn", wn)):
        if t.dtype != dtype:
            raise ValueError(f"{what} must be {dtype}")
    return n_rays, p, feat, fh


def field_heads(h, r, s2, bh, skyh, wn, bn, samples: int, *,
                rgb_padding: float = 0.001):
    """The narrow heads per sample; arguments and return as
    field_heads_reference. CUDA tensors launch the field_heads kernel; CPU
    tensors run the plain version."""
    if h.device.type == "cpu":
        return field_heads_reference(h, r, s2, bh, skyh, wn, bn, samples,
                                     rgb_padding=rgb_padding)
    dtype = h.dtype
    _check_cuda(dtype, h=h, r=r, s2=s2, bh=bh, skyh=skyh, wn=wn, bn=bn)
    _, p, feat, fh = _check_field_heads("field_heads", h, r, s2, bh, skyh, wn,
                                        bn, samples)
    out = torch.empty((p, FIELD_COLS), dtype=torch.float32, device=h.device)
    _launch("field_heads", _DTYPE_CODE[dtype], _ptr(h), feat, _ptr(r),
            _ptr(s2), _ptr(bh), _ptr(skyh), fh, _ptr(wn), _ptr(bn), p, samples,
            float(rgb_padding), _ptr(out), _stream(h))
    return out


def field_heads_bwd_reference(h, r, s2, bh, skyh, wn, bn, samples: int, g, *,
                              rgb_padding: float = 0.001) -> dict:
    """Plain version of field_heads_bwd, by autograd: the vector-Jacobian
    product of field_heads_reference with the per-sample cotangent g (P, 16)
    fp32. Returns fp32 tensors: d_h (P, F), the sigma head's share of h's
    cotangent; d_r, d_s2, d_bh (P, Fh) (d_bh None without the beta head);
    d_skyh (R, Fh), through sky_0's relu, from the ray's sky cotangent summed
    over its samples; dwn (9, F), dbn (9,)."""
    def contracted(hf, rf, sf, bf, skyf, wn_l, bn_l):
        out = field_heads_reference(hf, rf, sf, bf, skyf, wn_l, bn_l, samples,
                                    rgb_padding=rgb_padding, dtype=wn.dtype)
        return (out * g).sum(), None

    return _narrow_adjoint(contracted, h, r, s2, bh, skyh, wn, bn)[0]


def field_heads_bwd(h, r, s2, bh, skyh, wn, bn, samples: int, g, *,
                    rgb_padding: float = 0.001) -> dict:
    """The narrow heads' backward from a per-sample cotangent; arguments and
    returns as field_heads_bwd_reference. CUDA tensors launch the kernel."""
    if h.device.type == "cpu":
        return field_heads_bwd_reference(h, r, s2, bh, skyh, wn, bn, samples,
                                         g, rgb_padding=rgb_padding)
    dtype = h.dtype
    _check_cuda(dtype, h=h, r=r, s2=s2, bh=bh, skyh=skyh, wn=wn, bn=bn, g=g)
    n_rays, p, feat, fh = _check_field_heads("field_heads_bwd", h, r, s2, bh,
                                             skyh, wn, bn, samples)
    if g.dtype != torch.float32 or g.shape != (p, FIELD_COLS):
        raise ValueError(f"g must be ({p}, {FIELD_COLS}) fp32")
    res = _adjoint_buffers("field_heads_bwd", n_rays, p, feat, fh,
                           bh is not None, h.device)
    _launch("field_heads_bwd", _DTYPE_CODE[dtype], _ptr(h), feat, _ptr(r),
            _ptr(s2), _ptr(bh), _ptr(skyh), fh, _ptr(wn), _ptr(bn), _ptr(g), p,
            samples, float(rgb_padding), _ptr(res["d_h"]), _ptr(res["d_r"]),
            _ptr(res["d_s2"]), _ptr(res["d_bh"]), _ptr(res["d_skyh"]),
            _ptr(res["dwn"]), _ptr(res["dbn"]), _stream(h))
    return res


def _field_staged(p: dict, rays16, z, *, skip: int, use_beta: bool,
                  rgb_padding: float, dense_fn=siren_dense,
                  heads_fn=field_heads):
    """The forward chain without saved slopes (no graph is recorded): the
    serving chain's dense launches, then field_heads. Returns (P, 16)."""
    def heads(h, r, s, bh, skyh, wn, bn, z_, *, rgb_padding, return_weights):
        return heads_fn(h, r, s, bh, skyh, wn, bn, z_.shape[1],
                        rgb_padding=rgb_padding)

    return _render_staged(p, rays16, z, skip=skip, use_beta=use_beta,
                          rgb_padding=rgb_padding, return_weights=False,
                          dense_fn=dense_fn, heads_fn=heads)


class _FieldApply(torch.autograd.Function):
    """(rays or points, t_embed, the field's parameters) -> (P, 16) per-sample
    outputs on the card. When a graph is recorded the forward keeps the
    chain's activations and fp32 slopes on the node, as `_TrainRender` does
    (about 1.4 GB for each 65,536 points of an 8 x 512 field), and the
    backward frees them; under no_grad or inference_mode (cfg["record"]
    False: the caller's grad mode, which the forward itself never sees) it
    runs the serving chain and saves nothing. cfg["input_grads"] (K6) also
    returns the cotangents of rays_o (the points) and sun_dir; the ray mode
    (K5) gives them none, and z never gets one, as in the JAX kernels."""

    @staticmethod
    def forward(ctx, field, cfg: dict, rays_o, rays_d, sun_dir, z, t_embed,
                *weights):
        skip, use_beta = cfg["skip"], cfg["use_beta"]
        rays16 = pack_rays(rays_o, rays_d, sun_dir, t_embed, cfg["tau"])
        packed = pack_params(field, skip=skip, use_beta=use_beta,
                             dtype=cfg["dtype"])
        if not (cfg.get("record", True) and any(ctx.needs_input_grad)):
            return _field_staged(packed, rays16, z, skip=skip,
                                 use_beta=use_beta,
                                 rgb_padding=cfg["rgb_padding"])
        a = _chain_forward(packed, rays16, z, skip=skip, use_beta=use_beta)
        out = field_heads(a["h"], a["r"], a["s2"], a["bh"], a["skyh"],
                          packed["wn"], packed["bn"], z.shape[1],
                          rgb_padding=cfg["rgb_padding"])
        ctx.field, ctx.cfg = field, cfg
        ctx.chain = (packed, rays16, z, a)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        packed, rays16, z, a = ctx.chain
        ctx.chain = None  # the slopes go as soon as the backward has read them
        cfg = ctx.cfg
        skip, use_beta = cfg["skip"], cfg["use_beta"]
        cot = field_heads_bwd(a["h"], a["r"], a["s2"], a["bh"], a["skyh"],
                              packed["wn"], packed["bn"], z.shape[1],
                              g.float().contiguous(),
                              rgb_padding=cfg["rgb_padding"])
        d_in = {} if cfg["input_grads"] else None
        gk, t_grad = _chain_backward(packed, a, cot, rays16, z, skip=skip,
                                     use_beta=use_beta, input_grads=d_in)
        grads = unpack_grads(gk, ctx.field, skip=skip, use_beta=use_beta)
        d_xyz, d_sun = (d_in["xyz"], d_in["sun"]) if d_in else (None, None)
        return (None, None, d_xyz, None, d_sun, None, t_grad) + tuple(
            grads[n] for n, _ in ctx.field.named_parameters())


def _field_dict(out, lead: tuple, use_beta: bool) -> dict:
    """(P, 16) per-sample outputs -> the field module's dict."""
    res = {"rgb": out[:, 0:3].reshape(*lead, 3),
           "sigma": out[:, 3].reshape(*lead),
           "sun_v": out[:, 4:5].reshape(*lead, 1),
           "sky_rgb": out[:, 5:8].reshape(*lead, 3)}
    if use_beta:
        res["beta"] = out[:, 8:9].reshape(*lead, 1)
    return res


def fused_field_apply_rays_reference(params, rays_o, rays_d, sun_dir, t_embed,
                                     z_vals, *, layers: int = 8,
                                     feat: int = 512, skip: int = 4,
                                     use_beta: bool = True,
                                     rgb_padding: float = 0.001, tau: int = 4,
                                     dtype=torch.bfloat16) -> dict:
    """Plain version of fused_field_apply_rays: the field module on
    o + d*z, left to plain autograd (its matmuls round operands and
    cotangents where the kernels do, models/nerf.py rounded_matmul)."""
    _check_field(params, layers, feat, skip, use_beta, tau, rgb_padding)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[:, :, None]
    n_rays, n_s, _ = xyz.shape

    def per_sample(v):
        return v[:, None, :].expand(n_rays, n_s, v.shape[-1])

    return params(xyz, sun_dir=per_sample(sun_dir),
                  t_embed=per_sample(t_embed) if use_beta else None,
                  dtype=dtype)


def fused_field_apply_rays(params, rays_o, rays_d, sun_dir, t_embed, z_vals, *,
                           layers: int = 8, feat: int = 512, skip: int = 4,
                           use_beta: bool = True, rgb_padding: float = 0.001,
                           tau: int = 4, dtype=torch.bfloat16) -> dict:
    """The field at every sample of every ray, the expansion o + d*z inside
    the kernels.

    params: the s-nerf / sat-nerf RadianceField. rays_o, rays_d, sun_dir
    (R, 3); t_embed (R, tau) (sat-nerf); z_vals (R, S). Returns {"rgb"
    (R, S, 3), "sigma" (R, S), "sun_v" (R, S, 1), "sky_rgb" (R, S, 3)} and
    "beta" (R, S, 1) for sat-nerf: what the field module returns, ready for
    render/composite.py. Sigma is the softplus output, before noise and
    relu. Gradients flow to the parameters of `params` and to t_embed;
    rays_o, rays_d, sun_dir and z_vals get none.

    On CUDA tensors forward and backward are kernel chains (`_FieldApply`);
    on CPU tensors it runs fused_field_apply_rays_reference.
    """
    kw = dict(layers=layers, feat=feat, skip=skip, use_beta=use_beta,
              rgb_padding=rgb_padding, tau=tau, dtype=dtype)
    if z_vals.device.type == "cpu":
        return fused_field_apply_rays_reference(params, rays_o, rays_d,
                                                sun_dir, t_embed, z_vals, **kw)
    _check_card_call("fused_field_apply_rays", params, z_vals, sun_dir,
                     t_embed, layers, feat, skip, use_beta, tau, rgb_padding)
    cfg = dict(skip=skip, use_beta=use_beta, rgb_padding=rgb_padding, tau=tau,
               dtype=dtype, input_grads=False, record=torch.is_grad_enabled())
    out = _FieldApply.apply(
        params, cfg, rays_o.detach(), rays_d.detach(), sun_dir.detach(),
        z_vals.detach().float().contiguous(), t_embed if use_beta else None,
        *params.parameters())
    return _field_dict(out, tuple(z_vals.shape), use_beta)


def fused_field_apply_reference(params, xyz, sun_dir, t_embed=None, *,
                                layers: int = 8, feat: int = 512,
                                skip: int = 4, use_beta: bool = True,
                                rgb_padding: float = 0.001, tau: int = 4,
                                dtype=torch.bfloat16) -> dict:
    """Plain version of fused_field_apply: the field module on the points,
    left to plain autograd."""
    _check_field(params, layers, feat, skip, use_beta, tau, rgb_padding)
    return params(xyz, sun_dir=sun_dir,
                  t_embed=t_embed if use_beta else None, dtype=dtype)


def fused_field_apply(params, xyz, sun_dir, t_embed=None, *, layers: int = 8,
                      feat: int = 512, skip: int = 4, use_beta: bool = True,
                      rgb_padding: float = 0.001, tau: int = 4,
                      dtype=torch.bfloat16) -> dict:
    """The field on points, in place of the field module's forward.

    params: the s-nerf / sat-nerf RadianceField. xyz, sun_dir (..., 3) and
    t_embed (..., tau) (sat-nerf) with any leading shape. Returns the
    module's dict: "rgb" (..., 3), "sigma" (...), "sun_v" (..., 1),
    "sky_rgb" (..., 3) and "beta" (..., 1) for sat-nerf. Gradients flow to
    the parameters and to xyz, sun_dir and t_embed.

    On CUDA tensors forward and backward are kernel chains (`_FieldApply`
    with every point its own ray); on CPU tensors it runs
    fused_field_apply_reference.
    """
    kw = dict(layers=layers, feat=feat, skip=skip, use_beta=use_beta,
              rgb_padding=rgb_padding, tau=tau, dtype=dtype)
    if xyz.device.type == "cpu":
        return fused_field_apply_reference(params, xyz, sun_dir, t_embed, **kw)
    _check_card_call("fused_field_apply", params, xyz, sun_dir, t_embed,
                     layers, feat, skip, use_beta, tau, rgb_padding)
    lead = tuple(xyz.shape[:-1])
    pts = xyz.reshape(-1, 3)
    n = pts.shape[0]
    cfg = dict(skip=skip, use_beta=use_beta, rgb_padding=rgb_padding, tau=tau,
               dtype=dtype, input_grads=True, record=torch.is_grad_enabled())
    out = _FieldApply.apply(
        params, cfg, pts, torch.zeros_like(pts), sun_dir.reshape(n, 3),
        torch.zeros((n, 1), dtype=torch.float32, device=xyz.device),
        t_embed.reshape(n, tau) if use_beta else None, *params.parameters())
    return _field_dict(out, lead, use_beta)
