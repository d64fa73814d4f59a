"""The serving render for the SIREN variants: fused_render_rays.

Counterpart of satnerf_tpu/ops/pallas/fused_mlp.py:1066 (K2). Rays and
per-ray depths go in, per-ray products come out: rgb, depth, sun, sky,
albedo, opacity, beta (sat-nerf) and, on request, the (R, S) compositing
weights.

On the card the render is a chain of two hand-written CUDA kernels
(csrc/fused_render.cu), each behind a wrapper here with a plain PyTorch
version beside it:

  siren_dense      one dense layer, act(w0 * (X.W + b + E.C)), with the small
                   E operand (xyz, sun_dir or t) built from the rays in-kernel
  heads_composite  the narrow heads and the alpha compositor, a warp per ray

`_render_staged` chains them: the trunk with its skip, the wide heads, then
heads_composite. A wrapper given a CUDA tensor launches its kernel or raises;
given a CPU tensor it runs its plain version. There is no fallback from one
to the other. Every launch adds one to LAUNCHES[name].

Weights follow the JAX kernel's precision split: matmul operands (weights,
activations, the E operand) in the compute dtype, sums and biases in fp32,
each activation stored in the compute dtype, as `_trunk_fwd` and
`_narrow_fwd` round them (fused_mlp.py:278,287,302).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from satnerf_tpu_torch.render.render import run_field
from satnerf_tpu_torch.render.composite import ray_weights

OUT_COLS = 16  # rgb 0:3 | depth 3 | sun 4 | sky 5:8 | beta 8 | albedo 9:12 | opacity 12
RAY_COLS = 16  # o 0:3 | d 3:6 | sun 6:9 | t 9:9+tau

LAUNCHES = {"siren_dense": 0, "heads_composite": 0}

_ACT = {"none": 0, "sin": 1, "relu": 2}
_EXTRA = {None: (0, 0), "xyz": (1, 0), "sun": (2, 6), "t": (2, 9)}  # mode, column
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _launch(name: str, *args) -> None:
    from satnerf_tpu_torch.ops._build import load_library

    fn = getattr(load_library(), f"satnerf_{name}")
    err = fn(*args)
    LAUNCHES[name] += 1
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
                          z=None, w0: float = 1.0, act: str = "sin"):
    """Plain version of siren_dense: act(w0 * (x.weight + bias + E.C)).

    x (P, K) or None for K = 0; weight (K, N); bias (N,) fp32; rays16 (R, 16)
    fp32 with P = R * samples; extra in {None, "xyz", "sun", "t"} selects E
    (xyz = o + d*z needs z (R, S)); extra_weight (n, N). Returns (P, N) in the
    compute dtype (that of weight, else extra_weight).
    """
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
    if act == "sin":
        pre = torch.sin(pre)
    elif act == "relu":
        pre = torch.relu(pre)
    return pre.to(dtype)


def siren_dense(x, weight, bias, rays16, samples: int, *,
                extra: Optional[str] = None, extra_weight=None, z=None,
                w0: float = 1.0, act: str = "sin"):
    """One dense layer of the field; arguments as siren_dense_reference.

    CUDA tensors launch the siren_dense kernel; CPU tensors run the plain
    version.
    """
    if rays16.device.type == "cpu":
        return siren_dense_reference(x, weight, bias, rays16, samples,
                                     extra=extra, extra_weight=extra_weight,
                                     z=z, w0=w0, act=act)
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
    stream = torch.cuda.current_stream(rays16.device).cuda_stream
    _launch("siren_dense", _DTYPE_CODE[dtype], _ptr(x), k, _ptr(weight),
            _ptr(bias), _ptr(rays16), _ptr(z), samples, mode, col, n_extra,
            _ptr(extra_weight), float(w0), _ACT[act], _ptr(y), p, n, stream)
    return y


# ------------------------------------------------------------ heads_composite


def _narrow_heads(h, r, s2, bh, skyh, wn, bn, rgb_padding: float):
    """Per-sample sigma, albedo, sun_v, beta and per-ray sky (plain)."""
    fh = r.shape[1]
    w = wn.float()
    sigma = F.softplus(h.float() @ w[0] + bn[0])
    albedo = torch.sigmoid(r.float() @ w[1:4, :fh].T + bn[1:4])
    albedo = albedo * (1 + 2 * rgb_padding) - rgb_padding
    sunv = torch.sigmoid(s2.float() @ w[4, :fh] + bn[4])
    sky = torch.sigmoid(skyh.float() @ w[5:8, :fh].T + bn[5:8])
    beta = (F.softplus(bh.float() @ w[8, :fh] + bn[8]) if bh is not None
            else torch.zeros_like(sunv))
    return sigma, albedo, sunv, sky, beta


def heads_composite_reference(h, r, s2, bh, skyh, wn, bn, z, *,
                              rgb_padding: float = 0.001,
                              return_weights: bool = False):
    """Plain version of heads_composite.

    h (P, F), r/s2/bh (P, Fh) (bh None without the beta head), skyh (R, Fh),
    all in the compute dtype; wn (9, F) narrow weights in the compute dtype
    (rows: sigma, rgb_1 x3, sun_v_out, sky_1 x3, beta_1); bn (9,) fp32;
    z (R, S) fp32. Returns ((R, 16) products, (R, S) weights or None).
    """
    n_rays, n_s = z.shape
    sigma, albedo, sunv, sky, beta = _narrow_heads(h, r, s2, bh, skyh, wn, bn,
                                                   rgb_padding)
    _, _, w = ray_weights(sigma.reshape(n_rays, n_s), z)
    albedo = albedo.reshape(n_rays, n_s, 3)
    sunv = sunv.reshape(n_rays, n_s, 1)
    beta = beta.reshape(n_rays, n_s, 1)
    sky = sky[:, None, :].expand(n_rays, n_s, 3)
    irr = sunv + (1.0 - sunv) * sky
    wc = w[..., None]
    out = torch.zeros((n_rays, OUT_COLS), dtype=torch.float32, device=z.device)
    out[:, 0:3] = torch.clamp((wc * albedo * irr).sum(1), 0.0, 1.0)
    out[:, 3] = (w * z).sum(1)
    out[:, 4:5] = (wc * sunv).sum(1)
    out[:, 5:8] = (wc * sky).sum(1)
    out[:, 8:9] = (wc * beta).sum(1)
    out[:, 9:12] = (wc * albedo).sum(1)
    out[:, 12] = w.sum(1)
    return out, (w if return_weights else None)


def heads_composite(h, r, s2, bh, skyh, wn, bn, z, *,
                    rgb_padding: float = 0.001, return_weights: bool = False):
    """Narrow heads + compositing; arguments as heads_composite_reference.

    CUDA tensors launch the heads_composite kernel; CPU tensors run the
    plain version.
    """
    if z.device.type == "cpu":
        return heads_composite_reference(h, r, s2, bh, skyh, wn, bn, z,
                                         rgb_padding=rgb_padding,
                                         return_weights=return_weights)
    dtype = h.dtype
    _check_cuda(dtype, h=h, r=r, s2=s2, bh=bh, skyh=skyh, wn=wn, bn=bn, z=z)
    n_rays, n_s = z.shape
    p, feat = h.shape
    fh = r.shape[1]
    if z.dtype != torch.float32 or bn.dtype != torch.float32 or bn.numel() != 9:
        raise ValueError("z must be fp32 (R, S) and bn fp32 (9,)")
    if p != n_rays * n_s or wn.shape != (9, feat) or skyh.shape != (n_rays, fh):
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
    stream = torch.cuda.current_stream(z.device).cuda_stream
    _launch("heads_composite", _DTYPE_CODE[dtype], _ptr(h), feat, _ptr(r),
            _ptr(s2), _ptr(bh), _ptr(skyh), fh, _ptr(wn), _ptr(bn), _ptr(z),
            n_rays, n_s, float(rgb_padding), _ptr(out), _ptr(weights), stream)
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
                                return_weights: bool = False) -> dict:
    """Plain version of fused_render_rays: the field module on o + d*z, then
    render/composite.py, then the per-ray integrals sum_s w_s * q_s that
    satnerf_tpu/train/system.py:294-300 describes."""
    _check_field(params, layers, feat, skip, use_beta, tau, rgb_padding)
    res = run_field(params, rays_o, rays_d, None, sun_dir,
                    t_embed if use_beta else None, z_vals, shadow=True,
                    dtype=dtype)
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
    under torch.inference_mode(): it is forward-only, and its outputs carry
    no grad_fn (the differentiable render is K4, not ported yet). On CPU
    tensors it runs fused_render_rays_reference.
    """
    if z_vals.device.type == "cpu":
        return fused_render_rays_reference(
            params, rays_o, rays_d, sun_dir, t_embed, z_vals, layers=layers,
            feat=feat, skip=skip, use_beta=use_beta, rgb_padding=rgb_padding,
            tau=tau, dtype=dtype, return_weights=return_weights)
    if z_vals.device.type != "cuda":
        raise ValueError(f"fused_render_rays runs on cuda or cpu, not "
                         f"{z_vals.device}")
    _check_field(params, layers, feat, skip, use_beta, tau, rgb_padding)
    if sun_dir is None or (use_beta and t_embed is None):
        raise ValueError("the shadow variants need sun_dir (and t_embed for "
                         "sat-nerf)")
    if tau > RAY_COLS - 9:
        raise ValueError(f"tau={tau} does not fit the 16-column ray layout")
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
