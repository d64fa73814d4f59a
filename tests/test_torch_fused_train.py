"""The port's fused_train_loss_grads (K1) against two JAX oracles, the same
numpy-seeded weights and inputs on both sides, float32 on the CPU:

  (a) the Pallas kernel fused_train_loss_grads in interpret mode. Its
      fast_sin / fast_cos err up to 1.7e-5 a layer, which the JAX tests
      allow for with 1e-3 of each gradient's largest entry; the same here,
      with 1e-4 on the loss parts and 2e-4 on the weights.
  (b) jax.value_and_grad of the XLA path (the flax field,
      render/composite.py, train/losses.py, as `--fused off` trains), with
      exact sin on both sides: 1e-4 of each gradient's largest entry, 1e-5
      on the loss parts, 2e-5 on the weights.

Compared: the three loss parts, every parameter gradient by name after the
weight bridge, t_grad and the compositing weights. On the CPU
fused_train_loss_grads is its plain version (autograd through the field
module). The kernel chain's staging (_train_staged: the saved slopes, the
split operands, the per-ray sky, the accumulating dgrads, unpack_grads) runs
here with the plain stages and is held to the same oracles; the adjoint
formulas that the composite_loss_bwd CUDA kernel evaluates are written out
in torch below and held against autograd. The kernels themselves are checked
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F_t
from jax.experimental.pallas import tpu as pltpu

from satnerf_tpu.models import build_model as jax_build_model
from satnerf_tpu.ops.pallas import fused_mlp as FMJ
from satnerf_tpu.render.composite import composite as jax_composite
from satnerf_tpu.train import losses as LJ
from satnerf_tpu_torch.models.nerf import build_model
from satnerf_tpu_torch.ops import fused_mlp as FM
from satnerf_tpu_torch.train.checkpoints import params_from_jax

torch.set_num_threads(1)

F, S, TAU = 32, 8, 4
RTOL_KERNEL, RTOL_XLA = 1e-3, 1e-4

# variant, gate, layers, rays, noise; with_kernel: also run the Pallas oracle
CASES = {
    "satnerf_gate1": ("sat-nerf", 1.0, 6, 16, False, True),
    "satnerf_gate0_noise": ("sat-nerf", 0.0, 6, 16, True, False),
    "snerf": ("s-nerf", 0.0, 6, 16, False, True),
    "layers_below_skip": ("sat-nerf", 1.0, 4, 16, False, False),
    "ragged_noise": ("sat-nerf", 1.0, 6, 19, True, True),
}


def _jax_params(variant, layers, seed=0):
    m = jax_build_model(variant, layers, F)
    params = m.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)),
                    sun_dir=jnp.zeros((2, 3)),
                    t_embed=jnp.zeros((2, TAU)))["params"]
    return m, jax.device_get(params)


def _inputs(n_rays, with_noise, seed=11):
    rng = np.random.RandomState(seed)
    o = rng.randn(n_rays, 3).astype(np.float32) * 0.2
    d = rng.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = rng.randn(n_rays, 3).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    t = rng.randn(n_rays, TAU).astype(np.float32)
    z = np.sort(rng.rand(n_rays, S).astype(np.float32) * 3, -1)
    gt = rng.rand(n_rays, 3).astype(np.float32)
    noise = (rng.randn(n_rays, S).astype(np.float32) * 0.5
             if with_noise else None)
    return o, d, sun, t, z, gt, noise


def _port_field(variant, params, layers):
    field = build_model(variant, layers, F, t_dim=TAU)
    sd = params_from_jax({"coarse": params}, variant, layers)
    field.load_state_dict({k[len("nerf_coarse."):]: v for k, v in sd.items()})
    return field


def _named(jax_grads, variant, layers):
    """JAX gradient pytree -> {port parameter name: numpy}."""
    sd = params_from_jax({"coarse": jax_grads}, variant, layers)
    return {k[len("nerf_coarse."):]: v.numpy() for k, v in sd.items()}


def _xla_oracle(m, params, inp, variant, wmix):
    o, d, sun, t, z, gt, noise = (None if a is None else jnp.asarray(a)
                                  for a in inp)
    use_beta = variant == "sat-nerf"
    r, s = z.shape

    def loss_fn(p, t_e):
        xyz = o[:, None, :] + d[:, None, :] * z[:, :, None]
        sd = jnp.broadcast_to(sun[:, None, :], xyz.shape)
        tb = (jnp.broadcast_to(t_e[:, None, :], (r, s, TAU))
              if use_beta else None)
        out = m.apply({"params": p}, xyz, sun_dir=sd, t_embed=tb)
        res = {f"{k}_coarse": v for k, v in
               jax_composite(out, z, noise=noise, shadow=True).items()}
        mse, _ = LJ.snerf_loss(res, gt, 0.0)
        parts = {"mse": mse}
        if use_beta:
            color, logbeta = LJ.uncertainty_aware_terms(res, gt, "coarse")
            parts.update(color_sat=color, logbeta=logbeta)
            loss = wmix * (color + logbeta) + (1.0 - wmix) * mse
        else:
            loss = mse
        return loss, (parts, res["weights_coarse"])

    (_, (parts, w)), (g, g_t) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, t)
    return ({k: float(v) for k, v in parts.items()}, jax.device_get(g),
            np.asarray(g_t), np.asarray(w))


def _kernel_oracle(params, inp, variant, wmix, layers):
    o, d, sun, t, z, gt, noise = (None if a is None else jnp.asarray(a)
                                  for a in inp)
    use_beta = variant == "sat-nerf"
    with pltpu.force_tpu_interpret_mode():
        parts, g, g_t, w = FMJ.fused_train_loss_grads(
            params, o, d, sun, t if use_beta else None, z, noise, gt,
            jnp.asarray(wmix, jnp.float32), layers=layers, feat=F,
            use_beta=use_beta, tau=TAU, dtype=jnp.float32,
            return_weights=True)
    return ({k: float(v) for k, v in parts.items()}, jax.device_get(g),
            np.asarray(g_t), np.asarray(w))


def _port(field, inp, variant, wmix, layers, staged):
    o, d, sun, t, z, gt, noise = (None if a is None else torch.from_numpy(a)
                                  for a in inp)
    use_beta = variant == "sat-nerf"
    if not staged:
        return FM.fused_train_loss_grads(
            field, o, d, sun, t if use_beta else None, z, noise, gt, wmix,
            layers=layers, feat=F, use_beta=use_beta, tau=TAU,
            dtype=torch.float32, return_weights=True)
    rays16 = FM.pack_rays(o, d, sun, t if use_beta else None, TAU)
    packed = FM.pack_params(field, skip=4, use_beta=use_beta,
                            dtype=torch.float32)
    sums, g, t_grad, w = FM._train_staged(
        packed, rays16, z, noise, gt, wmix if use_beta else 0.0, skip=4,
        use_beta=use_beta, rgb_padding=0.001, beta_min=0.05,
        return_weights=True)
    if t_grad is None:
        t_grad = torch.zeros(z.shape[0], TAU)
    return (FM._loss_parts(sums, z.shape[0]),
            FM.unpack_grads(g, field, skip=4, use_beta=use_beta), t_grad, w)


def _hold(port, oracle, variant, layers, rtol, tag):
    parts, grads, t_grad, weights = port
    o_parts, o_grads, o_t, o_w = oracle
    for k, v in o_parts.items():
        np.testing.assert_allclose(float(parts[k]), v, atol=rtol / 10,
                                   err_msg=f"{tag} part {k}")
    want = _named(o_grads, variant, layers)
    assert set(grads) == set(want), tag
    for name, ref in want.items():
        got = grads[name].detach().numpy()
        assert got.shape == ref.shape, (tag, name)
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(got / scale, ref / scale, atol=rtol,
                                   err_msg=f"{tag} {name}")
    if variant == "sat-nerf":
        scale = max(np.abs(o_t).max(), 1e-12)
        np.testing.assert_allclose(t_grad.numpy() / scale, o_t / scale,
                                   atol=rtol, err_msg=f"{tag} t_grad")
    np.testing.assert_allclose(weights.numpy(), o_w, atol=rtol / 5,
                               err_msg=f"{tag} weights")


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_matches_jax(case, staged):
    variant, wmix, layers, n_rays, with_noise, with_kernel = CASES[case]
    m, params = _jax_params(variant, layers)
    inp = _inputs(n_rays, with_noise)
    field = _port_field(variant, params, layers)
    port = _port(field, inp, variant, wmix, layers, staged)
    _hold(port, _xla_oracle(m, params, inp, variant, wmix), variant, layers,
          RTOL_XLA, "vs XLA path")
    if with_kernel and not staged:
        _hold(port, _kernel_oracle(params, inp, variant, wmix, layers),
              variant, layers, RTOL_KERNEL, "vs Pallas kernel")


def test_s_nerf_reports_the_jax_kernels_constant_parts():
    """Without the beta head the JAX kernel's sums are zero: color_sat 0,
    logbeta (3 + 0) / 2 (fused_mlp.py:1915-1919)."""
    _, params = _jax_params("s-nerf", 6)
    field = _port_field("s-nerf", params, 6)
    for staged in (False, True):
        parts = _port(field, _inputs(8, False), "s-nerf", 0.0, 6, staged)[0]
        assert float(parts["color_sat"]) == 0.0
        assert float(parts["logbeta"]) == 1.5


@pytest.mark.parametrize("variant,wmix", [("sat-nerf", 1.0), ("sat-nerf", 0.3),
                                          ("s-nerf", 0.0)])
def test_staged_bf16_matches_plain_bf16(variant, wmix):
    """bf16 operands: the chain of plain stages against autograd through the
    field module, both rounding operands and cotangents to bf16 at the same
    points. 2e-3 of each gradient's largest entry; the sky heads get 1e-2:
    the chain sums a ray's sky cotangent over its samples before rounding
    it, the module rounds per sample."""
    _, params = _jax_params(variant, 6)
    field = _port_field(variant, params, 6)
    inp = _inputs(16, True)
    o, d, sun, t, z, gt, noise = (torch.from_numpy(a) for a in inp)
    use_beta = variant == "sat-nerf"
    ref = FM.fused_train_loss_grads_reference(
        field, o, d, sun, t if use_beta else None, z, noise, gt, wmix,
        layers=6, feat=F, use_beta=use_beta, tau=TAU, dtype=torch.bfloat16)
    rays16 = FM.pack_rays(o, d, sun, t if use_beta else None, TAU)
    packed = FM.pack_params(field, skip=4, use_beta=use_beta,
                            dtype=torch.bfloat16)
    sums, g, t_grad, _ = FM._train_staged(
        packed, rays16, z, noise, gt, wmix if use_beta else 0.0, skip=4,
        use_beta=use_beta, rgb_padding=0.001, beta_min=0.05,
        return_weights=False)
    got = FM.unpack_grads(g, field, skip=4, use_beta=use_beta)
    parts = FM._loss_parts(sums, 16)
    for k in ref[0]:
        np.testing.assert_allclose(float(parts[k]), float(ref[0][k]), atol=1e-5)
    for name, r in ref[1].items():
        tol = 1e-2 if name.startswith("sky_color") else 2e-3
        scale = r.abs().max().clamp_min(1e-12)
        assert float((got[name] - r).abs().max() / scale) <= tol, name
    if use_beta:
        scale = ref[2].abs().max()
        assert float((t_grad - ref[2]).abs().max() / scale) <= 2e-3


def test_unpack_grads_undoes_every_split_of_pack_params():
    """Each kernel-layout array is filled with a value that names it; the
    unpacked gradient must carry that value in the rows it came from."""
    field = build_model("sat-nerf", 6, F, t_dim=TAU)
    p = FM.pack_params(field, skip=4, use_beta=True, dtype=torch.float32)
    codes, g = {}, {}

    def fill(name, like, code):
        codes[name] = code
        return torch.full_like(like, float(code), dtype=torch.float32)

    n = iter(range(1, 100))
    for k, v in p.items():
        if isinstance(v, list):
            g[k] = [fill(f"{k}{i}", a, next(n)) for i, a in enumerate(v)]
        elif k in ("wn", "bn"):
            g[k] = torch.arange(9, dtype=torch.float32).reshape(
                (9,) + (1,) * (v.dim() - 1)).expand_as(v).clone() + 100
        else:
            g[k] = fill(k, v, next(n))
    out = FM.unpack_grads(g, field, skip=4, use_beta=True)
    assert {k: v.shape for k, v in out.items()} == {
        k: v.shape for k, v in field.named_parameters()}
    fh = F // 2
    w4 = out["fc_net.8.weight"]  # the skip layer: (F, 3 + F)
    assert (w4[:, :3] == codes["C"]).all() and (w4[:, 3:] == codes["B3"]).all()
    assert (out["fc_net.0.weight"] == codes["A"]).all()
    assert (out["fc_net.2.weight"] == codes["B0"]).all()
    assert (out["fc_net.8.bias"] == codes["bt4"]).all()
    sun0 = out["sun_v_net.0.weight"]
    assert (sun0[:, :F] == codes["Wsun0h"]).all()
    assert (sun0[:, F:] == codes["Wsun0d"]).all() and sun0.shape[1] == F + 3
    beta0 = out["beta_from_xyz.0.weight"]
    assert (beta0[:, :F] == codes["Wbeta0h"]).all()
    assert (beta0[:, F:] == codes["Wbeta0t"]).all() and beta0.shape[1] == F + TAU
    assert (out["sky_color.0.weight"] == codes["Wsky0"]).all()
    rows = {"sigma_from_xyz.0": (0, 1, F), "rgb_from_xyzdir.2": (1, 4, fh),
            "sun_v_net.6": (4, 5, fh), "sky_color.2": (5, 8, fh),
            "beta_from_xyz.2": (8, 9, fh)}
    for name, (lo, hi, width) in rows.items():
        want = torch.arange(lo, hi, dtype=torch.float32) + 100
        assert out[f"{name}.weight"].shape == (hi - lo, width)
        assert (out[f"{name}.weight"] == want[:, None]).all(), name
        assert (out[f"{name}.bias"] == want).all(), name


def _manual_composite_loss_bwd(h, r, s2, bh, skyh, wn, bn, z, noise, gt, wmix,
                               pad=0.001, beta_min=0.05):
    """The formulas of csrc/fused_train.cu composite_loss_bwd_kernel, step by
    step: forward, the ray's loss cotangents, the suffix-sum transparency
    adjoint, the narrow pre-activation cotangents rounded to the compute
    type before both of their products."""
    dt = wn.dtype

    def rnd(x):
        return x.to(dt).float()

    n_r, n_s = z.shape
    fh, use_beta = r.shape[1], bh is not None
    w = wn.float()
    hf, rf, sf, skf = h.float(), r.float(), s2.float(), skyh.float()
    sigma = F_t.softplus(hf @ w[0] + bn[0]).reshape(n_r, n_s)
    cs = torch.sigmoid(rf @ w[1:4, :fh].T + bn[1:4]).reshape(n_r, n_s, 3)
    sunv = torch.sigmoid(sf @ w[4, :fh] + bn[4]).reshape(n_r, n_s)
    sky = torch.sigmoid(skf @ w[5:8, :fh].T + bn[5:8])
    beta = (F_t.softplus(bh.float() @ w[8, :fh] + bn[8]).reshape(n_r, n_s)
            if use_beta else torch.zeros(n_r, n_s))
    pad2 = 1 + 2 * pad
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n_r, 1), 1e10)], 1)
    sigma_n = sigma + (noise if noise is not None else 0)
    oma = torch.exp(-delta * torch.relu(sigma_n))
    alpha = 1 - oma
    fac = 1 - alpha + 1e-10
    trans = torch.cumprod(torch.cat([torch.ones(n_r, 1), fac], 1), 1)[:, :-1]
    wt = alpha * trans
    rgb = cs * pad2 - pad
    irr = sunv[..., None] + (1 - sunv[..., None]) * sky[:, None, :]
    rgb_acc = (wt[..., None] * rgb * irr).sum(1)
    beta_acc = (wt * beta).sum(1)
    diff = rgb_acc.clamp(0, 1) - gt
    sq = (diff ** 2).sum(1)
    inv3n, invn = 1 / (3 * n_r), 1 / n_r
    if use_beta:
        bl = beta_acc + beta_min
        ib2 = 1 / bl ** 2
        sums = torch.stack([(0.5 * sq * ib2).sum(), torch.log(bl).sum(), sq.sum()])
        scale = wmix * ib2 * inv3n + (1 - wmix) * 2 * inv3n
        g_beta = wmix * (0.5 * invn / bl - sq * ib2 / bl * inv3n)
    else:
        sums = torch.stack([torch.zeros(()), torch.zeros(()), sq.sum()])
        scale, g_beta = torch.full((n_r,), 2 * inv3n), torch.zeros(n_r)
    inside = ((rgb_acc >= 0) & (rgb_acc <= 1)).float()
    g = (diff * scale[:, None] * inside)[:, None, :]
    d_irr = wt[..., None] * rgb * g
    dw = (rgb * irr * g).sum(-1) + beta * g_beta[:, None]
    d_sunv = (d_irr * (1 - sky[:, None, :])).sum(-1)
    d_sky = (d_irr * (1 - sunv[..., None])).sum(1)
    g_rgb = wt[..., None] * irr * g * pad2 * cs * (1 - cs)
    dww = dw * wt
    suffix = torch.flip(torch.cumsum(torch.flip(dww, [1]), 1), [1]) - dww
    d_alpha = dw * trans - suffix / fac
    d_sn = torch.where(sigma_n > 0, d_alpha * oma * delta, torch.zeros(()))
    p = n_r * n_s
    gs = (d_sn * -torch.expm1(-sigma)).reshape(p)
    gr = g_rgb.reshape(p, 3)
    gsu = (d_sunv * sunv * (1 - sunv)).reshape(p)
    gb = (wt * g_beta[:, None] * -torch.expm1(-beta)).reshape(p)
    gk = d_sky * sky * (1 - sky)
    dwn, dbn = torch.zeros(9, h.shape[1]), torch.zeros(9)
    dwn[0], dbn[0] = rnd(gs) @ hf, gs.sum()
    dwn[1:4, :fh], dbn[1:4] = rnd(gr).T @ rf, gr.sum(0)
    dwn[4, :fh], dbn[4] = rnd(gsu) @ sf, gsu.sum()
    dwn[5:8, :fh], dbn[5:8] = rnd(gk).T @ skf, gk.sum(0)
    out = {"loss_sums": sums, "weights": wt,
           "d_h": rnd(gs)[:, None] * w[0][None, :],
           "d_r": rnd(gr) @ w[1:4, :fh],
           "d_s2": rnd(gsu)[:, None] * w[4, :fh][None, :],
           "d_skyh": (rnd(gk) @ w[5:8, :fh]) * (skf > 0), "d_bh": None}
    if use_beta:
        dwn[8, :fh], dbn[8] = rnd(gb) @ bh.float(), gb.sum()
        out["d_bh"] = rnd(gb)[:, None] * w[8, :fh][None, :]
    out["dwn"], out["dbn"] = dwn, dbn
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("use_beta,wmix,with_noise",
                         [(True, 1.0, False), (True, 0.3, True),
                          (False, 0.0, True)])
def test_composite_adjoint_formulas_match_autograd(dtype, use_beta, wmix,
                                                   with_noise):
    """Includes rays whose opacity saturates early (sigma row scaled by 40)
    and, with noise of spread 2, samples whose sigma + noise is negative.
    1e-5 of each tensor's largest entry: float32 arithmetic in another order."""
    g = torch.Generator().manual_seed(1)
    n_r, n_s, feat = 9, 12, 32
    p, fh = n_r * n_s, feat // 2

    def mk(*shape):
        return (torch.rand(*shape, generator=g) * 2 - 1).to(dtype)

    h, r, s2 = mk(p, feat), mk(p, fh), mk(p, fh)
    bh = mk(p, fh) if use_beta else None
    skyh = torch.relu(mk(n_r, fh))
    wn = mk(9, feat) * 0.8
    wn[0] *= 40
    bn = torch.randn(9, generator=g) * 0.3
    z = torch.sort(torch.rand(n_r, n_s, generator=g) * 3, 1)[0]
    gt = torch.rand(n_r, 3, generator=g)
    noise = torch.randn(n_r, n_s, generator=g) * 2 if with_noise else None
    ref = FM.composite_loss_bwd_reference(h, r, s2, bh, skyh, wn, bn, z, noise,
                                          gt, wmix, return_weights=True)
    got = _manual_composite_loss_bwd(h, r, s2, bh, skyh, wn, bn, z, noise, gt,
                                     wmix)
    assert (ref["weights"].sum(1) > 0.999).any()  # a saturated ray is present
    for k, v in ref.items():
        if v is None:
            assert got[k] is None
            continue
        assert torch.isfinite(got[k]).all(), k
        scale = v.abs().max().clamp_min(1e-20)
        assert float((got[k] - v).abs().max() / scale) <= 1e-5, k


def _scan32(x, op, identity, reverse):
    """The block scans of composite_loss_bwd_block over (R, 256) values, in
    the kernel's order: a Hillis-Steele scan within each warp of 32 (toward
    the later lanes, or with `reverse` toward the earlier), then each warp's
    total, then the totals of the warps before (after) it, taken one by one
    in warp order; exclusive. Returns (R, 256)."""
    n_r = x.shape[0]
    inc = x.reshape(n_r, 8, 32).clone()
    lane = torch.arange(32)
    for o in (1, 2, 4, 8, 16):
        if reverse:
            u = torch.cat([inc[..., o:], torch.full_like(inc[..., :o], identity)], -1)
            inc = torch.where(lane + o < 32, op(inc, u), inc)
        else:
            u = torch.cat([torch.full_like(inc[..., :o], identity), inc[..., :-o]], -1)
            inc = torch.where(lane >= o, op(inc, u), inc)
    tot = inc[..., 31] if not reverse else inc[..., 0]
    if reverse:
        exc = torch.cat([inc[..., 1:], torch.full_like(inc[..., :1], identity)], -1)
    else:
        exc = torch.cat([torch.full_like(inc[..., :1], identity), inc[..., :-1]], -1)
    out = torch.empty_like(exc)
    for w in range(8):
        acc = torch.full((n_r,), identity)
        for v in (range(7, w, -1) if reverse else range(w)):
            acc = op(acc, tot[:, v])
        out[:, w] = op(acc[:, None], exc[:, w])
    return out.reshape(n_r, 256)


def _block_composite_bwd(h, r, s2, bh, skyh, wn, bn, z, noise, gt=None,
                         wmix=1.0, g=None, pad=0.001, beta_min=0.05):
    """The order of csrc/fused_train.cu composite_loss_bwd_block, step by
    step (the "block" body; the loss instantiation, or with g the given
    one, composite_bwd): 1. the narrow heads of every sample; 2. a thread a
    sample, the transmittance as an exclusive product scan (_scan32) of
    (1 - alpha + 1e-10), 1 on the threads past the last sample; 3. the ray's
    cotangents from its sums; 4. the suffix sum of dw * w as a reverse
    exclusive scan, the pre-activation cotangents rounded to the compute
    type; 5. dWn as the sum of each ray's column sums (the block's one
    atomicAdd a column) and the cotangents by columns; 6. sky. Sums over
    samples are taken whole here (the kernel's block sums are warp
    reductions in another order)."""
    dt = wn.dtype

    def rnd(x):
        return x.to(dt).float()

    n_r, n_s = z.shape
    fh, use_beta, given = r.shape[1], bh is not None, g is not None
    w = wn.float()
    hf, rf, sf, skf = h.float(), r.float(), s2.float(), skyh.float()
    # 1. the heads
    sigma = F_t.softplus(hf @ w[0] + bn[0]).reshape(n_r, n_s)
    cs = torch.sigmoid(rf @ w[1:4, :fh].T + bn[1:4]).reshape(n_r, n_s, 3)
    sunv = torch.sigmoid(sf @ w[4, :fh] + bn[4]).reshape(n_r, n_s)
    sky = torch.sigmoid(skf @ w[5:8, :fh].T + bn[5:8])
    beta = (F_t.softplus(bh.float() @ w[8, :fh] + bn[8]).reshape(n_r, n_s)
            if use_beta else torch.zeros(n_r, n_s))
    # 2. a thread a sample: 256 threads, those past the last sample idle
    pad2 = 1 + 2 * pad
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n_r, 1), 1e10)], 1)
    sigma_n = sigma + (noise if noise is not None else 0)
    oma = torch.exp(-delta * torch.relu(sigma_n))
    alpha = 1 - oma
    fac = torch.ones(n_r, 256)
    fac[:, :n_s] = 1 - alpha + 1e-10
    trans = _scan32(fac, torch.mul, 1.0, reverse=False)[:, :n_s]
    wt = alpha * trans
    rgb = cs * pad2 - pad
    irr = sunv[..., None] + (1 - sunv[..., None]) * sky[:, None, :]
    rgb_acc = (wt[..., None] * rgb * irr).sum(1)
    beta_acc = (wt * beta).sum(1)
    # 3. the ray's cotangents
    inside = ((rgb_acc >= 0) & (rgb_acc <= 1)).float()
    out = {}
    if given:
        g_rgb = (g[:, 0:3] * inside)[:, None, :]
        g_beta = g[:, 8] if use_beta else torch.zeros(n_r)
    else:
        diff = rgb_acc.clamp(0, 1) - gt
        sq = (diff ** 2).sum(1)
        inv3n, invn = 1 / (3 * n_r), 1 / n_r
        if use_beta:
            bl = beta_acc + beta_min
            ib2 = 1 / bl ** 2
            out["loss_sums"] = torch.stack([(0.5 * sq * ib2).sum(),
                                            torch.log(bl).sum(), sq.sum()])
            scale = wmix * ib2 * inv3n + (1 - wmix) * 2 * inv3n
            g_beta = wmix * (0.5 * invn / bl - sq * ib2 / bl * inv3n)
        else:
            out["loss_sums"] = torch.stack([torch.zeros(()), torch.zeros(()),
                                            sq.sum()])
            scale, g_beta = torch.full((n_r,), 2 * inv3n), torch.zeros(n_r)
        g_rgb = (diff * scale[:, None] * inside)[:, None, :]
        out["weights"] = wt
    # 4. a thread a sample: the compositor adjoint
    d_irr = wt[..., None] * rgb * g_rgb
    dw = (rgb * irr * g_rgb).sum(-1) + beta * g_beta[:, None]
    d_sunv = (d_irr * (1 - sky[:, None, :])).sum(-1)
    d_sky = (d_irr * (1 - sunv[..., None])).sum(1)
    g_pre = irr * g_rgb
    if given:
        dw = dw + g[:, None, 3] * z + g[:, None, 12] + sunv * g[:, None, 4]
        dw = dw + (rgb * g[:, None, 9:12] + sky[:, None, :] * g[:, None, 5:8]).sum(-1)
        d_sunv = d_sunv + wt * g[:, None, 4]
        d_sky = d_sky + (wt[..., None] * g[:, None, 5:8]).sum(1)
        g_pre = g_pre + g[:, None, 9:12]
    g_rgb_s = wt[..., None] * g_pre * pad2 * cs * (1 - cs)
    dww = torch.zeros(n_r, 256)
    dww[:, :n_s] = dw * wt
    suffix = _scan32(dww, torch.add, 0.0, reverse=True)[:, :n_s]
    d_alpha = dw * trans - suffix / (1 - (1 - oma) + 1e-10)
    d_sn = torch.where(sigma_n > 0, d_alpha * oma * delta, torch.zeros(()))
    gs = d_sn * -torch.expm1(-sigma)
    gsu = d_sunv * sunv * (1 - sunv)
    gb = wt * g_beta[:, None] * -torch.expm1(-beta)
    # 5. by columns: each ray's column sums, then their sum over the rays
    p = n_r * n_s
    dwn, dbn = torch.zeros(9, h.shape[1]), torch.zeros(9)
    per_ray = lambda c, x: torch.einsum("rs,rsk->rk", rnd(c),  # noqa: E731
                                        x.reshape(n_r, n_s, -1)).sum(0)
    dwn[0], dbn[0] = per_ray(gs, hf), gs.sum()
    for c in range(3):
        dwn[1 + c, :fh] = per_ray(g_rgb_s[..., c], rf)
    dbn[1:4] = g_rgb_s.sum((0, 1))
    dwn[4, :fh], dbn[4] = per_ray(gsu, sf), gsu.sum()
    out.update({"d_h": rnd(gs).reshape(p, 1) * w[0][None, :],
                "d_r": rnd(g_rgb_s).reshape(p, 3) @ w[1:4, :fh],
                "d_s2": rnd(gsu).reshape(p, 1) * w[4, :fh][None, :],
                "d_bh": None})
    if use_beta:
        dwn[8, :fh], dbn[8] = per_ray(gb, bh.float()), gb.sum()
        out["d_bh"] = rnd(gb).reshape(p, 1) * w[8, :fh][None, :]
    # 6. sky, once a ray
    gk = d_sky * sky * (1 - sky)
    dwn[5:8, :fh], dbn[5:8] = rnd(gk).T @ skf, gk.sum(0)
    out["d_skyh"] = (rnd(gk) @ w[5:8, :fh]) * (skf > 0)
    out["dwn"], out["dbn"] = dwn, dbn
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("use_beta,wmix,with_noise,given,faint", [
    (True, 1.0, False, False, False), (True, 0.3, True, False, False),
    (False, 0.0, True, False, False), (True, 1.0, False, False, True),
    (True, 0.0, True, True, False), (False, 0.0, False, True, False),
    (True, 0.0, False, True, True)],
    ids=["beta", "beta_gate_noise", "mse_noise", "beta_faint",
         "given_beta_noise", "given_mse", "given_faint"])
def test_block_composite_order_matches_autograd(dtype, use_beta, wmix,
                                                 with_noise, given, faint):
    """The block body's order against composite_loss_bwd_reference (the loss)
    and composite_bwd_reference (a given (R, 16) cotangent), 70 samples a ray
    so that the scans cross three warps. Rays whose opacity saturates early
    (sigma row scaled by 40), samples whose sigma + noise is negative, and
    with `faint` sigma = 1e-10 everywhere: only the last sample (delta 1e10)
    has weight, its factor is 1e-10 and the suffix sum divided by it stays
    finite. 1e-5 of each tensor's largest entry: float32 arithmetic in
    another order."""
    g = torch.Generator().manual_seed(2)
    n_r, n_s, feat = 5, 70, 32
    p, fh = n_r * n_s, feat // 2

    def mk(*shape):
        return (torch.rand(*shape, generator=g) * 2 - 1).to(dtype)

    h, r, s2 = mk(p, feat), mk(p, fh), mk(p, fh)
    bh = mk(p, fh) if use_beta else None
    skyh = torch.relu(mk(n_r, fh))
    wn = mk(9, feat) * 0.8
    wn[0] *= 40
    bn = torch.randn(9, generator=g) * 0.3
    if faint:
        wn[0], bn[0] = 0.0, -23.0
    z = torch.sort(torch.rand(n_r, n_s, generator=g) * 3, 1)[0]
    noise = torch.randn(n_r, n_s, generator=g) * 2 if with_noise else None
    args = (h, r, s2, bh, skyh, wn, bn, z, noise)
    if given:
        cot = torch.randn(n_r, 16, generator=g)
        ref = FM.composite_bwd_reference(*args, cot)
        got = _block_composite_bwd(*args, g=cot)
    else:
        gt = torch.rand(n_r, 3, generator=g)
        ref = FM.composite_loss_bwd_reference(*args, gt, wmix,
                                              return_weights=True)
        got = _block_composite_bwd(*args, gt=gt, wmix=wmix)
        assert (ref["weights"].sum(1) > 0.999).any() or faint
    if faint:
        assert float(ref["dbn"][0].abs()) > 1e-3  # the last samples pull on sigma
    assert set(got) == set(ref)
    for k, v in ref.items():
        if v is None:
            assert got[k] is None
            continue
        assert torch.isfinite(got[k]).all(), k
        scale = v.abs().max().clamp_min(1e-20)
        assert float((got[k] - v).abs().max() / scale) <= 1e-5, k


@pytest.mark.parametrize("body", list(FM.COMPOSITE_BODIES))
def test_cpu_composite_runs_the_plain_version_whatever_body(body):
    """On the CPU both wrappers run their plain versions whatever `body=`
    asks, and count nothing; a body they do not know is refused."""
    g = torch.Generator().manual_seed(3)
    n_r, n_s, feat = 3, 6, 16
    p, fh = n_r * n_s, feat // 2
    args = (torch.rand(p, feat, generator=g), torch.rand(p, fh, generator=g),
            torch.rand(p, fh, generator=g), torch.rand(p, fh, generator=g),
            torch.rand(n_r, fh, generator=g), torch.randn(9, feat, generator=g),
            torch.randn(9, generator=g),
            torch.sort(torch.rand(n_r, n_s, generator=g), 1)[0], None)
    gt, cot = torch.rand(n_r, 3, generator=g), torch.randn(n_r, 16, generator=g)
    launches, bodies = dict(FM.LAUNCHES), dict(FM.BODY_LAUNCHES)
    got = FM.composite_loss_bwd(*args, gt, 1.0, body=body)
    ref = FM.composite_loss_bwd_reference(*args, gt, 1.0)
    got_b = FM.composite_bwd(*args, cot, body=body)
    ref_b = FM.composite_bwd_reference(*args, cot)
    for a, b in ((got, ref), (got_b, ref_b)):
        for k, v in b.items():
            assert (v is None and a[k] is None) or torch.equal(a[k], v), k
    assert FM.LAUNCHES == launches and FM.BODY_LAUNCHES == bodies
    with pytest.raises(ValueError):
        FM.composite_loss_bwd(*args, gt, 1.0, body="lane")
    with pytest.raises(ValueError):
        FM.composite_bwd(*args, cot, body="BLOCK")


def test_wrappers_raise_instead_of_falling_back():
    """A wrapper picks its plain version only because its tensor is on the
    CPU; what it cannot run raises."""
    field = build_model("sat-nerf", 6, F, t_dim=TAU)
    o, d, sun, t, z, gt = (torch.from_numpy(a) for a in _inputs(4, False)[:6])
    with pytest.raises(ValueError):  # field / arguments mismatch
        FM.fused_train_loss_grads(field, o, d, sun, t, z, None, gt, 1.0,
                                  layers=8, feat=F, tau=TAU,
                                  dtype=torch.float32)
    with pytest.raises(ValueError):
        FM.siren_dense_reference(None, None, torch.zeros(F),
                                 torch.zeros(4, 16), 1, extra="sun",
                                 extra_weight=torch.zeros(3, F), act="relu",
                                 save=True)
    meta = torch.zeros(4, S, device="meta")
    with pytest.raises(ValueError):
        FM.fused_train_loss_grads(field, o, d, sun, t, meta, None, gt, 1.0,
                                  layers=6, feat=F, tau=TAU)
