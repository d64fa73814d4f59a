"""The port's fused_train_render_rays (K4), forward and vector-Jacobian
product, against the JAX package, the same numpy-seeded weights, depths,
noise and cotangent on both sides, float32 on the CPU:

  (a) the Pallas kernel fused_train_render_rays with its custom VJP in
      interpret mode, as tests/test_fused_train_render.py runs it: products
      2e-4 (its fast_sin errs up to 1.7e-5 a layer), gradients 1e-3 of each
      tensor's largest entry.
  (b) the flax field + render/composite.py under jax.vjp: products 2e-5,
      gradients 1e-4 of each tensor's largest entry.

The cotangent is random on all seven products (rgb, depth, sun, sky, beta,
albedo, opacity), although the depth loss fills one column only. On the CPU
fused_train_render_rays is its plain version (plain autograd through the
field module). The card's autograd function `_TrainRender` (the chain's
forward with saved slopes, heads_composite with noise, composite_bwd, the
chain's backward, unpack_grads) runs here on CPU tensors with the plain
stages and is held to the same oracles. The formulas the composite_bwd CUDA
kernel evaluates are written out in torch below and held against autograd,
with a saturated ray and sigma + noise < 0. The kernels themselves are
checked on the card by tests/test_torch_cuda.py and chip_smoke.py.
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
from satnerf_tpu_torch.models.nerf import build_model
from satnerf_tpu_torch.ops import fused_mlp as FM
from satnerf_tpu_torch.train.checkpoints import params_from_jax

torch.set_num_threads(1)

F, S, TAU, LAYERS = 32, 8, 4, 6
KEYS = ("rgb", "depth", "sun", "sky", "beta", "albedo", "opacity")
COLS = {"rgb": slice(0, 3), "depth": 3, "sun": slice(4, 5), "sky": slice(5, 8),
        "beta": slice(8, 9), "albedo": slice(9, 12), "opacity": 12}

# variant, rays, noise; with_kernel: also run the Pallas oracle
CASES = {
    "satnerf_noise": ("sat-nerf", 16, True, True),
    "snerf": ("s-nerf", 16, False, True),
    "ragged_no_noise": ("sat-nerf", 11, False, False),
}


def _jax_params(variant, seed=0):
    m = jax_build_model(variant, LAYERS, F)
    params = m.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)),
                    sun_dir=jnp.zeros((2, 3)),
                    t_embed=jnp.zeros((2, TAU)))["params"]
    return m, jax.device_get(params)


def _inputs(n_rays, with_noise, seed=31, n_s=S):
    rng = np.random.RandomState(seed)
    o = rng.randn(n_rays, 3).astype(np.float32) * 0.2
    d = rng.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = rng.randn(n_rays, 3).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    t = rng.randn(n_rays, TAU).astype(np.float32)
    z = np.sort(rng.rand(n_rays, n_s).astype(np.float32) * 3, -1)
    noise = (rng.randn(n_rays, n_s).astype(np.float32) * 0.5
             if with_noise else None)
    cot = rng.randn(n_rays, 16).astype(np.float32)
    return o, d, sun, t, z, noise, cot


def _port_field(variant, params):
    field = build_model(variant, LAYERS, F, t_dim=TAU)
    sd = params_from_jax({"coarse": params}, variant, LAYERS)
    field.load_state_dict({k[len("nerf_coarse."):]: v for k, v in sd.items()})
    return field


def _named(jax_grads, variant):
    sd = params_from_jax({"coarse": jax_grads}, variant, LAYERS)
    return {k[len("nerf_coarse."):]: v.numpy() for k, v in sd.items()}


def _contract(out, cot, use_beta):
    """sum over the products of product * its columns of the cotangent."""
    total = 0.0
    for k in KEYS:
        if k == "beta" and not use_beta:
            continue
        c = cot[:, COLS[k]]
        total = total + (out[k] * c).sum()
    return total


def _xla_oracle(m, params, inp, variant, jit=False):
    o, d, sun, t, z, noise, cot = (None if a is None else jnp.asarray(a)
                                   for a in inp)
    use_beta = variant == "sat-nerf"
    r, s = z.shape

    def products(p, t_e):
        xyz = o[:, None, :] + d[:, None, :] * z[:, :, None]
        sd = jnp.broadcast_to(sun[:, None, :], xyz.shape)
        tb = (jnp.broadcast_to(t_e[:, None, :], (r, s, TAU))
              if use_beta else None)
        out = m.apply({"params": p}, xyz, sun_dir=sd, t_embed=tb)
        res = jax_composite(out, z, noise=noise, shadow=True)
        w = res["weights"]
        prod = {"rgb": res["rgb"], "depth": res["depth"],
                "opacity": w.sum(-1)}
        for k in ("sun", "sky", "albedo") + (("beta",) if use_beta else ()):
            prod[k] = jnp.sum(w[..., None] * res[k], axis=-2)
        return prod

    grad = jax.grad(lambda p, t_e: _contract(products(p, t_e), cot, use_beta),
                    argnums=(0, 1))
    out = (jax.jit(products) if jit else products)(params, t)
    g, g_t = (jax.jit(grad) if jit else grad)(params, t)
    return ({k: np.asarray(v) for k, v in out.items()}, jax.device_get(g),
            np.asarray(g_t))


def _kernel_oracle(params, inp, variant):
    o, d, sun, t, z, noise, cot = (None if a is None else jnp.asarray(a)
                                   for a in inp)
    use_beta = variant == "sat-nerf"

    def products(p, t_e):
        return FMJ.fused_train_render_rays(
            p, o, d, sun, t_e if use_beta else None, z, noise, layers=LAYERS,
            feat=F, use_beta=use_beta, tau=TAU, dtype=jnp.float32)

    with pltpu.force_tpu_interpret_mode():
        out = products(params, t)
        g, g_t = jax.grad(
            lambda p, t_e: _contract(products(p, t_e), cot, use_beta),
            argnums=(0, 1))(params, t)
    return ({k: np.asarray(v) for k, v in out.items()}, jax.device_get(g),
            np.asarray(g_t))


def _port(field, inp, variant, staged, dtype=torch.float32):
    o, d, sun, t, z, noise, cot = (None if a is None else torch.from_numpy(a)
                                   for a in inp)
    use_beta = variant == "sat-nerf"
    t_leaf = t.clone().requires_grad_(True) if use_beta else None
    if staged:  # the card's autograd function, on CPU tensors
        cfg = dict(skip=4, use_beta=use_beta, rgb_padding=0.001, tau=TAU,
                   dtype=dtype)
        out = FM._products(FM._TrainRender.apply(
            field, cfg, o, d, sun, z, noise, t_leaf, *field.parameters()),
            None, use_beta)
    else:
        out = FM.fused_train_render_rays(
            field, o, d, sun, t_leaf, z, noise, layers=LAYERS, feat=F,
            use_beta=use_beta, tau=TAU, dtype=dtype)
    leaves = list(field.parameters()) + ([t_leaf] if use_beta else [])
    grads = torch.autograd.grad(_contract(out, cot, use_beta), leaves,
                                allow_unused=True)
    named = {n: (torch.zeros_like(p) if g is None else g) for (n, p), g in
             zip(field.named_parameters(), grads)}
    return ({k: v.detach() for k, v in out.items()}, named,
            grads[-1] if use_beta else None)


def _hold(port, oracle, variant, atol, rtol, tag):
    out, grads, t_grad = port
    o_out, o_grads, o_t = oracle
    assert set(out) == set(o_out), tag
    for k, v in o_out.items():
        assert tuple(out[k].shape) == v.shape, (tag, k)
        np.testing.assert_allclose(out[k].numpy(), v, atol=atol,
                                   err_msg=f"{tag} {k}")
    want = _named(o_grads, variant)
    assert set(grads) == set(want), tag
    for name, ref in want.items():
        got = grads[name].detach().numpy()
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(got / scale, ref / scale, atol=rtol,
                                   err_msg=f"{tag} {name}")
    if variant == "sat-nerf":
        scale = max(np.abs(o_t).max(), 1e-12)
        np.testing.assert_allclose(t_grad.numpy() / scale, o_t / scale,
                                   atol=rtol, err_msg=f"{tag} t_grad")


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_matches_jax(case, staged):
    variant, n_rays, with_noise, with_kernel = CASES[case]
    m, params = _jax_params(variant)
    inp = _inputs(n_rays, with_noise)
    field = _port_field(variant, params)
    port = _port(field, inp, variant, staged)
    _hold(port, _xla_oracle(m, params, inp, variant), variant, 2e-5, 1e-4,
          "vs XLA path")
    if with_kernel and not staged:
        _hold(port, _kernel_oracle(params, inp, variant), variant, 2e-4, 1e-3,
              "vs Pallas kernel")


_LONG = []  # (params, inputs, XLA oracle) of the 320-sample case


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
def test_k4_past_one_chunk_matches_jax(staged):
    """K4 with sigma noise at 320 samples a ray, past one chunk of 256 of
    the card's block scan (heads_composite carries T and the integrals over
    chunks), 4 rays: products and every gradient against the XLA path (its
    forward and VJP compiled whole, to keep the test short), as
    test_k4_matches_jax holds them."""
    if not _LONG:  # shared by the plain and the staged case
        m, params = _jax_params("sat-nerf")
        inp = _inputs(4, True, n_s=320)
        _LONG.extend([params, inp, _xla_oracle(m, params, inp, "sat-nerf",
                                               jit=True)])
    params, inp, oracle = _LONG
    port = _port(_port_field("sat-nerf", params), inp, "sat-nerf", staged)
    _hold(port, oracle, "sat-nerf", 2e-5, 1e-4, "vs XLA path")


@pytest.mark.parametrize("variant", ["sat-nerf", "s-nerf"])
def test_staged_bf16_matches_plain_bf16(variant):
    """bf16 operands: the autograd function over plain stages against plain
    autograd through the field module: products 1e-5 (the same forward),
    gradients 2e-3 of each tensor's largest entry, the sky heads 1e-2 (the
    chain sums a ray's sky cotangent over its samples before rounding it,
    the module rounds per sample)."""
    _, params = _jax_params(variant)
    field = _port_field(variant, params)
    inp = _inputs(16, True)
    ref = _port(field, inp, variant, False, torch.bfloat16)
    got = _port(field, inp, variant, True, torch.bfloat16)
    for k in ref[0]:
        assert float((got[0][k] - ref[0][k]).abs().max()) <= 1e-5, k
    for name, r in ref[1].items():
        tol = 1e-2 if name.startswith("sky_color") else 2e-3
        scale = r.abs().max().clamp_min(1e-12)
        assert float((got[1][name] - r).abs().max() / scale) <= tol, name
    if variant == "sat-nerf":
        scale = ref[2].abs().max()
        assert float((got[2] - ref[2]).abs().max() / scale) <= 2e-3


def test_backward_frees_the_saved_chain_and_ignores_depths_and_noise():
    _, params = _jax_params("sat-nerf")
    field = _port_field("sat-nerf", params)
    o, d, sun, t, z, noise, _ = (torch.from_numpy(a) for a in _inputs(8, True))
    z.requires_grad_(True), noise.requires_grad_(True)
    cfg = dict(skip=4, use_beta=True, rgb_padding=0.001, tau=TAU,
               dtype=torch.float32)
    out = FM._TrainRender.apply(field, cfg, o, d, sun, z, noise,
                                t.requires_grad_(True), *field.parameters())
    node = out.grad_fn
    assert node.chain is not None
    out[:, 3].sum().backward()
    assert node.chain is None
    assert z.grad is None and noise.grad is None
    # the depth reads sigma only: the color and uncertainty heads stay still
    assert field.rgb_from_xyzdir[0].weight.grad.abs().max() == 0
    assert field.sigma_from_xyz[0].weight.grad.abs().max() > 0
    assert t.grad.abs().max() == 0


def _manual_composite_bwd(h, r, s2, bh, skyh, wn, bn, z, noise, g, pad=0.001):
    """The formulas of the GIVEN instantiation of csrc/fused_train.cu
    composite_loss_bwd_kernel (composite_bwd), step by step."""
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
    sky_b = sky[:, None, :]
    irr = sunv[..., None] + (1 - sunv[..., None]) * sky_b
    rgb_acc = (wt[..., None] * rgb * irr).sum(1)
    inside = ((rgb_acc >= 0) & (rgb_acc <= 1)).float()
    g_rgb = (g[:, 0:3] * inside)[:, None, :]
    g_depth, g_sun, g_op = g[:, 3:4], g[:, 4:5], g[:, 12:13]
    g_sky, g_alb = g[:, None, 5:8], g[:, None, 9:12]
    g_beta = g[:, 8:9] if use_beta else torch.zeros(n_r, 1)
    d_irr = wt[..., None] * rgb * g_rgb
    dw = ((rgb * irr * g_rgb).sum(-1) + (rgb * g_alb).sum(-1) + sunv * g_sun
          + (sky_b * g_sky).sum(-1) + beta * g_beta + g_depth * z + g_op)
    d_sunv = (d_irr * (1 - sky_b)).sum(-1) + wt * g_sun
    d_sky = (d_irr * (1 - sunv[..., None]) + wt[..., None] * g_sky).sum(1)
    g_c = wt[..., None] * (irr * g_rgb + g_alb) * pad2 * cs * (1 - cs)
    dww = dw * wt
    suffix = torch.flip(torch.cumsum(torch.flip(dww, [1]), 1), [1]) - dww
    d_alpha = dw * trans - suffix / fac
    d_sn = torch.where(sigma_n > 0, d_alpha * oma * delta, torch.zeros(()))
    p = n_r * n_s
    gs = (d_sn * -torch.expm1(-sigma)).reshape(p)
    gr = g_c.reshape(p, 3)
    gsu = (d_sunv * sunv * (1 - sunv)).reshape(p)
    gb = (wt * g_beta * -torch.expm1(-beta)).reshape(p)
    gk = d_sky * sky * (1 - sky)
    dwn, dbn = torch.zeros(9, h.shape[1]), torch.zeros(9)
    dwn[0], dbn[0] = rnd(gs) @ hf, gs.sum()
    dwn[1:4, :fh], dbn[1:4] = rnd(gr).T @ rf, gr.sum(0)
    dwn[4, :fh], dbn[4] = rnd(gsu) @ sf, gsu.sum()
    dwn[5:8, :fh], dbn[5:8] = rnd(gk).T @ skf, gk.sum(0)
    out = {"d_h": rnd(gs)[:, None] * w[0][None, :],
           "d_r": rnd(gr) @ w[1:4, :fh],
           "d_s2": rnd(gsu)[:, None] * w[4, :fh][None, :],
           "d_skyh": (rnd(gk) @ w[5:8, :fh]) * (skf > 0), "d_bh": None}
    if use_beta:
        dwn[8, :fh], dbn[8] = rnd(gb) @ bh.float(), gb.sum()
        out["d_bh"] = rnd(gb)[:, None] * w[8, :fh][None, :]
    out["dwn"], out["dbn"] = dwn, dbn
    return out, wt, sigma_n, rgb_acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("use_beta,with_noise",
                         [(True, False), (True, True), (False, True)])
def test_composite_bwd_formulas_match_autograd(dtype, use_beta, with_noise):
    """Rays whose opacity saturates early (sigma row scaled by 40), with
    noise of spread 2 samples whose sigma + noise is negative, and a wide
    rgb head so that some unclipped integrals leave [0, 1] and their rgb
    cotangent is masked. 1e-5 of each tensor's largest entry: float32
    arithmetic in another order."""
    gen = torch.Generator().manual_seed(1)
    n_r, n_s, feat = 9, 12, 32
    p, fh = n_r * n_s, feat // 2

    def mk(*shape):
        return (torch.rand(*shape, generator=gen) * 2 - 1).to(dtype)

    h, r, s2 = mk(p, feat), mk(p, fh), mk(p, fh)
    bh = mk(p, fh) if use_beta else None
    skyh = torch.relu(mk(n_r, fh))
    wn = mk(9, feat) * 0.8
    wn[0] *= 40
    bn = torch.randn(9, generator=gen) * 0.3
    z = torch.sort(torch.rand(n_r, n_s, generator=gen) * 3, 1)[0]
    noise = torch.randn(n_r, n_s, generator=gen) * 2 if with_noise else None
    g = torch.randn(n_r, 16, generator=gen)
    pad = 0.3  # an albedo range of [-0.3, 1.3] pushes integrals past the clip
    ref = FM.composite_bwd_reference(h, r, s2, bh, skyh, wn, bn, z, noise, g,
                                     rgb_padding=pad)
    got, wt, sigma_n, rgb_acc = _manual_composite_bwd(
        h, r, s2, bh, skyh, wn, bn, z, noise, g, pad=pad)
    assert (wt.sum(1) > 0.999).any()  # a saturated ray is present
    assert ((rgb_acc < 0) | (rgb_acc > 1)).any()  # a clipped channel too
    if with_noise:
        assert (sigma_n < 0).any()
    for k, v in ref.items():
        if v is None:
            assert got[k] is None
            continue
        assert torch.isfinite(got[k]).all(), k
        scale = v.abs().max().clamp_min(1e-20)
        assert float((got[k] - v).abs().max() / scale) <= 1e-5, k


def test_heads_composite_noise_matches_composite():
    """heads_composite's plain version with noise against the reference
    compositor on the same per-sample head outputs."""
    gen = torch.Generator().manual_seed(5)
    n_r, n_s, feat = 5, 7, 32
    p, fh = n_r * n_s, feat // 2
    mk = lambda *s: torch.rand(*s, generator=gen) * 2 - 1  # noqa: E731
    h, r, s2, bh = mk(p, feat), mk(p, fh), mk(p, fh), mk(p, fh)
    skyh, wn, bn = torch.relu(mk(n_r, fh)), mk(9, feat), mk(9)
    z = torch.sort(torch.rand(n_r, n_s, generator=gen) * 3, 1)[0]
    noise = torch.randn(n_r, n_s, generator=gen)
    out, w = FM.heads_composite(h, r, s2, bh, skyh, wn, bn, z, noise=noise,
                                return_weights=True)
    out0, w0 = FM.heads_composite(h, r, s2, bh, skyh, wn, bn, z,
                                  return_weights=True)
    from satnerf_tpu_torch.render.composite import ray_weights

    sigma = F_t.softplus(h @ wn[0] + bn[0]).reshape(n_r, n_s)
    np.testing.assert_allclose(w.numpy(), ray_weights(sigma, z, noise)[2].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(out[:, 3].numpy(), (w * z).sum(1).numpy(), atol=1e-6)
    assert float((w - w0).abs().max()) > 1e-3
    assert out.shape == out0.shape == (n_r, 16) and float(out[:, 13:].abs().max()) == 0


def test_wrappers_raise_instead_of_falling_back():
    field = build_model("sat-nerf", LAYERS, F, t_dim=TAU)
    o, d, sun, t, z, _, _ = (None if a is None else torch.from_numpy(a)
                             for a in _inputs(4, False))
    with pytest.raises(ValueError):  # field / arguments mismatch
        FM.fused_train_render_rays(field, o, d, sun, t, z, layers=8, feat=F,
                                   tau=TAU, dtype=torch.float32)
    meta = torch.zeros(4, S, device="meta")
    with pytest.raises(ValueError):
        FM.fused_train_render_rays(field, o, d, sun, t, meta, layers=LAYERS,
                                   feat=F, tau=TAU)
