"""The port's per-sample field, fused_field_apply_rays (K5) and
fused_field_apply (K6), forward and vector-Jacobian product, against the JAX
package: the same numpy-seeded weights, inputs and per-sample (P, 16)
cotangent on both sides, float32 on the CPU.

  (a) the Pallas kernels fused_field_apply_rays / fused_field_apply with
      their custom VJPs in interpret mode, as tests/test_fused_mlp.py runs
      them: outputs 2e-4 (their fast_sin errs up to 1.7e-5 a layer),
      gradients 1e-3 of each tensor's largest entry.
  (b) the flax field under jax.grad: outputs 2e-5, gradients 1e-4 of each
      tensor's largest entry.

On the CPU both entry points are their plain versions (plain autograd
through the field module). The card's autograd function `_FieldApply` (the
chain's forward with saved slopes, field_heads, field_heads_bwd, the chain's
backward with the input gradients, unpack_grads) runs here on CPU tensors
with the plain stages and is held to the same oracles. The formulas the
field_heads_bwd CUDA kernels evaluate are written out in torch below and held
against autograd, with a sample whose sigma is too faint for
1 - exp(-sigma) in float32. The kernels themselves are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
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
from satnerf_tpu_torch.models.nerf import build_model
from satnerf_tpu_torch.ops import fused_mlp as FM
from satnerf_tpu_torch.train.checkpoints import params_from_jax

torch.set_num_threads(1)

F, TAU, LAYERS = 32, 4, 6
COLS = {"rgb": slice(0, 3), "sigma": 3, "sun_v": slice(4, 5),
        "sky_rgb": slice(5, 8), "beta": slice(8, 9)}

# variant, rays, samples; with_kernel: which of K5 / K6 also runs the Pallas
# oracle (the plain entry point only; interpret mode is slow).
# 11 x 5 = 55 points: no multiple of any tile. One sample a ray makes every
# point its own ray in K5 too (sky once a point, as in K6); 7 rays of 6
# samples leave the card kernel's blocks of 128 points ragged.
CASES = {
    "satnerf": ("sat-nerf", 16, 8, ("k5", "k6")),
    "snerf": ("s-nerf", 16, 8, ("k5", "k6")),
    "ragged": ("sat-nerf", 11, 5, ("k6",)),
    "one_sample": ("sat-nerf", 8, 1, ("k5",)),
    "ragged_rays": ("s-nerf", 7, 6, ()),
}


def _jax_params(variant, seed=0, layers=LAYERS, feat=F, jit=False):
    m = jax_build_model(variant, layers, feat)
    params = (jax.jit(m.init) if jit else m.init)(jax.random.PRNGKey(seed), jnp.zeros((2, 3)),
                    sun_dir=jnp.zeros((2, 3)),
                    t_embed=jnp.zeros((2, TAU)))["params"]
    return m, jax.device_get(params)


def _port_field(variant, params, layers=LAYERS, feat=F):
    field = build_model(variant, layers, feat, t_dim=TAU)
    sd = params_from_jax({"coarse": params}, variant, layers)
    field.load_state_dict({k[len("nerf_coarse."):]: v for k, v in sd.items()})
    return field


def _named(jax_grads, variant, layers=LAYERS):
    sd = params_from_jax({"coarse": jax_grads}, variant, layers)
    return {k[len("nerf_coarse."):]: v.numpy() for k, v in sd.items()}


def _ray_inputs(n_rays, n_s, seed=31):
    rng = np.random.RandomState(seed)
    o = rng.randn(n_rays, 3).astype(np.float32) * 0.2
    d = rng.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = rng.randn(n_rays, 3).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    t = rng.randn(n_rays, TAU).astype(np.float32)
    z = np.sort(rng.rand(n_rays, n_s).astype(np.float32) * 3, -1)
    cot = rng.randn(n_rays * n_s, 16).astype(np.float32)
    return o, d, sun, t, z, cot


def _point_inputs(n_rays, n_s, seed=37):
    """Points of leading shape (n_rays, n_s), every one with its own sun
    direction and embedding."""
    rng = np.random.RandomState(seed)
    lead = (n_rays, n_s)
    xyz = rng.randn(*lead, 3).astype(np.float32) * 0.5
    sun = rng.randn(*lead, 3).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    t = rng.randn(*lead, TAU).astype(np.float32)
    cot = rng.randn(n_rays * n_s, 16).astype(np.float32)
    return xyz, sun, t, cot


def _contract(out, cot, use_beta):
    """sum over the field's outputs of output * its columns of the (P, 16)
    cotangent."""
    total = 0.0
    for k, c in COLS.items():
        if k == "beta" and not use_beta:
            continue
        v = out[k]
        g = cot[:, c].reshape(v.shape)
        total = total + (v * g).sum()
    return total


# ---------------------------------------------------------------- K5 oracles


def _k5_oracle(m, params, inp, variant, kernel, layers=LAYERS, feat=F,
               jit=False):
    o, d, sun, t, z, cot = (jnp.asarray(a) for a in inp)
    use_beta = variant == "sat-nerf"
    r, s = z.shape

    def field(p, t_e):
        if kernel:
            return FMJ.fused_field_apply_rays(
                p, o, d, sun, t_e if use_beta else None, z, layers=layers,
                feat=feat, use_beta=use_beta, tau=TAU, dtype=jnp.float32)
        xyz = o[:, None, :] + d[:, None, :] * z[:, :, None]
        sd = jnp.broadcast_to(sun[:, None, :], xyz.shape)
        tb = (jnp.broadcast_to(t_e[:, None, :], (r, s, TAU))
              if use_beta else None)
        return m.apply({"params": p}, xyz, sun_dir=sd, t_embed=tb)

    def run():
        grad = jax.grad(lambda p, t_e: _contract(field(p, t_e), cot, use_beta),
                        argnums=(0, 1))
        out = (jax.jit(field) if jit else field)(params, t)
        g, g_t = (jax.jit(grad) if jit else grad)(params, t)
        return ({k: np.asarray(v) for k, v in out.items()}, jax.device_get(g),
                {"t": np.asarray(g_t)} if use_beta else {})

    if kernel:
        with pltpu.force_tpu_interpret_mode():
            return run()
    return run()


def _k5_port(field, inp, variant, staged, dtype=torch.float32, layers=LAYERS,
             feat=F):
    o, d, sun, t, z, cot = (torch.from_numpy(a) for a in inp)
    use_beta = variant == "sat-nerf"
    t_leaf = t.clone().requires_grad_(True) if use_beta else None
    if staged:  # the card's autograd function, on CPU tensors
        cfg = dict(skip=4, use_beta=use_beta, rgb_padding=0.001, tau=TAU,
                   dtype=dtype, input_grads=False)
        out = FM._field_dict(FM._FieldApply.apply(
            field, cfg, o, d, sun, z, t_leaf, *field.parameters()),
            tuple(z.shape), use_beta)
    else:
        out = FM.fused_field_apply_rays(
            field, o, d, sun, t_leaf, z, layers=layers, feat=feat,
            use_beta=use_beta, tau=TAU, dtype=dtype)
    leaves = list(field.parameters()) + ([t_leaf] if use_beta else [])
    grads = torch.autograd.grad(_contract(out, cot, use_beta), leaves,
                                allow_unused=True)
    named = {n: (torch.zeros_like(p) if g is None else g) for (n, p), g in
             zip(field.named_parameters(), grads)}
    return ({k: v.detach() for k, v in out.items()}, named,
            {"t": grads[-1]} if use_beta else {})


# ---------------------------------------------------------------- K6 oracles


def _k6_oracle(m, params, inp, variant, kernel):
    xyz, sun, t, cot = (jnp.asarray(a) for a in inp)
    use_beta = variant == "sat-nerf"

    def field(p, x, sd, t_e):
        if kernel:
            return FMJ.fused_field_apply(
                p, x, sd, t_e if use_beta else None, layers=LAYERS, feat=F,
                use_beta=use_beta, tau=TAU, dtype=jnp.float32)
        return m.apply({"params": p}, x, sun_dir=sd,
                       t_embed=t_e if use_beta else None)

    def run():
        out = field(params, xyz, sun, t)
        g, g_x, g_s, g_t = jax.grad(
            lambda p, x, sd, t_e: _contract(field(p, x, sd, t_e), cot,
                                            use_beta),
            argnums=(0, 1, 2, 3))(params, xyz, sun, t)
        ins = {"xyz": np.asarray(g_x), "sun": np.asarray(g_s)}
        if use_beta:
            ins["t"] = np.asarray(g_t)
        return ({k: np.asarray(v) for k, v in out.items()}, jax.device_get(g),
                ins)

    if kernel:
        with pltpu.force_tpu_interpret_mode():
            return run()
    return run()


def _k6_port(field, inp, variant, staged, dtype=torch.float32):
    xyz, sun, t, cot = (torch.from_numpy(a) for a in inp)
    use_beta = variant == "sat-nerf"
    ins = {"xyz": xyz.clone().requires_grad_(True),
           "sun": sun.clone().requires_grad_(True)}
    if use_beta:
        ins["t"] = t.clone().requires_grad_(True)
    lead = tuple(xyz.shape[:-1])
    if staged:  # the card's autograd function, every point its own ray
        n = int(np.prod(lead))
        cfg = dict(skip=4, use_beta=use_beta, rgb_padding=0.001, tau=TAU,
                   dtype=dtype, input_grads=True)
        pts = ins["xyz"].reshape(n, 3)
        out = FM._field_dict(FM._FieldApply.apply(
            field, cfg, pts, torch.zeros_like(pts), ins["sun"].reshape(n, 3),
            torch.zeros(n, 1), ins["t"].reshape(n, TAU) if use_beta else None,
            *field.parameters()), lead, use_beta)
    else:
        out = FM.fused_field_apply(
            field, ins["xyz"], ins["sun"], ins.get("t"), layers=LAYERS,
            feat=F, use_beta=use_beta, tau=TAU, dtype=dtype)
    leaves = list(field.parameters()) + list(ins.values())
    grads = torch.autograd.grad(_contract(out, cot, use_beta), leaves,
                                allow_unused=True)
    named = {n: (torch.zeros_like(p) if g is None else g) for (n, p), g in
             zip(field.named_parameters(), grads)}
    n_par = len(named)
    return ({k: v.detach() for k, v in out.items()}, named,
            dict(zip(ins, grads[n_par:])))


def _hold(port, oracle, variant, atol, rtol, tag, layers=LAYERS):
    out, grads, in_grads = port
    o_out, o_grads, o_in = oracle
    assert set(out) == set(o_out), tag
    for k, v in o_out.items():
        assert tuple(out[k].shape) == v.shape, (tag, k)
        np.testing.assert_allclose(out[k].numpy(), v, atol=atol,
                                   err_msg=f"{tag} {k}")
    want = _named(o_grads, variant, layers)
    assert set(grads) == set(want), tag
    for name, ref in want.items():
        got = grads[name].detach().numpy()
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(got / scale, ref / scale, atol=rtol,
                                   err_msg=f"{tag} {name}")
    assert set(in_grads) == set(o_in), tag
    for name, ref in o_in.items():
        assert in_grads[name] is not None, (tag, name)
        got = in_grads[name].numpy().reshape(ref.shape)
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(got / scale, ref / scale, atol=rtol,
                                   err_msg=f"{tag} d_{name}")


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k5_matches_jax(case, staged):
    variant, n_rays, n_s, with_kernel = CASES[case]
    m, params = _jax_params(variant)
    inp = _ray_inputs(n_rays, n_s)
    port = _k5_port(_port_field(variant, params), inp, variant, staged)
    _hold(port, _k5_oracle(m, params, inp, variant, False), variant, 2e-5,
          1e-4, "vs flax")
    if "k5" in with_kernel and not staged:
        _hold(port, _k5_oracle(m, params, inp, variant, True), variant, 2e-4,
              1e-3, "vs Pallas kernel")


_NARROW = []  # (params, inputs, flax oracle) of the FEAT 40 case


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
def test_k5_with_narrow_heads_matches_jax(staged):
    """FEAT 40, two layers: heads of Fh = 20 features, not a multiple of 8
    (the card's kernels read such rows without 16-byte loads), on 6 rays of
    5 samples: K5's outputs and every gradient against the flax field (its
    init and its VJP compiled whole, to keep the test short), as
    test_k5_matches_jax holds them."""
    layers, feat = 2, 40
    if not _NARROW:  # shared by the plain and the staged case
        m, params = _jax_params("sat-nerf", layers=layers, feat=feat, jit=True)
        inp = _ray_inputs(6, 5)
        _NARROW.extend([params, inp, _k5_oracle(m, params, inp, "sat-nerf", False,
                                                layers, feat, jit=True)])
    params, inp, oracle = _NARROW
    port = _k5_port(_port_field("sat-nerf", params, layers, feat), inp,
                    "sat-nerf", staged, layers=layers, feat=feat)
    _hold(port, oracle, "sat-nerf", 2e-5, 1e-4, "vs flax", layers)


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k6_matches_jax(case, staged):
    variant, n_rays, n_s, with_kernel = CASES[case]
    m, params = _jax_params(variant)
    inp = _point_inputs(n_rays, n_s)
    port = _k6_port(_port_field(variant, params), inp, variant, staged)
    _hold(port, _k6_oracle(m, params, inp, variant, False), variant, 2e-5,
          1e-4, "vs flax")
    if "k6" in with_kernel and not staged:
        _hold(port, _k6_oracle(m, params, inp, variant, True), variant, 2e-4,
              1e-3, "vs Pallas kernel")


@pytest.mark.parametrize("which", ["k5", "k6"])
@pytest.mark.parametrize("variant", ["sat-nerf", "s-nerf"])
def test_staged_bf16_matches_plain_bf16(variant, which):
    """bf16 operands: the autograd function over plain stages against plain
    autograd through the field module: outputs 1e-5 (the same forward),
    gradients 2e-3 of each tensor's largest entry, the sky heads 1e-2 in ray
    mode (the chain sums a ray's sky cotangent over its samples before
    rounding it, the module rounds per sample)."""
    _, params = _jax_params(variant)
    field = _port_field(variant, params)
    if which == "k5":
        inp, run = _ray_inputs(16, 8), _k5_port
    else:
        inp, run = _point_inputs(16, 8), _k6_port
    ref = run(field, inp, variant, False, torch.bfloat16)
    got = run(field, inp, variant, True, torch.bfloat16)
    for k in ref[0]:
        assert float((got[0][k] - ref[0][k]).abs().max()) <= 1e-5, k
    for name, r in ref[1].items():
        tol = 1e-2 if name.startswith("sky_color") else 2e-3
        scale = r.abs().max().clamp_min(1e-12)
        assert float((got[1][name] - r).abs().max() / scale) <= tol, name
    for name, r in ref[2].items():
        tol = 1e-2 if (name == "sun" and which == "k5") else 2e-3
        scale = r.abs().max().clamp_min(1e-12)
        diff = (got[2][name].reshape(r.shape) - r).abs().max()
        assert float(diff / scale) <= tol, name


def test_no_graph_saves_nothing_and_backward_frees_the_chain():
    _, params = _jax_params("sat-nerf")
    field = _port_field("sat-nerf", params)
    o, d, sun, t, z, _ = (torch.from_numpy(a) for a in _ray_inputs(8, 8))
    cfg = dict(skip=4, use_beta=True, rgb_padding=0.001, tau=TAU,
               dtype=torch.float32, input_grads=False)
    with torch.no_grad():
        quiet = FM._FieldApply.apply(field, cfg, o, d, sun, z, t,
                                     *field.parameters())
    assert quiet.grad_fn is None and quiet.shape == (64, 16)
    z.requires_grad_(True)
    out = FM._FieldApply.apply(field, cfg, o, d, sun, z,
                               t.requires_grad_(True), *field.parameters())
    # the same forward, with or without saved slopes
    assert float((out.detach() - quiet).abs().max()) <= 1e-6
    node = out.grad_fn
    assert node.chain is not None
    out[:, 3].sum().backward()
    assert node.chain is None
    assert z.grad is None  # depths get no gradient, as in the JAX kernel
    # sigma reads the trunk only: the color and uncertainty heads stay still
    assert field.rgb_from_xyzdir[0].weight.grad.abs().max() == 0
    assert field.sigma_from_xyz[0].weight.grad.abs().max() > 0
    assert t.grad.abs().max() == 0


def _manual_field_heads_bwd(h, r, s2, bh, skyh, wn, bn, samples, g, pad=0.001):
    """The formulas of csrc/fused_field.cu field_heads_bwd_stream (with the
    sky head of a ray's first sample), step by step."""
    dt = wn.dtype

    def rnd(x):
        return x.to(dt).float()

    fh, use_beta = r.shape[1], bh is not None
    p = h.shape[0]
    w = wn.float()
    hf, rf, sf, skf = h.float(), r.float(), s2.float(), skyh.float()
    sigma = F_t.softplus(hf @ w[0] + bn[0])
    cs = torch.sigmoid(rf @ w[1:4, :fh].T + bn[1:4])
    sunv = torch.sigmoid(sf @ w[4, :fh] + bn[4])
    sky = torch.sigmoid(skf @ w[5:8, :fh].T + bn[5:8])
    gr = g[:, 0:3] * (1 + 2 * pad) * cs * (1 - cs)
    gs = g[:, 3] * -torch.expm1(-sigma)
    gsu = g[:, 4] * sunv * (1 - sunv)
    # sky is the ray's: its cotangent sums over the samples before anything
    gk = g[:, 5:8].reshape(p // samples, samples, 3).sum(1) * sky * (1 - sky)
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
        beta = F_t.softplus(bh.float() @ w[8, :fh] + bn[8])
        gb = g[:, 8] * -torch.expm1(-beta)
        dwn[8, :fh], dbn[8] = rnd(gb) @ bh.float(), gb.sum()
        out["d_bh"] = rnd(gb)[:, None] * w[8, :fh][None, :]
    out["dwn"], out["dbn"] = dwn, dbn
    return out, sigma


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("use_beta,samples", [(True, 6), (False, 6), (True, 1)])
def test_field_heads_bwd_formulas_match_autograd(dtype, use_beta, samples):
    """The kernel's formulas against autograd through field_heads_reference,
    1e-5 of each tensor's largest entry (float32 arithmetic in another
    order). The last sample of ray 0 has a sigma below 1e-8: its softplus'
    is about sigma, which -expm1(-sigma) keeps and 1 - exp(-sigma) loses."""
    gen = torch.Generator().manual_seed(2)
    n_r, feat = 9, 32
    p, fh = n_r * samples, feat // 2

    def mk(*shape):
        return (torch.rand(*shape, generator=gen) * 2 - 1).to(dtype)

    h, r, s2 = mk(p, feat), mk(p, fh), mk(p, fh)
    bh = mk(p, fh) if use_beta else None
    skyh = torch.relu(mk(n_r, fh))
    wn = mk(9, feat) * 0.8
    bn = torch.randn(9, generator=gen) * 0.3
    faint = samples - 1
    # pre-activation -20 -> sigma = 2e-9
    h[faint] = (-(20.0 + bn[0]) * wn[0].float()
                / (wn[0].float() ** 2).sum()).to(dtype)
    g = torch.randn(p, 16, generator=gen)
    ref = FM.field_heads_bwd_reference(h, r, s2, bh, skyh, wn, bn, samples, g)
    got, sigma = _manual_field_heads_bwd(h, r, s2, bh, skyh, wn, bn, samples,
                                         g)
    assert 0 < float(sigma[faint]) < 1e-8
    assert float(1.0 - torch.exp(-sigma[faint])) == 0.0  # what float32 loses
    row = ref["d_h"][faint]
    assert float(row.abs().max()) > 0  # the faint sample keeps its gradient
    assert float((got["d_h"][faint] - row).abs().max()
                 / row.abs().max()) <= (1e-5 if dtype == torch.float32
                                        else 1e-2)  # one bf16 rounding of g
    for k, v in ref.items():
        if v is None:
            assert got[k] is None
            continue
        assert torch.isfinite(got[k]).all(), k
        scale = v.abs().max().clamp_min(1e-20)
        assert float((got[k] - v).abs().max() / scale) <= 1e-5, k


def test_field_heads_is_the_field_modules_heads():
    """field_heads' plain version against the port's field module: the same
    per-sample outputs from the module's own activations, and the column
    layout of K5 (rgb 0:3, sigma 3, sun_v 4, sky 5:8, beta 8, zeros after)."""
    _, params = _jax_params("sat-nerf")
    field = _port_field("sat-nerf", params)
    o, d, sun, t, z, _ = (torch.from_numpy(a) for a in _ray_inputs(7, 5))
    packed = FM.pack_params(field, skip=4, use_beta=True, dtype=torch.float32)
    rays16 = FM.pack_rays(o, d, sun, t, TAU)
    a = FM._chain_forward(packed, rays16, z, skip=4, use_beta=True)
    out = FM.field_heads(a["h"], a["r"], a["s2"], a["bh"], a["skyh"],
                         packed["wn"], packed["bn"], 5)
    want = FM.fused_field_apply_rays_reference(
        field, o, d, sun, t, z, layers=LAYERS, feat=F, tau=TAU,
        dtype=torch.float32)
    assert out.shape == (35, 16) and float(out[:, 9:].abs().max()) == 0
    got = FM._field_dict(out, (7, 5), True)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.detach().numpy(),
                                   atol=2e-6, err_msg=k)


def test_wrappers_raise_instead_of_falling_back():
    field = build_model("sat-nerf", LAYERS, F, t_dim=TAU)
    o, d, sun, t, z, _ = (torch.from_numpy(a) for a in _ray_inputs(4, 8))
    with pytest.raises(ValueError):  # field / arguments mismatch
        FM.fused_field_apply_rays(field, o, d, sun, t, z, layers=8, feat=F,
                                  tau=TAU, dtype=torch.float32)
    with pytest.raises(ValueError):
        FM.fused_field_apply(field, o, sun, t, layers=8, feat=F, tau=TAU,
                             dtype=torch.float32)
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError):
        FM.fused_field_apply_rays(field, o, d, sun, t, meta, layers=LAYERS,
                                  feat=F, tau=TAU)
    with pytest.raises(ValueError):
        FM.fused_field_apply(field, torch.zeros(4, 3, device="meta"), sun, t,
                             layers=LAYERS, feat=F, tau=TAU)
