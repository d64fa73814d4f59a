"""The port's classic-NeRF kernels' plain versions and kernel chains,
fused_nerf_train_loss_grads (K7), fused_nerf_render_rays (K8) and
fused_nerf_apply (K9), against the JAX package: the same numpy-seeded weights,
rays, depths, sigma noise and cotangents on both sides, float32 on the CPU.

  (a) the Pallas kernels of satnerf_tpu/ops/pallas/fused_nerf.py in interpret
      mode, as tests/test_fused_nerf.py runs them: products 2e-4 (their
      fast_sin / fast_cos err up to 1.7e-5 on every term of the encoding),
      gradients 1e-3 of each tensor's largest entry.
  (b) the flax field with render/composite.py under jax.grad: products 2e-5,
      gradients 1e-4 of each tensor's largest entry.

On the CPU the three entry points are their plain versions (the field module
and plain autograd). The chains the card runs (`_render_staged`,
`_train_staged`, the autograd function `_NerfApply`: ten dense launches with
the encoding as a computed operand, the per-ray or per-point stage, nine
dgrad and ten wgrad launches masked on the stored activations, unpack_grads)
run here on CPU tensors with the plain stages and are held to the same
oracles. The formulas the per-ray and per-point CUDA kernels evaluate are
written out in torch below and held against autograd, with a last sample
whose sigma is too faint for 1 - exp(-sigma) in float32. The kernels
themselves are checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F_t
from jax.experimental.pallas import tpu as pltpu

from satnerf_tpu.models import build_model as jax_build_model
from satnerf_tpu.ops.pallas import fused_nerf as FNJ
from satnerf_tpu.render.composite import composite as jax_composite
from satnerf_tpu_torch.models.nerf import build_model, positional_encoding
from satnerf_tpu_torch.ops import fused_nerf as FN
from satnerf_tpu_torch.train.checkpoints import params_from_jax

torch.set_num_threads(1)

F, LAYERS, FREQ = 32, 8, (10, 4)
KW = dict(layers=LAYERS, feat=F, skip=4)
SKW = dict(skip=4, n_freq=FREQ, rgb_padding=0.001)
# rays, samples a ray; 11 x 5 = 55 points: no multiple of any tile
CASES = {"even": (16, 16), "ragged": (11, 5)}


def _jax_params(seed=0):
    m = jax_build_model("nerf", LAYERS, F)
    params = m.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)),
                    view_dir=jnp.zeros((2, 3)))["params"]
    return m, jax.device_get(params)


def _port_field(params):
    field = build_model("nerf", LAYERS, F)
    sd = params_from_jax({"coarse": params}, "nerf", LAYERS)
    field.load_state_dict({k[len("nerf_coarse."):]: v for k, v in sd.items()})
    return field


def _named(jax_grads):
    sd = params_from_jax({"coarse": jax_grads}, "nerf", LAYERS)
    return {k[len("nerf_coarse."):]: v.numpy() for k, v in sd.items()}


def _ray_inputs(n_rays, n_s, seed=41):
    rng = np.random.RandomState(seed)
    o = rng.randn(n_rays, 3).astype(np.float32) * 0.2
    d = rng.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.rand(n_rays, n_s).astype(np.float32), -1) + 0.1
    noise = rng.randn(n_rays, n_s).astype(np.float32)
    gt = rng.rand(n_rays, 3).astype(np.float32)
    return o, d, z, noise, gt


def _hold_grads(got: dict, want: dict, tol: float, tag: str,
                sigma_tol: float = None):
    """sigma_tol: the tolerance of the sigma head's two gradients, where it
    is not `tol` (K7 only, see test_k7_matches_jax)."""
    assert set(got) == set(want), tag
    for name, ref in want.items():
        g = got[name].detach().numpy()
        assert g.shape == ref.shape, (tag, name)
        scale = max(np.abs(ref).max(), 1e-12)
        if sigma_tol is not None and name.startswith("sigma_from_xyz"):
            tol = sigma_tol
        np.testing.assert_allclose(g / scale, ref / scale, atol=tol,
                                   err_msg=f"{tag} {name}")


# ------------------------------------------------------------------ K8


def _k8_oracle(m, params, inp, kernel):
    o, d, z = (jnp.asarray(a) for a in inp[:3])
    if kernel:
        with pltpu.force_tpu_interpret_mode():
            out = FNJ.fused_nerf_render_rays(params, o, d, z, dtype=jnp.float32,
                                             return_weights=True, **KW)
        return {k: np.asarray(v) for k, v in out.items()}
    xyz = o[:, None, :] + d[:, None, :] * z[:, :, None]
    vd = jnp.broadcast_to(d[:, None, :], xyz.shape)
    ref = jax_composite(m.apply({"params": params}, xyz, view_dir=vd), z,
                        shadow=False)
    return {"rgb": np.asarray(ref["rgb"]), "depth": np.asarray(ref["depth"]),
            "opacity": np.asarray(ref["weights"].sum(-1)),
            "weights": np.asarray(ref["weights"])}


def _k8_port(field, inp, staged, dtype=torch.float32):
    o, d, z = (torch.from_numpy(a) for a in inp[:3])
    if staged:  # the card's chain, on CPU tensors
        out, w = FN._render_staged(
            FN.pack_params(field, skip=4, dtype=dtype), FN.pack_rays(o, d), z,
            return_weights=True, **SKW)
        assert out.shape == (z.shape[0], 8)
        assert float(out[:, 5:].abs().max()) == 0
        return FN._products(out, w)
    return FN.fused_nerf_render_rays(field, o, d, z, dtype=dtype,
                                     return_weights=True, **KW)


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k8_matches_jax(case, staged):
    m, params = _jax_params()
    inp = _ray_inputs(*CASES[case])
    got = _k8_port(_port_field(params), inp, staged)
    for kernel, atol in ((False, 2e-5), (True, 2e-4)):
        want = _k8_oracle(m, params, inp, kernel)
        assert set(got) == set(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, k
            np.testing.assert_allclose(
                got[k].detach().numpy(), v, atol=atol,
                err_msg=f"{k} vs {'Pallas kernel' if kernel else 'flax'}")


def test_k8_without_weights_returns_the_jax_keys():
    _, params = _jax_params()
    o, d, z = (torch.from_numpy(a) for a in _ray_inputs(6, 4)[:3])
    out = FN.fused_nerf_render_rays(_port_field(params), o, d, z,
                                    dtype=torch.float32, **KW)
    assert set(out) == {"rgb", "depth", "opacity"}
    assert out["rgb"].shape == (6, 3) and out["depth"].shape == (6,)


# ------------------------------------------------------------------ K7


def _k7_oracle(m, params, inp, with_noise, kernel):
    o, d, z, noise, gt = (jnp.asarray(a) for a in inp)
    noise = noise if with_noise else None
    if kernel:
        with pltpu.force_tpu_interpret_mode():
            mse, g = FNJ.fused_nerf_train_loss_grads(
                params, o, d, z, noise, gt, dtype=jnp.float32, **KW)
        return float(mse), _named(jax.device_get(g))

    def loss(p):
        xyz = o[:, None, :] + d[:, None, :] * z[:, :, None]
        vd = jnp.broadcast_to(d[:, None, :], xyz.shape)
        res = jax_composite(m.apply({"params": p}, xyz, view_dir=vd), z,
                            noise=noise, shadow=False)
        return jnp.mean((res["rgb"] - gt) ** 2)

    mse, g = jax.value_and_grad(loss)(params)
    return float(mse), _named(jax.device_get(g))


def _k7_port(field, inp, with_noise, staged, dtype=torch.float32):
    o, d, z, noise, gt = (torch.from_numpy(a) for a in inp)
    noise = noise if with_noise else None
    if staged:
        with torch.no_grad():
            sq, g = FN._train_staged(
                FN.pack_params(field, skip=4, dtype=dtype), FN.pack_rays(o, d),
                z, noise, gt, **SKW)
            return (float(sq[0] / (3.0 * z.shape[0])),
                    FN.unpack_grads(g, field, skip=4))
    mse, grads = FN.fused_nerf_train_loss_grads(field, o, d, z, noise, gt,
                                                dtype=dtype, **KW)
    return float(mse), grads


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
@pytest.mark.parametrize("case,with_noise", [("even", True), ("even", False),
                                             ("ragged", True)])
def test_k7_matches_jax(case, with_noise, staged):
    m, params = _jax_params()
    inp = _ray_inputs(*CASES[case])
    mse, grads = _k7_port(_port_field(params), inp, with_noise, staged)
    want_mse, want = _k7_oracle(m, params, inp, with_noise, False)
    np.testing.assert_allclose(mse, want_mse, atol=2e-5)
    # the sigma head's gradient sums, sample by sample, the difference
    # dw * T - suffix / (1 - alpha) of the compositor adjoint: in float32 both
    # packages are 5e-4 of its largest entry away from a float64 evaluation
    # of the same loss on these inputs, so they are held to 1e-3 there
    _hold_grads(grads, want, 1e-4, "vs flax", sigma_tol=1e-3)
    if not staged or case == "ragged":
        # the Pallas kernel forms softplus' as 1 - exp(-sigma), the port as
        # -expm1(-sigma): they differ by at most 6e-8 of a sample's cotangent
        # (the rounding of exp(-sigma) near 1), far inside 1e-3
        k_mse, k_want = _k7_oracle(m, params, inp, with_noise, True)
        np.testing.assert_allclose(mse, k_mse, atol=2e-4)
        _hold_grads(grads, k_want, 1e-3, "vs Pallas kernel")


def test_softplus_slope_forms_differ_by_a_rounding_of_one():
    """-expm1(-s) against 1 - exp(-s) in float32: at most 6e-8 apart (half an
    ulp of exp(-s) <= 1), and only the first is nonzero below 1e-8."""
    s = torch.logspace(-12, 2, 2000, dtype=torch.float32)
    a, b = -torch.expm1(-s), 1.0 - torch.exp(-s)
    assert float((a - b).abs().max()) <= 6e-8
    faint = s < 1e-8
    assert bool((b[faint] == 0).all()) and bool((a[faint] > 0).all())


# ------------------------------------------------------------------ K9


def _k9_oracle(m, params, xyz, vd, cot, kernel):
    xyz_j, cot_j = jnp.asarray(xyz), jnp.asarray(cot)
    vd_j = None if vd is None else jnp.asarray(vd)

    def field(p):
        if kernel:
            return FNJ.fused_nerf_apply(p, xyz_j, vd_j, dtype=jnp.float32, **KW)
        return m.apply({"params": p}, xyz_j, view_dir=(
            jnp.zeros_like(xyz_j) if vd_j is None else vd_j))

    def contract(p):
        out = field(p)
        return ((out["rgb"] * cot_j[..., 0:3]).sum()
                + (out["sigma"] * cot_j[..., 3]).sum())

    def run():
        out = field(params)
        return ({k: np.asarray(v) for k, v in out.items()},
                _named(jax.device_get(jax.grad(contract)(params))))

    if kernel:
        with pltpu.force_tpu_interpret_mode():
            return run()
    return run()


def _k9_port(field, xyz, vd, cot, staged, dtype=torch.float32):
    x = torch.from_numpy(xyz).requires_grad_(True)
    v = None if vd is None else torch.from_numpy(vd).requires_grad_(True)
    c = torch.from_numpy(cot)
    if staged:  # the card's autograd function, on CPU tensors
        lead = tuple(x.shape[:-1])
        pts = x.detach().reshape(-1, 3)
        dirs = torch.zeros_like(pts) if v is None else v.detach().reshape(-1, 3)
        cfg = dict(skip=4, n_freq=FREQ, rgb_padding=0.001, dtype=dtype)
        out = FN._NerfApply.apply(field, cfg, pts, dirs, *field.parameters())
        assert out.shape == (pts.shape[0], 8)
        assert float(out.detach()[:, 4:].abs().max()) == 0
        out = {"rgb": out[:, 0:3].reshape(*lead, 3),
               "sigma": out[:, 3].reshape(*lead)}
    else:
        out = FN.fused_nerf_apply(field, x, v, dtype=dtype, **KW)
    total = (out["rgb"] * c[..., 0:3]).sum() + (out["sigma"] * c[..., 3]).sum()
    grads = torch.autograd.grad(total, list(field.parameters()),
                                allow_unused=True)
    named = {n: (torch.zeros_like(p) if g is None else g)
             for (n, p), g in zip(field.named_parameters(), grads)}
    return {k: v_.detach() for k, v_ in out.items()}, named


def _point_inputs(lead, with_dir, seed=43):
    rng = np.random.RandomState(seed)
    xyz = rng.randn(*lead, 3).astype(np.float32) * 0.3
    vd = rng.randn(*lead, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    cot = rng.randn(*lead, 4).astype(np.float32)
    return xyz, (vd if with_dir else None), cot


# leading shape, with a view direction, also against the Pallas kernel
K9_CASES = {"points": ((70,), True, True), "leading": ((10, 6), True, False),
            "no_dir": ((11, 5), False, True)}


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
@pytest.mark.parametrize("case", sorted(K9_CASES))
def test_k9_matches_jax(case, staged):
    lead, with_dir, with_kernel = K9_CASES[case]
    m, params = _jax_params()
    xyz, vd, cot = _point_inputs(lead, with_dir)
    out, grads = _k9_port(_port_field(params), xyz, vd, cot, staged)
    oracles = [(False, 2e-5, 1e-4)]
    if with_kernel and not staged:
        oracles.append((True, 2e-4, 1e-3))
    for kernel, atol, gtol in oracles:
        tag = "vs Pallas kernel" if kernel else "vs flax"
        o_out, o_grads = _k9_oracle(m, params, xyz, vd, cot, kernel)
        assert set(out) == set(o_out) == {"rgb", "sigma"}
        # sigma is a softplus of an unbounded sum: relative to its size
        for k, v in o_out.items():
            assert tuple(out[k].shape) == v.shape == lead + ((3,) if k == "rgb"
                                                             else ()), k
            np.testing.assert_allclose(out[k].numpy(), v, atol=atol, rtol=atol,
                                       err_msg=f"{tag} {k}")
        _hold_grads(grads, o_grads, gtol, tag)


@torch.no_grad()
def test_k9_zero_directions_are_not_a_zero_encoding():
    """view_dir None means zero directions, whose encoding has cos 0 = 1 in
    its cosine columns: not the same as leaving the direction rows out."""
    _, params = _jax_params()
    field = _port_field(params)
    xyz, _, _ = _point_inputs((9,), False)
    x = torch.from_numpy(xyz)
    got = FN.fused_nerf_apply(field, x, None, dtype=torch.float32, **KW)
    zeros = FN.fused_nerf_apply(field, x, torch.zeros_like(x),
                                dtype=torch.float32, **KW)
    assert torch.equal(got["rgb"], zeros["rgb"])
    assert torch.equal(got["sigma"], zeros["sigma"])
    enc = FN._encoding(FN.pack_rays(x, torch.zeros_like(x)), 1,
                       torch.zeros(9, 1), "dir", 4, 32, torch.float32)
    assert float(enc.sum()) == 9 * 12  # the 12 cosine columns of each point
    # sigma reads no direction; the color does
    other = FN.fused_nerf_apply(field, x, torch.ones_like(x) / 3 ** 0.5,
                                dtype=torch.float32, **KW)
    assert torch.equal(got["sigma"], other["sigma"])
    assert float((got["rgb"] - other["rgb"]).abs().max()) > 1e-4


def test_k9_no_graph_saves_nothing_and_backward_frees_the_chain():
    _, params = _jax_params()
    field = _port_field(params)
    xyz, vd, _ = _point_inputs((12,), True)
    pts, dirs = torch.from_numpy(xyz), torch.from_numpy(vd)
    cfg = dict(skip=4, n_freq=FREQ, rgb_padding=0.001, dtype=torch.float32)
    with torch.no_grad():
        quiet = FN._NerfApply.apply(field, cfg, pts, dirs, *field.parameters())
    assert quiet.grad_fn is None and quiet.shape == (12, 8)
    out = FN._NerfApply.apply(field, cfg, pts, dirs, *field.parameters())
    assert float((out.detach() - quiet).abs().max()) <= 1e-6
    node = out.grad_fn
    assert node.chain is not None
    out[:, 3].sum().backward()
    assert node.chain is None
    # sigma reads the trunk only: the color head stays still
    assert field.rgb_from_xyzdir[0].weight.grad.abs().max() == 0
    assert field.feats_from_xyz.weight.grad.abs().max() == 0
    assert field.sigma_from_xyz[0].weight.grad.abs().max() > 0
    assert field.fc_net[0].weight.grad.abs().max() > 0


# ---------------------------------------------------- bf16, packing, stages


@pytest.mark.parametrize("which", ["k7", "k8", "k9"])
def test_staged_bf16_matches_plain_bf16(which):
    """bf16 operands: the chains over plain stages against the field module
    with rounded matmuls: the forward's products 1e-5 (the same roundings),
    gradients 2e-3 of each tensor's largest entry (the module rounds a
    cotangent once a matmul, the chain once a launch: the same places, sums
    in another order)."""
    _, params = _jax_params()
    field = _port_field(params)
    bf = torch.bfloat16
    if which == "k8":
        inp = _ray_inputs(16, 8)
        ref, got = (_k8_port(field, inp, s, bf) for s in (False, True))
        for k in ref:
            assert float((got[k] - ref[k]).abs().max()) <= 1e-5, k
        return
    if which == "k7":
        inp = _ray_inputs(16, 8)
        (r_mse, ref), (g_mse, got) = (_k7_port(field, inp, True, s, bf)
                                      for s in (False, True))
        assert abs(r_mse - g_mse) <= 1e-5
    else:
        xyz, vd, cot = _point_inputs((16, 8), True)
        (r_out, ref), (g_out, got) = (_k9_port(field, xyz, vd, cot, s, bf)
                                      for s in (False, True))
        for k in r_out:
            assert float((g_out[k] - r_out[k]).abs().max()) <= 1e-5, k
    for name, r in ref.items():
        scale = r.abs().max().clamp_min(1e-12)
        assert float((got[name] - r).abs().max() / scale) <= 2e-3, name


def test_pack_params_layout_and_unpack_round_trip():
    """The skip layer splits into its encoding rows (first) and its h rows,
    rgb_0 into feats rows and direction rows; encoding blocks are padded with
    zero rows to a multiple of 32; unpack_grads undoes all of it."""
    _, params = _jax_params()
    field = _port_field(params)
    p = FN.pack_params(field, skip=4, dtype=torch.float32)
    assert p["A"].shape == (64, F) and p["C"].shape == (64, F)
    assert p["Wrgb0d"].shape == (32, F // 2) and p["Wrgb0h"].shape == (F, F // 2)
    assert float(p["A"][60:].abs().max()) == 0
    assert float(p["C"][60:].abs().max()) == 0
    assert float(p["Wrgb0d"][24:].abs().max()) == 0
    assert len(p["B"]) == LAYERS - 1 and all(w.shape == (F, F) for w in p["B"])
    w4 = field.fc_net[8].weight.detach().t()  # (60 + F, F), encoding first
    assert torch.equal(p["C"][:60], w4[:60]) and torch.equal(p["B"][3], w4[60:])
    assert p["wn"].shape == (4, F) and float(p["wn"][1:, F // 2:].abs().max()) == 0
    back = FN.unpack_grads(p, field, skip=4)
    for name, q in field.named_parameters():
        assert torch.equal(back[name].reshape(q.shape), q.detach()), name
    # the same split as the JAX package's packing
    pj = FNJ.pack_params(params, LAYERS, F, 4, 10, 4, dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(pj["C"]), p["C"].numpy())
    np.testing.assert_array_equal(np.asarray(pj["A"]), p["A"].numpy())
    np.testing.assert_array_equal(np.asarray(pj["Wrgb0d"]), p["Wrgb0d"].numpy())
    np.testing.assert_array_equal(np.asarray(pj["B"][3]), p["B"][3].numpy())


@pytest.mark.parametrize("enc", ["xyz", "dir"])
def test_nerf_dense_encoding_operand_is_the_jax_posenc(enc):
    """The computed operand of nerf_dense against the JAX package's in-kernel
    _posenc (same per-frequency [sin, cos] order; its fast trig errs 1.7e-5)
    and the port's positional_encoding."""
    o, d, z, _, _ = _ray_inputs(5, 3)
    n_freq, rows = (10, 64) if enc == "xyz" else (4, 32)
    rays8 = FN.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    e = FN._encoding(rays8, 3, torch.from_numpy(z), enc, n_freq, rows,
                     torch.float32)
    x = (o[:, None] + d[:, None] * z[:, :, None]).reshape(-1, 3) \
        if enc == "xyz" else np.repeat(d, 3, axis=0)
    want = np.asarray(FNJ._posenc(jnp.asarray(x), n_freq, rows))
    assert e.shape == want.shape == (15, rows)
    np.testing.assert_allclose(e.numpy(), want, atol=1e-4)
    assert float(e[:, 6 * n_freq:].abs().max()) == 0
    assert torch.equal(e[:, :6 * n_freq],
                       positional_encoding(torch.from_numpy(x), n_freq))
    # as the kernel's second operand: act(x.W + b + enc.C)
    g = torch.Generator().manual_seed(0)
    c = torch.randn(rows, 8, generator=g)
    c[6 * n_freq:] = 0
    w, xin = torch.randn(4, 8, generator=g), torch.randn(15, 4, generator=g)
    bias = torch.randn(8, generator=g)
    y = FN.nerf_dense(xin, w, bias, rays8, 3, enc=enc, enc_weight=c,
                      z=torch.from_numpy(z), n_freq=n_freq)
    want_y = torch.relu(xin @ w + bias + e @ c)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), atol=1e-5)


def _chunked_transmittance(keep, chunk):
    """T as csrc/fused_nerf.cu nerf_composite_loss_bwd_block forms it: within
    each chunk of `chunk` samples the exclusive product of the fp32 factors
    in double, times the product of the earlier chunks' factors (carried in
    double), rounded once to fp32."""
    k = keep.double()
    trans, carry = torch.empty_like(k), torch.ones(k.shape[0], dtype=torch.float64)
    for c0 in range(0, k.shape[1], chunk):
        inc = torch.cumprod(k[:, c0:c0 + chunk], 1)
        exc = torch.cat([torch.ones_like(inc[:, :1]), inc[:, :-1]], 1)
        trans[:, c0:c0 + chunk] = carry[:, None] * exc
        carry = carry * inc[:, -1]
    return trans.float()


def _chunked_suffix(v, chunk):
    """The sum of v over the later samples as the block body forms it: an
    exclusive suffix sum within each chunk, plus the later chunks' totals
    carried from the last chunk to the first."""
    out, carry = torch.empty_like(v), torch.zeros(v.shape[0])
    starts = list(range(0, v.shape[1], chunk))
    for c0 in reversed(starts):
        part = v[:, c0:c0 + chunk]
        out[:, c0:c0 + chunk] = (part.flip(1).cumsum(1).flip(1) - part) + carry[:, None]
        carry = carry + part.sum(1)
    return out


def _manual_composite_loss_bwd(h, r, wn, bn, z, noise, gt, pad=0.001,
                               chunk=None):
    """The formulas of csrc/fused_nerf.cu nerf_composite_loss_bwd_block, step
    by step: the forward along the ray, the squared error, the suffix-sum
    adjoint, the narrow heads' backward with rounded cotangents. chunk None
    takes T and the suffix sum along the ray in order (a walk); a number
    takes them in the kernel's order over chunks of that many samples."""
    dt = wn.dtype

    def rnd(x):
        return x.to(dt).float()

    n_r, n_s = z.shape
    fh, w = r.shape[1], wn.float()
    hf, rf = h.float(), r.float()
    sigma = F_t.softplus(hf @ w[0] + bn[0]).reshape(n_r, n_s)
    cs = torch.sigmoid(rf @ w[1:4, :fh].T + bn[1:4]).reshape(n_r, n_s, 3)
    rgb_s = cs * (1 + 2 * pad) - pad
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n_r, 1), 1e10)], 1)
    sn = sigma + (0 if noise is None else noise)
    oma = torch.exp(-delta * sn.clamp_min(0))
    alpha = 1 - oma
    keep = 1 - alpha + 1e-10
    if chunk is None:
        trans = torch.cat([torch.ones(n_r, 1), torch.cumprod(keep, 1)[:, :-1]], 1)
    else:
        trans = _chunked_transmittance(keep, chunk)
    wts = alpha * trans
    rgb = (wts[..., None] * rgb_s).sum(1)
    diff = rgb - gt
    g_rgb = diff * (2.0 / (3.0 * n_r))
    dw = (rgb_s * g_rgb[:, None, :]).sum(-1)
    dww = dw * wts
    if chunk is None:
        suffix = dww.flip(1).cumsum(1).flip(1) - dww  # over the later samples
    else:
        suffix = _chunked_suffix(dww, chunk)
    d_alpha = dw * trans - suffix / keep
    d_sn = torch.where(sn > 0, d_alpha * oma * delta, torch.zeros(()))
    g_sig = (d_sn * -torch.expm1(-sigma)).reshape(-1)
    g_pre = (wts[..., None] * g_rgb[:, None, :] * (1 + 2 * pad) * cs
             * (1 - cs)).reshape(-1, 3)
    dwn, dbn = torch.zeros(4, h.shape[1]), torch.zeros(4)
    dwn[0], dbn[0] = rnd(g_sig) @ hf, g_sig.sum()
    dwn[1:4, :fh], dbn[1:4] = rnd(g_pre).T @ rf, g_pre.sum(0)
    return {"loss_sum": (diff ** 2).sum().reshape(1),
            "d_h": rnd(g_sig)[:, None] * w[0][None, :],
            "d_r": rnd(g_pre) @ w[1:4, :fh], "dwn": dwn, "dbn": dbn}, sigma


def _hold_formulas(dtype, with_noise, n_s, chunk, steps=False):
    """_manual_composite_loss_bwd (with `chunk`) against autograd through
    nerf_composite_loss_bwd_reference on 7 rays of n_s samples, 1e-5 of each
    tensor's largest entry; with `steps` a cotangent entry may also differ by
    one bf16 step of itself, and d_r (three products of rounded cotangents)
    by one of a term. The last sample of ray 0 has a sigma below 1e-8
    and, with delta 1e10, still has weight: its softplus' is about sigma,
    which -expm1(-sigma) keeps and 1 - exp(-sigma) loses."""
    gen = torch.Generator().manual_seed(3)
    n_r, feat = 7, 32
    p, fh = n_r * n_s, feat // 2

    def mk(*shape):
        return (torch.rand(*shape, generator=gen) * 2 - 1).to(dtype)

    h, r = mk(p, feat), mk(p, fh)
    wn = mk(4, feat) * 0.8
    wn[1:, fh:] = 0
    bn = torch.randn(4, generator=gen) * 0.3
    faint = n_s - 1  # the last sample of ray 0: pre-activation -20
    h[faint] = (-(20.0 + bn[0]) * wn[0].float()
                / (wn[0].float() ** 2).sum()).to(dtype)
    z = torch.sort(torch.rand(n_r, n_s, generator=gen), 1)[0] + 0.1
    noise = torch.randn(n_r, n_s, generator=gen) * 0.5 if with_noise else None
    if with_noise:
        noise[0, faint] = 0.0  # the faint sample stays on the relu's open side
    gt = torch.rand(n_r, 3, generator=gen)
    ref = FN.nerf_composite_loss_bwd_reference(h, r, wn, bn, z, noise, gt)
    got, sigma = _manual_composite_loss_bwd(h, r, wn, bn, z, noise, gt,
                                            chunk=chunk)
    assert 0 < float(sigma[0, faint]) < 1e-8
    assert float(1.0 - torch.exp(-sigma[0, faint])) == 0.0
    row = ref["d_h"][faint]
    assert float(row.abs().max()) > 0  # the faint sample keeps its gradient
    assert float((got["d_h"][faint] - row).abs().max() / row.abs().max()) <= (
        1e-5 if dtype == torch.float32 else 1e-2)  # one bf16 rounding of g
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.isfinite(got[k]).all(), k
        scale = v.abs().max().clamp_min(1e-20)
        lim = 1e-5 * scale
        if steps and k.startswith("d_"):
            lim = lim + 2.0 ** -7 * v.abs() + (2.0 ** -8 * scale if k == "d_r" else 0)
        assert bool(((got[k] - v).abs() <= lim).all()), (
            k, float((got[k] - v).abs().max() / scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_noise", [True, False], ids=["noise", "quiet"])
def test_composite_loss_bwd_formulas_match_autograd(dtype, with_noise):
    """The kernel's formulas, T and the suffix sum taken along the ray in
    order, against autograd (float32 arithmetic in another order): six
    samples a ray, one chunk."""
    _hold_formulas(dtype, with_noise, 6, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_noise", [True, False], ids=["noise", "quiet"])
def test_composite_loss_bwd_block_order_matches_autograd(dtype, with_noise):
    """The block body's order over three chunks of 256 (S = 600): T a product
    in double within each chunk, carried from chunk to chunk and rounded
    once; the suffix sum within a chunk plus the later chunks' totals. Over
    4,200 samples a bf16 cotangent lands on the other side of a rounding
    boundary from autograd's (d_h: 2.4e-5 of its largest entry, one step
    of the entry), so in bf16 a cotangent entry is also held to one step."""
    _hold_formulas(dtype, with_noise, 600, 256, steps=dtype == torch.bfloat16)


def test_field_heads_is_the_field_modules_heads():
    """nerf_field_heads' plain version on the chain's activations against the
    port's field module, and the (P, 8) layout of the JAX kernel: rgb 0:3,
    sigma 3, zeros after."""
    _, params = _jax_params()
    field = _port_field(params)
    o, d, z, _, _ = _ray_inputs(7, 5)
    packed = FN.pack_params(field, skip=4, dtype=torch.float32)
    rays8 = FN.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    a = FN._chain_forward(packed, rays8, torch.from_numpy(z), skip=4,
                          n_freq=FREQ, keep=True)
    assert len(a["hs"]) == LAYERS and a["feats"].shape == (35, F)
    out = FN.nerf_field_heads(a["hs"][-1], a["r"], packed["wn"], packed["bn"])
    assert out.shape == (35, 8) and float(out[:, 4:].abs().max()) == 0
    xyz = torch.from_numpy(o[:, None] + d[:, None] * z[:, :, None])
    want = field(xyz, view_dir=torch.from_numpy(d)[:, None].expand(7, 5, 3))
    np.testing.assert_allclose(out[:, 0:3].reshape(7, 5, 3).numpy(),
                               want["rgb"].detach().numpy(), atol=2e-6)
    np.testing.assert_allclose(out[:, 3].reshape(7, 5).numpy(),
                               want["sigma"].detach().numpy(), atol=2e-6,
                               rtol=2e-6)
    # its backward: the vector-Jacobian product against autograd's
    g = torch.randn(35, 8, generator=torch.Generator().manual_seed(1))
    res = FN.nerf_field_heads_bwd(a["hs"][-1], a["r"], packed["wn"],
                                  packed["bn"], g)
    assert res["d_h"].shape == (35, F) and res["d_r"].shape == (35, F // 2)
    assert float(res["dwn"][1:, F // 2:].abs().max()) == 0


def test_backward_masks_on_the_stored_activation():
    """dgrad and wgrad take the relu's mask from the layer's stored output:
    where it is 0 no cotangent passes, whatever dY holds; a linear layer
    (y None) passes all of it."""
    g = torch.Generator().manual_seed(5)
    dy, w = torch.randn(6, 4, generator=g), torch.randn(3, 4, generator=g)
    y = torch.relu(torch.randn(6, 4, generator=g))
    x = torch.randn(6, 3, generator=g)
    rays8 = torch.zeros(6, 8)
    masked = dy * (y > 0)
    np.testing.assert_allclose(FN.nerf_dense_dgrad(dy, y, w).numpy(),
                               (masked @ w.t()).numpy(), atol=1e-6)
    np.testing.assert_allclose(FN.nerf_dense_dgrad(dy, None, w).numpy(),
                               (dy @ w.t()).numpy(), atol=1e-6)
    base = torch.ones(6, 3)
    out = FN.nerf_dense_dgrad(dy, y, w, out=base)
    assert out is base
    np.testing.assert_allclose(base.numpy(), (1 + masked @ w.t()).numpy(),
                               atol=1e-6)
    dw, db, dc = FN.nerf_dense_wgrad(x, dy, y, rays8, 1)
    assert dc is None
    np.testing.assert_allclose(dw.numpy(), (x.t() @ masked).numpy(), atol=1e-6)
    np.testing.assert_allclose(db.numpy(), masked.sum(0).numpy(), atol=1e-6)
    dw, db, dc = FN.nerf_dense_wgrad(None, dy, y, rays8, 1, enc="dir",
                                     n_freq=4, enc_rows=32)
    assert dw is None and dc.shape == (32, 4)
    # zero directions: sin columns 0, cos columns 1
    enc = torch.zeros(6, 32)
    for k in range(4):
        enc[:, 6 * k + 3:6 * k + 6] = 1.0
    np.testing.assert_allclose(dc.numpy(), (enc.t() @ masked).numpy(), atol=1e-6)


def test_wrappers_raise_instead_of_falling_back():
    field = build_model("nerf", LAYERS, F)
    o, d, z, noise, gt = (torch.from_numpy(a) for a in _ray_inputs(4, 8))
    with pytest.raises(ValueError):  # field / arguments mismatch
        FN.fused_nerf_render_rays(field, o, d, z, layers=4, feat=F,
                                  dtype=torch.float32)
    with pytest.raises(ValueError):
        FN.fused_nerf_train_loss_grads(field, o, d, z, noise, gt, layers=LAYERS,
                                       feat=2 * F, dtype=torch.float32)
    with pytest.raises(ValueError):  # a SIREN field is not the nerf variant
        FN.fused_nerf_apply(build_model("s-nerf", LAYERS, F), o, d, **KW)
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError):
        FN.fused_nerf_render_rays(field, o, d, meta, **KW)
    with pytest.raises(ValueError):
        FN.fused_nerf_train_loss_grads(field, o, d, meta, None, gt, **KW)
    with pytest.raises(ValueError):
        FN.fused_nerf_apply(field, torch.zeros(4, 3, device="meta"), d, **KW)
