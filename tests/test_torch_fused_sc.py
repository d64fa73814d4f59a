"""The port's fused_sc_loss_grads (K3) against two JAX oracles, the same
numpy-seeded weights, depths and noise on both sides, float32 on the CPU:

  (a) the Pallas kernel fused_sc_loss_grads in interpret mode. Its fast_sin /
      fast_cos err up to 1.7e-5 a layer and it forms the transparency as
      exp(sum log(1 - alpha + 1e-10)) where the port multiplies directly:
      1e-3 of each gradient's largest entry, 1e-4 on term2 and term3.
  (b) jax.grad of train/losses.solar_correction_terms through the XLA
      render_rays with solar_correction on (the flax field marched along the
      sun rays): 1e-4 of each gradient's largest entry, 1e-5 on the terms.

On the CPU fused_sc_loss_grads is its plain version (autograd through the
field module). The kernel chain's staging (_sc_staged: the sun-only forward,
sc_loss_bwd's plain version, the backward through sun_v_net, feats and the
trunk, zeros for the heads it leaves out) runs here with the plain stages and
is held to the same oracles. The formulas the sc_loss_bwd CUDA kernel
evaluates are written out in torch below and held against autograd, with a
ray that saturates early. The kernel itself is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F_t
from jax.experimental.pallas import tpu as pltpu

from satnerf_tpu.models import build_model as jax_build_model
from satnerf_tpu.ops.pallas import fused_mlp as FMJ
from satnerf_tpu.render import RenderConfig, render_rays
from satnerf_tpu.train import losses as LJ
from satnerf_tpu_torch.models.nerf import build_model
from satnerf_tpu_torch.ops import fused_mlp as FM
from satnerf_tpu_torch.train.checkpoints import params_from_jax

torch.set_num_threads(1)

F, S, TAU, LAYERS, LAM = 32, 8, 4, 6, 0.1
RTOL_KERNEL, RTOL_XLA = 1e-3, 1e-4

# variant, rays, noise; with_kernel: also run the Pallas oracle
CASES = {
    "satnerf_noise": ("sat-nerf", 16, True, True),
    "snerf": ("s-nerf", 16, False, True),
    "ragged": ("sat-nerf", 19, True, True),
    "satnerf_no_noise": ("sat-nerf", 16, False, False),
}


def _jax_params(variant, seed=0, feat=F):
    m = jax_build_model(variant, LAYERS, feat)
    params = m.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)),
                    sun_dir=jnp.zeros((2, 3)),
                    t_embed=jnp.zeros((2, TAU)))["params"]
    return m, jax.device_get(params)


def _inputs(n_rays, with_noise, seed=21, n_s=S):
    rng = np.random.RandomState(seed)
    o = rng.randn(n_rays, 3).astype(np.float32) * 0.2
    sun = rng.randn(n_rays, 3).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    t = rng.randn(n_rays, TAU).astype(np.float32)
    z = np.sort(rng.rand(n_rays, n_s).astype(np.float32) * 3, -1)
    noise = (rng.randn(n_rays, n_s).astype(np.float32) * 0.5
             if with_noise else None)
    return o, sun, t, z, noise


def _port_field(variant, params, feat=F):
    field = build_model(variant, LAYERS, feat, t_dim=TAU)
    sd = params_from_jax({"coarse": params}, variant, LAYERS)
    field.load_state_dict({k[len("nerf_coarse."):]: v for k, v in sd.items()})
    return field


def _named(jax_grads, variant):
    sd = params_from_jax({"coarse": jax_grads}, variant, LAYERS)
    return {k[len("nerf_coarse."):]: v.numpy() for k, v in sd.items()}


def _xla_oracle(m, params, inp, variant):
    """Terms 2 and 3 of the sun-ray pass as `--fused off` computes them:
    the field along o + sun * z, composite with this pass's noise,
    solar_correction_terms."""
    from satnerf_tpu.render.composite import composite

    o, sun, t, z, noise = (None if a is None else jnp.asarray(a) for a in inp)
    use_beta = variant == "sat-nerf"
    r, s = z.shape

    def loss_fn(p):
        xyz = o[:, None, :] + sun[:, None, :] * z[:, :, None]
        sd = jnp.broadcast_to(sun[:, None, :], xyz.shape)
        tb = (jnp.broadcast_to(t[:, None, :], (r, s, TAU)) if use_beta else None)
        out = m.apply({"params": p}, xyz, sun_dir=sd, t_embed=tb)
        sc = composite(out, z, noise=noise, shadow=True)
        res = {"sun_sc_coarse": sc["sun"], "weights_sc_coarse": sc["weights"],
               "transparency_sc_coarse": sc["transparency"]}
        t2, t3 = LJ.solar_correction_terms(res, "coarse", LAM)
        return t2 + t3, (t2, t3)

    (_, (t2, t3)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return {"term2": float(t2), "term3": float(t3)}, jax.device_get(g)


def _kernel_oracle(params, inp, variant, feat=F):
    o, sun, t, z, noise = (None if a is None else jnp.asarray(a) for a in inp)
    use_beta = variant == "sat-nerf"
    with pltpu.force_tpu_interpret_mode():
        parts, g = FMJ.fused_sc_loss_grads(
            params, o, sun, t if use_beta else None, z, noise, LAM,
            layers=LAYERS, feat=feat, use_beta=use_beta, tau=TAU,
            dtype=jnp.float32)
    return {k: float(v) for k, v in parts.items()}, jax.device_get(g)


def _port(field, inp, variant, staged, dtype=torch.float32, feat=F):
    o, sun, t, z, noise = (None if a is None else torch.from_numpy(a)
                           for a in inp)
    use_beta = variant == "sat-nerf"
    if not staged:
        return FM.fused_sc_loss_grads(
            field, o, sun, t if use_beta else None, z, noise, LAM,
            layers=LAYERS, feat=feat, use_beta=use_beta, tau=TAU, dtype=dtype)
    rays16 = FM.pack_rays(o, sun, sun, t if use_beta else None, TAU)
    packed = FM.pack_params(field, skip=4, use_beta=use_beta, dtype=dtype)
    sums, g = FM._sc_staged(packed, rays16, z, noise, LAM / 3.0, skip=4,
                            use_beta=use_beta)
    n = z.shape[0]
    parts = {"term2": LAM / 3.0 * sums[0] / n, "term3": LAM / 3.0 * sums[1] / n}
    return parts, FM.unpack_grads(g, field, skip=4, use_beta=use_beta)


def _hold(port, oracle, variant, rtol, tag):
    parts, grads = port
    o_parts, o_grads = oracle
    for k, v in o_parts.items():
        np.testing.assert_allclose(float(parts[k]), v, atol=rtol / 10,
                                   err_msg=f"{tag} {k}")
    want = _named(o_grads, variant)
    assert set(grads) == set(want), tag
    moved = 0
    for name, ref in want.items():
        got = grads[name].detach().numpy()
        assert got.shape == ref.shape, (tag, name)
        top = np.abs(ref).max()
        if top == 0.0:  # a head terms 2 and 3 do not reach
            assert np.abs(got).max() == 0.0, (tag, name)
            continue
        moved += 1
        np.testing.assert_allclose(got / top, ref / top, atol=rtol,
                                   err_msg=f"{tag} {name}")
    assert moved >= 2 * (LAYERS + 5)  # trunk, sigma excluded; feats; sun_v_net


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k3_matches_jax(case, staged):
    variant, n_rays, with_noise, with_kernel = CASES[case]
    m, params = _jax_params(variant)
    inp = _inputs(n_rays, with_noise)
    field = _port_field(variant, params)
    port = _port(field, inp, variant, staged)
    _hold(port, _xla_oracle(m, params, inp, variant), variant, RTOL_XLA,
          "vs XLA path")
    if with_kernel and not staged:
        _hold(port, _kernel_oracle(params, inp, variant), variant,
              RTOL_KERNEL, "vs Pallas kernel")


def test_xla_render_rays_returns_the_same_sun_pass():
    """The JAX render_rays with solar_correction and the port's give the
    same weights_sc / transparency_sc / sun_sc at the same depths (noise
    off, perturb 0 so both draw the same depths): 2e-5."""
    from satnerf_tpu_torch.render.render import RenderConfig as TRenderConfig
    from satnerf_tpu_torch.render.render import render_rays as t_render_rays

    m, params = _jax_params("sat-nerf")
    field = _port_field("sat-nerf", params)
    rng = np.random.RandomState(3)
    rays = rng.rand(12, 11).astype(np.float32)
    rays[:, 6], rays[:, 7] = 0.2, 2.0
    t = rng.randn(12, TAU).astype(np.float32)
    kw = dict(variant="sat-nerf", n_samples=S, perturb=0.0,
              solar_correction=True)
    ref = render_rays({"coarse": m}, {"coarse": params}, jnp.asarray(rays),
                      jnp.asarray(t), jax.random.PRNGKey(0), RenderConfig(**kw))
    with torch.no_grad():
        got = t_render_rays({"coarse": field}, torch.from_numpy(rays),
                            torch.from_numpy(t), TRenderConfig(**kw),
                            dtype=torch.float32)
    for k in ("weights_sc_coarse", "transparency_sc_coarse", "sun_sc_coarse",
              "rgb_coarse", "depth_coarse"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("variant", ["sat-nerf", "s-nerf"])
def test_staged_bf16_matches_plain_bf16(variant):
    """bf16 operands: the chain of plain stages against autograd through the
    field module, both rounding operands and cotangents to bf16 at the same
    points: 2e-3 of each gradient's largest entry, 1e-5 on the terms."""
    _, params = _jax_params(variant)
    field = _port_field(variant, params)
    inp = _inputs(16, True)
    ref = _port(field, inp, variant, False, torch.bfloat16)
    got = _port(field, inp, variant, True, torch.bfloat16)
    for k in ref[0]:
        np.testing.assert_allclose(float(got[0][k]), float(ref[0][k]), atol=1e-5)
    for name, r in ref[1].items():
        scale = r.abs().max().clamp_min(1e-12)
        assert float((got[1][name] - r).abs().max() / scale) <= 2e-3, name


def _manual_sc_loss_bwd(h, s2, wn, bn, z, noise, lam3):
    """The formulas of csrc/fused_aux.cu sc_loss_bwd_block, step by step."""
    dt = wn.dtype

    def rnd(x):
        return x.to(dt).float()

    n_r, n_s = z.shape
    fh = s2.shape[1]
    w = wn.float()
    hf, sf = h.float(), s2.float()
    sigma = F_t.softplus(hf @ w[0] + bn[0]).reshape(n_r, n_s)
    sunv = torch.sigmoid(sf @ w[4, :fh] + bn[4]).reshape(n_r, n_s)
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n_r, 1), 1e10)], 1)
    sigma_n = sigma + (noise if noise is not None else 0)
    alpha = 1 - torch.exp(-delta * torch.relu(sigma_n))
    fac = 1 - alpha + 1e-10
    trans = torch.cumprod(torch.cat([torch.ones(n_r, 1), fac], 1), 1)[:, :-1]
    wt = alpha * trans
    diff = trans - sunv
    sums = torch.stack([(diff ** 2).sum(), (1 - (wt * sunv).sum(1)).sum()])
    g_pre = (lam3 / n_r * (-2 * diff - wt) * sunv * (1 - sunv)).reshape(-1)
    dwn, dbn = torch.zeros(9, h.shape[1]), torch.zeros(9)
    dwn[4, :fh], dbn[4] = rnd(g_pre) @ sf, g_pre.sum()
    return {"sums": sums, "d_s2": rnd(g_pre)[:, None] * w[4, :fh][None, :],
            "dwn": dwn, "dbn": dbn}, trans


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_noise", [False, True])
def test_sc_adjoint_formulas_match_autograd(dtype, with_noise):
    """Rays whose opacity saturates early (sigma row scaled by 40), so the
    transparency reaches its 1e-10-a-step floor, and with noise of spread 2
    samples whose sigma + noise is negative. 1e-5 of each tensor's largest
    entry: float32 arithmetic in another order."""
    g = torch.Generator().manual_seed(2)
    n_r, n_s, feat = 9, 12, 32
    p, fh = n_r * n_s, feat // 2

    def mk(*shape):
        return (torch.rand(*shape, generator=g) * 2 - 1).to(dtype)

    h, s2 = mk(p, feat), mk(p, fh)
    wn = mk(9, feat) * 0.8
    wn[0] *= 40
    bn = torch.randn(9, generator=g) * 0.3
    z = torch.sort(torch.rand(n_r, n_s, generator=g) * 3, 1)[0]
    noise = torch.randn(n_r, n_s, generator=g) * 2 if with_noise else None
    ref = FM.sc_loss_bwd_reference(h, s2, wn, bn, z, noise, 0.05)
    got, trans = _manual_sc_loss_bwd(h, s2, wn, bn, z, noise, 0.05)
    assert (trans[:, -1] < 1e-9).any()  # a saturated ray is present
    assert ref["dwn"][[0, 1, 2, 3, 5, 6, 7, 8]].abs().max() == 0
    for k, v in ref.items():
        assert torch.isfinite(got[k]).all(), k
        scale = v.abs().max().clamp_min(1e-20)
        assert float((got[k] - v).abs().max() / scale) <= 1e-5, k


# (rays, samples a ray, features, with the Pallas oracle): past one chunk of
# the card kernel's block (256 samples a ray), and a width whose sun_v hidden
# layer (Fh = 24) is no multiple of 32 lanes or of a 16-byte chunk (8 bf16)
EDGE_CASES = {"S320": (4, 320, 32, False), "F48": (8, 8, 48, True)}


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_k3_matches_jax_at_the_kernels_edges(case, staged):
    """As test_k3_matches_jax, with sigma noise, at the shapes where the card
    kernel changes its path: 320 samples a ray (two chunks of its scan) and
    FEAT 48."""
    n_rays, n_s, feat, with_kernel = EDGE_CASES[case]
    m, params = _jax_params("sat-nerf", feat=feat)
    inp = _inputs(n_rays, True, n_s=n_s)
    port = _port(_port_field("sat-nerf", params, feat), inp, "sat-nerf", staged,
                 feat=feat)
    _hold(port, _xla_oracle(m, params, inp, "sat-nerf"), "sat-nerf", RTOL_XLA,
          "vs XLA path")
    if with_kernel and not staged:
        _hold(port, _kernel_oracle(params, inp, "sat-nerf", feat), "sat-nerf",
              RTOL_KERNEL, "vs Pallas kernel")


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "satnerf_tpu_torch", "csrc")


def _c_sc_smem_floats():
    """csrc/fused_aux.cu sc_smem_floats as a Python function, read from the
    source: its return expression with C's integer division as //, and the
    constants it names from csrc/common.cuh and csrc/fused_aux.cu."""
    with open(os.path.join(CSRC, "fused_aux.cu")) as f:
        aux = f.read()
    with open(os.path.join(CSRC, "common.cuh")) as f:
        common = f.read()
    expr = re.search(r"constexpr int sc_smem_floats\(int F, int Fh, int S\) \{\s*"
                     r"return (.*?);\s*\}", aux, re.S).group(1)
    assert re.search(r"block_scratch_floats\(int M\) \{ return SCAN_WARPS \* M; \}",
                     common)
    assert "constexpr int SCAN_WARPS = SCAN_THREADS / 32;" in common
    assert "constexpr int SC_WARPS = SCAN_WARPS;" in aux
    warps = int(re.search(r"constexpr int SCAN_THREADS = (\d+);", common).group(1)) // 32
    consts = {"SCAN_WARPS": warps, "SC_WARPS": warps,
              "SC_SUMS": int(re.search(r"constexpr int SC_SUMS = (\d+);", aux).group(1))}
    expr = " ".join(expr.split()).replace("/", "//").replace(
        "block_scratch_floats(SC_SUMS)", "SCAN_WARPS * SC_SUMS")
    return lambda feat, fh, n_s: eval(expr, dict(consts, F=feat, Fh=fh, S=n_s))


@pytest.mark.parametrize("feat,fh,want", [
    (512, 256, 18416),  # the main path's 8 x 512 field
    (256, 128, 18885),  # --fc_units 256
    (96, 48, 19178),    # the capability presets' width
    (48, 24, 19266)])
def test_sc_sample_limit_is_the_c_formula(feat, fh, want):
    """sc_max_samples: the largest S whose shared memory, by the C entry's
    own formula read from the source, fits the 227 KB a block may hold; S
    fits, S + 1 does not, and the Python mirror gives the same bytes at every
    S (three floats a sample)."""
    floats = _c_sc_smem_floats()
    limit = FM.sc_max_samples(feat, fh)
    assert limit == want
    assert 4 * floats(feat, fh, limit) <= FM.SMEM_OPTIN_BYTES
    assert 4 * floats(feat, fh, limit + 1) > FM.SMEM_OPTIN_BYTES
    for n_s in (1, 64, 256, 257, 320, limit):
        assert FM._sc_smem_bytes(feat, fh, n_s) == 4 * floats(feat, fh, n_s)
    assert FM._sc_smem_bytes(feat, fh, 65) - FM._sc_smem_bytes(feat, fh, 64) == 12


def test_sc_refusal_names_the_limit():
    """Past the limit the wrapper raises before any launch, naming the 227
    KB and the largest S."""
    limit = FM.sc_max_samples(512, 256)
    FM._check_sc_samples(512, 256, limit)
    with pytest.raises(ValueError, match=rf"227 KB.*at most {limit} at F=512, Fh=256"):
        FM._check_sc_samples(512, 256, limit + 1)


def test_wrappers_raise_instead_of_falling_back():
    field = build_model("sat-nerf", LAYERS, F, t_dim=TAU)
    o, sun, t, z, _ = (None if a is None else torch.from_numpy(a)
                       for a in _inputs(4, False))
    with pytest.raises(ValueError):  # field / arguments mismatch
        FM.fused_sc_loss_grads(field, o, sun, t, z, None, LAM, layers=8,
                               feat=F, tau=TAU, dtype=torch.float32)
    meta = torch.zeros(4, S, device="meta")
    with pytest.raises(ValueError):
        FM.fused_sc_loss_grads(field, o, sun, t, meta, None, LAM,
                               layers=LAYERS, feat=F, tau=TAU)
