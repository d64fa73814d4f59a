"""The port's fused_render_rays against two JAX oracles, same weights and
inputs, f32 on the CPU:

  (a) the Pallas kernel fused_render_rays in interpret mode, at the bound the
      JAX tests hold it to (2e-4: its fast_sin errs up to 1.7e-5 a layer);
  (b) the flax field + render/composite.py, with the per-ray integrals
      sum_s w_s * q_s, at 2e-5 (exact sin on both sides).

On the CPU fused_render_rays is its plain version. The kernel chain's
staging (_render_staged: packed weights, the skip split, the per-ray sky,
the E operands) runs here with the plain stages, so its arithmetic is held
to the same oracles. The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from satnerf_tpu.models import build_model as jax_build_model
from satnerf_tpu.ops.pallas import fused_mlp as FMJ
from satnerf_tpu.render.composite import composite as jax_composite
from satnerf_tpu_torch.models.nerf import build_model
from satnerf_tpu_torch.ops import fused_mlp as FM
from satnerf_tpu_torch.train.checkpoints import params_from_jax

torch.set_num_threads(1)

L, F, S, TAU = 8, 32, 16, 4
ATOL_KERNEL = 2e-4
ATOL_FLAX = 2e-5
PRODUCTS = ("rgb", "depth", "sun", "sky", "albedo", "opacity", "beta")


def _params(variant, seed=0):
    m = jax_build_model(variant, L, F)
    params = m.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)),
                    sun_dir=jnp.zeros((2, 3)),
                    t_embed=jnp.zeros((2, TAU)))["params"]
    return m, jax.device_get(params)


def _rays(n_rays, seed=7):
    rng = np.random.RandomState(seed)
    o = rng.randn(n_rays, 3).astype(np.float32) * 0.2
    d = rng.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = rng.randn(n_rays, 3).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    t = rng.randn(n_rays, TAU).astype(np.float32)
    z = np.sort(rng.rand(n_rays, S).astype(np.float32) * 3, -1)
    return o, d, sun, t, z


def _port_field(variant, params):
    field = build_model(variant, L, F, t_dim=TAU)
    sd = params_from_jax({"coarse": params}, variant, L)
    field.load_state_dict({k[len("nerf_coarse."):]: v for k, v in sd.items()})
    return field


_ORACLES = {}


def _oracles(variant, n_rays):
    """JAX kernel (interpret mode) and flax+composite products, computed
    once per (variant, R)."""
    key = (variant, n_rays)
    if key not in _ORACLES:
        m, params = _params(variant)
        o, d, sun, t, z = _rays(n_rays)
        use_beta = variant == "sat-nerf"
        with pltpu.force_tpu_interpret_mode():
            kern = FMJ.fused_render_rays(
                params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(sun),
                jnp.asarray(t) if use_beta else None, jnp.asarray(z),
                layers=L, feat=F, use_beta=use_beta, tau=TAU,
                dtype=jnp.float32, return_weights=True)
        xyz = o[:, None, :] + d[:, None, :] * z[:, :, None]
        sun_s = np.broadcast_to(sun[:, None, :], (n_rays, S, 3))
        t_s = np.broadcast_to(t[:, None, :], (n_rays, S, TAU))
        field = m.apply({"params": params}, xyz, sun_dir=sun_s,
                        t_embed=t_s if use_beta else None)
        comp = jax_composite(field, jnp.asarray(z), shadow=True)
        w = np.asarray(comp["weights"])

        def integ(q):
            return (w[..., None] * np.asarray(q)).sum(-2)

        flax = {"rgb": comp["rgb"], "depth": comp["depth"],
                "sun": integ(comp["sun"]), "sky": integ(comp["sky"]),
                "albedo": integ(comp["albedo"]), "opacity": w.sum(-1),
                "weights": w}
        if use_beta:
            flax["beta"] = integ(comp["beta"])
        _ORACLES[key] = (params, (o, d, sun, t, z),
                         {k: np.asarray(v) for k, v in kern.items()},
                         {k: np.asarray(v) for k, v in flax.items()})
    return _ORACLES[key]


def _check(out, oracle, atol, return_weights, use_beta):
    keys = [k for k in PRODUCTS if use_beta or k != "beta"]
    assert set(out) == set(keys) | ({"weights"} if return_weights else set())
    for k in keys + (["weights"] if return_weights else []):
        got = out[k].detach().numpy()
        assert got.shape == oracle[k].shape, k
        np.testing.assert_allclose(got, oracle[k], atol=atol, err_msg=k)


@pytest.mark.parametrize("return_weights", [False, True])
@pytest.mark.parametrize("n_rays", [12, 11, 5])
@pytest.mark.parametrize("variant", ["sat-nerf", "s-nerf"])
def test_fused_render_rays_matches_jax(variant, n_rays, return_weights):
    params, (o, d, sun, t, z), kern, flax = _oracles(variant, n_rays)
    use_beta = variant == "sat-nerf"
    field = _port_field(variant, params)
    with torch.inference_mode():
        out = FM.fused_render_rays(
            field, *(torch.from_numpy(a) for a in (o, d, sun)),
            torch.from_numpy(t) if use_beta else None, torch.from_numpy(z),
            layers=L, feat=F, use_beta=use_beta, tau=TAU, dtype=torch.float32,
            return_weights=return_weights)
    _check(out, kern, ATOL_KERNEL, return_weights, use_beta)
    _check(out, flax, ATOL_FLAX, return_weights, use_beta)


@pytest.mark.parametrize("n_rays", [12, 5])
@pytest.mark.parametrize("variant", ["sat-nerf", "s-nerf"])
def test_kernel_staging_matches_jax(variant, n_rays):
    """The chain the CUDA path launches, run with the plain stages."""
    params, (o, d, sun, t, z), kern, flax = _oracles(variant, n_rays)
    use_beta = variant == "sat-nerf"
    field = _port_field(variant, params)
    with torch.inference_mode():
        rays16 = FM.pack_rays(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(sun),
                              torch.from_numpy(t) if use_beta else None, TAU)
        packed = FM.pack_params(field, skip=4, use_beta=use_beta,
                                dtype=torch.float32)
        out, w = FM._render_staged(packed, rays16, torch.from_numpy(z), skip=4,
                                   use_beta=use_beta, rgb_padding=0.001,
                                   return_weights=True)
    res = FM._products(out, w, use_beta)
    _check(res, kern, ATOL_KERNEL, True, use_beta)
    _check(res, flax, ATOL_FLAX, True, use_beta)
    assert float(out[:, 13:].abs().max()) == 0.0  # unused layout columns


def test_bf16_staging_matches_bf16_plain_version():
    """In bf16 the chain rounds every operand where the plain field does:
    on the CPU the two sum in the same order and agree to fp32 rounding."""
    _, params = _params("sat-nerf")
    o, d, sun, t, z = (torch.from_numpy(a) for a in _rays(9))
    field = _port_field("sat-nerf", params)
    with torch.inference_mode():
        ref = FM.fused_render_rays_reference(field, o, d, sun, t, z, layers=L,
                                             feat=F, tau=TAU,
                                             dtype=torch.bfloat16,
                                             return_weights=True)
        packed = FM.pack_params(field, skip=4, use_beta=True,
                                dtype=torch.bfloat16)
        out, w = FM._render_staged(packed, FM.pack_rays(o, d, sun, t, TAU), z,
                                   skip=4, use_beta=True, rgb_padding=0.001,
                                   return_weights=True)
    res = FM._products(out, w, True)
    for k in ref:
        np.testing.assert_allclose(res[k].numpy(), ref[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a GPU is refused, never
    rendered on a plain path."""
    _, params = _params("s-nerf")
    field = _port_field("s-nerf", params)
    o, d, sun, t, z = (torch.from_numpy(a).to("meta") for a in _rays(4))
    with pytest.raises(ValueError):
        FM.fused_render_rays(field, o, d, sun, None, z, layers=L, feat=F,
                             use_beta=False, tau=TAU)


def test_field_config_is_checked():
    _, params = _params("s-nerf")
    field = _port_field("s-nerf", params)
    o, d, sun, t, z = (torch.from_numpy(a) for a in _rays(4))
    with pytest.raises(ValueError):
        FM.fused_render_rays(field, o, d, sun, None, z, layers=L, feat=F,
                             use_beta=True, tau=TAU)
