"""The port's hierarchical render_rays (coarse pass, resampling, fine pass,
and the sun-ray pass of each) against the JAX package's, float32 on the CPU.

Both sides get the same weights (through params_from_jax) and the same
draws: the JAX renderer draws from a 6-way split of its key (render.py:99),
the test repeats those draws from the same keys and injects them into the
port (z_vals, noise, u, fine_noise, sc_noise, sc_noise_fine). The JAX models
are the flax modules; the port's are, in turn, its field modules, the
point-mode callable over fused_field_apply and the ray-mode callable over
fused_field_apply_rays (on the CPU both run their plain versions).

Tolerance 1e-5 on every output: float32 arithmetic in another order; the
resampled depths themselves agree to 1e-6 (tests/test_torch_sampling.py) and
the field is smooth in them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import build_model as jax_build_model
from satnerf_tpu.render.render import RenderConfig as JaxRenderConfig
from satnerf_tpu.render.render import render_rays as jax_render_rays
from satnerf_tpu.render.sampling import stratified_zvals as jax_zvals
from satnerf_tpu_torch.models.nerf import build_model
from satnerf_tpu_torch.ops.fused_mlp import (fused_field_apply,
                                             fused_field_apply_rays)
from satnerf_tpu_torch.render.render import RenderConfig, render_rays
from satnerf_tpu_torch.train.checkpoints import params_from_jax

torch.set_num_threads(1)

R, S, N_IMP, LAYERS, F, TAU = 13, 8, 4, 6, 32, 4
ATOL = 1e-5


def jax_render_draws(key, rays, n_s, n_imp, noise_std):
    """The draws satnerf_tpu.render.render_rays makes from `key` for `rays`
    at perturb 1, as numpy arrays keyed like the port's keyword arguments."""
    ks = jax.random.split(key, 6)
    b = jnp.asarray(rays)
    n = rays.shape[0]

    def normal(k, s):
        if noise_std is None:
            return None
        return np.asarray(noise_std * jax.random.normal(k, (n, s), jnp.float32))

    return dict(
        z_vals=np.asarray(jax_zvals(ks[0], b[:, 6:7], b[:, 7:8], n_s, 1.0,
                                    False)),
        noise=normal(ks[1], n_s),
        u=np.asarray(jax.random.uniform(ks[2], (n, n_imp), jnp.float32)),
        fine_noise=normal(ks[3], n_s + n_imp),
        sc_noise=normal(ks[4], n_s),
        sc_noise_fine=normal(ks[5], n_s + n_imp))


def _models(variant):
    m = jax_build_model(variant, LAYERS, F)
    kw = (dict(view_dir=jnp.zeros((2, 3))) if variant == "nerf" else
          dict(sun_dir=jnp.zeros((2, 3)), t_embed=jnp.zeros((2, TAU))))
    params, fields = {}, {}
    for i, name in enumerate(("coarse", "fine")):
        params[name] = jax.device_get(
            m.init(jax.random.PRNGKey(i), jnp.zeros((2, 3)), **kw)["params"])
        field = build_model(variant, LAYERS, F, t_dim=TAU)
        sd = params_from_jax({"coarse": params[name]}, variant, LAYERS)
        field.load_state_dict({k[len("nerf_coarse."):]: v
                               for k, v in sd.items()})
        fields[name] = field
    return m, params, fields


def _as_mode(fields, mode, variant):
    kw = dict(layers=LAYERS, feat=F, skip=4, use_beta=variant == "sat-nerf",
              tau=TAU, dtype=torch.float32)

    def wrap(field):
        if mode == "module":
            return field
        if mode == "points":
            return lambda xyz, view_dir, sun_dir, t_embed: fused_field_apply(
                field, xyz, sun_dir, t_embed, **kw)

        def apply_rays(rays_o, march_d, sun_d, t_embed, z_vals):
            return fused_field_apply_rays(field, rays_o, march_d, sun_d,
                                          t_embed, z_vals, **kw)

        apply_rays.ray_mode = True
        return apply_rays

    return {k: wrap(f) for k, f in fields.items()}


def _rays(seed=5):
    rng = np.random.RandomState(seed)
    rays = rng.rand(R, 11).astype(np.float32) - 0.5
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 8:11] /= np.linalg.norm(rays[:, 8:11], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.1, 1.6
    return rays, rng.randn(R, TAU).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mode", ["module", "points", "rays"])
@pytest.mark.parametrize("variant,sc,noise_std", [
    ("sat-nerf", True, 0.5), ("sat-nerf", False, None), ("s-nerf", True, None)])
def test_hierarchical_train_render_matches_jax(variant, sc, noise_std, mode):
    m, params, fields = _models(variant)
    rays, t_e = _rays()
    t_e = t_e if variant == "sat-nerf" else None
    key = jax.random.PRNGKey(7)
    ref = jax_render_rays(
        {"coarse": m, "fine": m}, params, jnp.asarray(rays),
        None if t_e is None else jnp.asarray(t_e), key,
        JaxRenderConfig(variant=variant, n_samples=S, n_importance=N_IMP,
                        perturb=1.0, solar_correction=sc),
        noise_std=noise_std)
    d = jax_render_draws(key, rays, S, N_IMP, noise_std)
    cfg = RenderConfig(variant=variant, n_samples=S, n_importance=N_IMP,
                       perturb=1.0, solar_correction=sc)
    with torch.no_grad():
        got = render_rays(
            _as_mode(fields, mode, variant), torch.from_numpy(rays), _t(t_e),
            cfg, dtype=torch.float32, noise=_t(d["noise"]),
            sc_noise=_t(d["sc_noise"]) if sc else None,
            z_vals=_t(d["z_vals"]), u=_t(d["u"]),
            fine_noise=_t(d["fine_noise"]),
            sc_noise_fine=_t(d["sc_noise_fine"]) if sc else None)
    assert set(got) == set(ref)
    assert got["weights_fine"].shape == (R, S + N_IMP)
    assert ("sun_sc_fine" in got) == sc
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("variant", ["nerf", "sat-nerf"])
def test_hierarchical_eval_render_matches_jax(variant):
    """perturb 0: the stratified depths are the linspace and the resampling
    uses its linspace of u; nothing is drawn."""
    m, params, fields = _models(variant)
    rays, t_e = _rays(6)
    t_e = t_e if variant == "sat-nerf" else None
    ref = jax_render_rays(
        {"coarse": m, "fine": m}, params, jnp.asarray(rays),
        None if t_e is None else jnp.asarray(t_e), jax.random.PRNGKey(1),
        JaxRenderConfig(variant=variant, n_samples=S, n_importance=N_IMP,
                        perturb=0.0))
    with torch.inference_mode():  # no key: a draw would have none to use
        got = render_rays(fields, torch.from_numpy(rays), _t(t_e),
                          RenderConfig(variant=variant, n_samples=S,
                                       n_importance=N_IMP, perturb=0.0),
                          key=None, dtype=torch.float32)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)


def test_resampled_depths_carry_no_gradient():
    """The fine pass's depths are detached (rendering.py:128): the coarse
    model gets its gradient from its own outputs only."""
    _, _, fields = _models("s-nerf")
    rays, _ = _rays(8)
    cfg = RenderConfig(variant="s-nerf", n_samples=S, n_importance=N_IMP,
                       perturb=1.0)
    out = render_rays(fields, torch.from_numpy(rays), None, cfg,
                      key=np.asarray(jax.random.PRNGKey(1)),
                      dtype=torch.float32)
    grads = torch.autograd.grad(out["rgb_fine"].sum(),
                                list(fields["coarse"].parameters()),
                                allow_unused=True)
    assert all(g is None for g in grads)
    grads = torch.autograd.grad(out["depth_fine"].sum(),
                                list(fields["fine"].parameters()),
                                allow_unused=True)
    assert any(g is not None and float(g.abs().max()) > 0 for g in grads)
