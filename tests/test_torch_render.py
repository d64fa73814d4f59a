"""The port's sampling and compositing against satnerf_tpu.render, same
inputs made with numpy, f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.render.composite import composite as jax_composite
from satnerf_tpu.render.composite import ray_weights as jax_ray_weights
from satnerf_tpu.render.sampling import stratified_zvals as jax_zvals
from satnerf_tpu_torch.render.composite import composite, ray_weights
from satnerf_tpu_torch.render.sampling import stratified_zvals

torch.set_num_threads(1)

ATOL = 1e-6
R, S = 13, 16


def _near_far(seed=0):
    rng = np.random.RandomState(seed)
    near = rng.rand(R, 1).astype(np.float32) * 0.5 + 0.1
    far = near + rng.rand(R, 1).astype(np.float32) * 2 + 0.5
    return near, far


@pytest.mark.parametrize("use_disp", [False, True])
def test_stratified_eval_matches_jax(use_disp):
    near, far = _near_far()
    ref = jax_zvals(jax.random.PRNGKey(0), jnp.asarray(near), jnp.asarray(far),
                    S, perturb=0.0, use_disp=use_disp)
    out = stratified_zvals(None, torch.from_numpy(near), torch.from_numpy(far),
                           S, perturb=0.0, use_disp=use_disp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=1e-6)


def test_stratified_perturbed_stays_in_its_bins():
    near, far = _near_far(1)
    base = stratified_zvals(None, torch.from_numpy(near),
                            torch.from_numpy(far), S, perturb=0.0)
    z = stratified_zvals(torch.Generator().manual_seed(3),
                         torch.from_numpy(near), torch.from_numpy(far), S)
    again = stratified_zvals(torch.Generator().manual_seed(3),
                             torch.from_numpy(near), torch.from_numpy(far), S)
    assert torch.equal(z, again)
    mid = 0.5 * (base[:, :-1] + base[:, 1:])
    lower = torch.cat([base[:, :1], mid], -1)
    upper = torch.cat([mid, base[:, -1:]], -1)
    assert bool(((z >= lower - 1e-6) & (z <= upper + 1e-6)).all())
    assert bool((z[:, 1:] >= z[:, :-1]).all())
    assert not torch.equal(z, base)


def _field(seed, with_beta=True):
    rng = np.random.RandomState(seed)
    z = np.sort(rng.rand(R, S).astype(np.float32) * 3, -1)
    out = {
        "sigma": (rng.randn(R, S) * 3).astype(np.float32),
        "rgb": rng.rand(R, S, 3).astype(np.float32),
        "sun_v": rng.rand(R, S, 1).astype(np.float32),
        "sky_rgb": rng.rand(R, S, 3).astype(np.float32),
    }
    if with_beta:
        out["beta"] = rng.rand(R, S, 1).astype(np.float32)
    noise = rng.randn(R, S).astype(np.float32)
    return out, z, noise


@pytest.mark.parametrize("with_noise", [False, True])
def test_ray_weights_match_jax(with_noise):
    out, z, noise = _field(2)
    n = noise if with_noise else None
    ref = jax_ray_weights(jnp.asarray(out["sigma"]), jnp.asarray(z),
                          None if n is None else jnp.asarray(n))
    got = ray_weights(torch.from_numpy(out["sigma"]), torch.from_numpy(z),
                      None if n is None else torch.from_numpy(n))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("shadow,with_beta", [(True, True), (True, False),
                                              (False, False)])
def test_composite_matches_jax(shadow, with_beta):
    out, z, noise = _field(4, with_beta)
    ref = jax_composite({k: jnp.asarray(v) for k, v in out.items()},
                        jnp.asarray(z), noise=jnp.asarray(noise), shadow=shadow)
    got = composite({k: torch.from_numpy(v) for k, v in out.items()},
                    torch.from_numpy(z), noise=torch.from_numpy(noise),
                    shadow=shadow)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)
    if shadow:
        assert float(got["rgb"].min()) >= 0.0 and float(got["rgb"].max()) <= 1.0


@pytest.mark.parametrize("variant", ["nerf", "s-nerf", "sat-nerf"])
def test_render_rays_eval_matches_jax(variant):
    """The coarse pass at eval settings (perturb 0), same weights."""
    from satnerf_tpu.models import build_model as jax_build_model
    from satnerf_tpu.render.render import RenderConfig as JaxRenderConfig
    from satnerf_tpu.render.render import render_rays as jax_render_rays
    from satnerf_tpu_torch.models.nerf import build_model
    from satnerf_tpu_torch.render.render import RenderConfig, render_rays
    from satnerf_tpu_torch.train.checkpoints import params_from_jax

    m = jax_build_model(variant, 8, 32)
    kw = (dict(view_dir=jnp.zeros((2, 3))) if variant == "nerf" else
          dict(sun_dir=jnp.zeros((2, 3)), t_embed=jnp.zeros((2, 4))))
    params = jax.device_get(m.init(jax.random.PRNGKey(0), jnp.zeros((2, 3)),
                                   **kw)["params"])
    field = build_model(variant, 8, 32)
    sd = params_from_jax({"coarse": params}, variant, 8)
    field.load_state_dict({k[len("nerf_coarse."):]: v for k, v in sd.items()})

    rng = np.random.RandomState(5)
    rays = rng.rand(R, 11).astype(np.float32) - 0.5
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.1, 1.6
    t_e = rng.randn(R, 4).astype(np.float32) if variant == "sat-nerf" else None
    ref = jax_render_rays({"coarse": m}, {"coarse": params}, jnp.asarray(rays),
                          None if t_e is None else jnp.asarray(t_e),
                          jax.random.PRNGKey(1),
                          JaxRenderConfig(variant=variant, n_samples=S,
                                          perturb=0.0))
    with torch.inference_mode():
        got = render_rays({"coarse": field}, torch.from_numpy(rays),
                          None if t_e is None else torch.from_numpy(t_e),
                          RenderConfig(variant=variant, n_samples=S,
                                       perturb=0.0))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-5, err_msg=k)
