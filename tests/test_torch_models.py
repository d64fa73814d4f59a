"""The port's RadianceField against the flax module: same weights (through
the weight bridge and through export_torch_state_dict), same inputs, f32 on
the CPU. Exact sin on both sides, so only summation order differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import build_model as jax_build_model
from satnerf_tpu.train.checkpoints import export_torch_state_dict
from satnerf_tpu_torch.models.nerf import build_model
from satnerf_tpu_torch.train.checkpoints import params_from_jax

torch.set_num_threads(1)

L, F, N, TAU = 8, 32, 48, 4
ATOL = 2e-5


def _jax_setup(variant, seed=0):
    m = jax_build_model(variant, L, F)
    kw = dict(sun_dir=jnp.zeros((2, 3)), t_embed=jnp.zeros((2, TAU)))
    if variant == "nerf":
        kw = dict(view_dir=jnp.zeros((2, 3)))
    params = m.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)), **kw)["params"]
    return m, jax.device_get(params)


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    xyz = rng.randn(N, 3).astype(np.float32) * 0.3
    d = rng.randn(N, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = rng.randn(N, 3).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    t = rng.randn(N, TAU).astype(np.float32)
    return xyz, d, sun, t


def _compare(variant, field, m, params):
    xyz, d, sun, t = _inputs()
    use_beta = variant == "sat-nerf"
    if variant == "nerf":
        ref = m.apply({"params": params}, xyz, view_dir=d)
        out = field(torch.from_numpy(xyz), view_dir=torch.from_numpy(d))
    else:
        ref = m.apply({"params": params}, xyz, sun_dir=sun,
                      t_embed=t if use_beta else None)
        out = field(torch.from_numpy(xyz), sun_dir=torch.from_numpy(sun),
                    t_embed=torch.from_numpy(t) if use_beta else None)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("variant", ["nerf", "s-nerf", "sat-nerf"])
def test_forward_matches_flax_via_bridge(variant):
    m, params = _jax_setup(variant)
    field = build_model(variant, L, F, t_dim=TAU)
    sd = params_from_jax({"coarse": params}, variant, L)
    field.load_state_dict({k[len("nerf_coarse."):]: v for k, v in sd.items()})
    _compare(variant, field, m, params)


@pytest.mark.parametrize("variant", ["nerf", "s-nerf", "sat-nerf"])
def test_forward_matches_flax_via_export(variant):
    m, params = _jax_setup(variant, seed=3)
    field = build_model(variant, L, F, t_dim=TAU)
    sd = export_torch_state_dict({"coarse": params}, variant, L)["state_dict"]
    field.load_state_dict({k[len("nerf_coarse."):]: torch.from_numpy(v)
                           for k, v in sd.items()})
    _compare(variant, field, m, params)


def test_bridge_matches_export_and_embedding():
    _, params = _jax_setup("sat-nerf")
    table = np.random.RandomState(0).randn(30, TAU).astype(np.float32)
    full = {"coarse": params, "t": {"embedding": table}}
    ours = params_from_jax(full, "sat-nerf", L)
    theirs = export_torch_state_dict(full, "sat-nerf", L)["state_dict"]
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])


@pytest.mark.parametrize("variant", ["nerf", "s-nerf", "sat-nerf"])
def test_state_dict_names_and_init_bounds(variant):
    """Keys are the reference torch names and every init draw lies inside
    the bound satnerf_tpu/models/nerf.py:38-61 uses."""
    field = build_model(variant, L, F, t_dim=TAU,
                        generator=torch.Generator().manual_seed(0))
    m, params = _jax_setup(variant)
    expected = export_torch_state_dict({"coarse": params}, variant, L)
    names = {k[len("nerf_coarse."):] for k in expected["state_dict"]}
    sd = field.state_dict()
    assert set(sd) == names
    for k, v in sd.items():
        fan_in = sd[k.replace(".bias", ".weight")].shape[1]
        if k == "fc_net.0.weight" and variant != "nerf":
            bound = 1.0 / fan_in
        elif k == "sun_v_net.0.weight" and variant != "nerf":
            bound = 1.0 / fan_in
        elif k.endswith(".weight") and variant != "nerf" and (
                k.startswith("fc_net.") or k in ("sun_v_net.2.weight",
                                                 "sun_v_net.4.weight")):
            bound = np.sqrt(6.0 / fan_in)
        else:
            bound = 1.0 / np.sqrt(fan_in)
        assert float(v.abs().max()) <= bound + 1e-7, k
        # a uniform draw fills most of its interval
        assert float(v.abs().max()) > 0.5 * bound or v.numel() < 4, k


def test_init_is_seeded():
    a = build_model("sat-nerf", L, F, generator=torch.Generator().manual_seed(7))
    b = build_model("sat-nerf", L, F, generator=torch.Generator().manual_seed(7))
    c = build_model("sat-nerf", L, F, generator=torch.Generator().manual_seed(8))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.fc_net[0].weight, c.fc_net[0].weight)
