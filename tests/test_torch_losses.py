"""The port's losses and learning-rate schedules against the JAX package's:
the same numpy-seeded render results through both, values and gradients
(jax.grad against torch.autograd.grad), float32 on the CPU.

Tolerance 1e-6 absolute on the values and 1e-6 relative to each gradient's
largest entry: both sides do the same float32 arithmetic, in another order.
The schedules are compared at the steps around every epoch boundary, to
2e-6 relative (float32 jnp.power against Python floats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.train import losses as LJ
from satnerf_tpu.train.schedules import get_schedule as jax_get_schedule
from satnerf_tpu_torch.train import losses as LT
from satnerf_tpu_torch.train.schedules import get_schedule

torch.set_num_threads(1)

N, S = 24, 8


def _results(seed=0, fine=False, beta_ray=False):
    rng = np.random.RandomState(seed)
    res = {}
    for typ in ("coarse", "fine") if fine else ("coarse",):
        w = rng.rand(N, S).astype(np.float32)
        res[f"rgb_{typ}"] = rng.rand(N, 3).astype(np.float32)
        res[f"depth_{typ}"] = rng.rand(N).astype(np.float32) * 3
        res[f"weights_{typ}"] = w / w.sum(1, keepdims=True)
        res[f"beta_{typ}"] = rng.rand(N, S, 1).astype(np.float32)
        if beta_ray:
            res[f"beta_ray_{typ}"] = rng.rand(N, 1).astype(np.float32)
        res[f"sun_sc_{typ}"] = rng.rand(N, S, 1).astype(np.float32)
        res[f"transparency_sc_{typ}"] = rng.rand(N, S).astype(np.float32)
        res[f"weights_sc_{typ}"] = rng.rand(N, S).astype(np.float32) / S
    targets = rng.rand(N, 3).astype(np.float32)
    depths = rng.rand(N).astype(np.float32) * 3
    kp_w = rng.rand(N).astype(np.float32)
    return res, targets, depths, kp_w


def _both(jax_fn, torch_fn, res):
    """(value, grads) of a loss of the results dict, on both sides."""
    vj, gj = jax.value_and_grad(lambda r: jax_fn(r))(
        {k: jnp.asarray(v) for k, v in res.items()})
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in res.items()}
    vt = torch_fn(leaves)
    gt = torch.autograd.grad(vt, list(leaves.values()), allow_unused=True)
    gt = {k: (np.zeros_like(res[k]) if g is None else g.numpy())
          for k, g in zip(leaves, gt)}
    return float(vj), {k: np.asarray(v) for k, v in gj.items()}, float(vt.detach()), gt


def _hold(vj, gj, vt, gt):
    np.testing.assert_allclose(vt, vj, atol=1e-6)
    assert set(gj) == set(gt)
    for k in gj:
        scale = max(np.abs(gj[k]).max(), 1e-12)
        np.testing.assert_allclose(gt[k] / scale, gj[k] / scale, atol=1e-6,
                                   err_msg=k)


CASES = {
    "nerf": (lambda L, t, d, w: (lambda r: L.nerf_loss(r, t)[0]), False, False),
    "nerf_fine": (lambda L, t, d, w: (lambda r: L.nerf_loss(r, t)[0]), True, False),
    "snerf": (lambda L, t, d, w: (lambda r: L.snerf_loss(r, t, 0.05)[0]), False, False),
    "snerf_no_sc": (lambda L, t, d, w: (lambda r: L.snerf_loss(r, t, 0.0)[0]), False, False),
    "satnerf": (lambda L, t, d, w: (lambda r: L.satnerf_loss(r, t, 0.0)[0]), False, False),
    "satnerf_sc_fine": (lambda L, t, d, w: (lambda r: L.satnerf_loss(r, t, 0.05)[0]), True, False),
    "satnerf_beta_ray": (lambda L, t, d, w: (lambda r: L.satnerf_loss(r, t, 0.0)[0]), False, True),
    "depth_weighted": (lambda L, t, d, w: (lambda r: L.depth_loss(r, d, w, 1000.0)[0]), True, False),
    "depth_noweights": (lambda L, t, d, w: (lambda r: L.depth_loss(r, d, 1.0, 100.0)[0]), False, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_jax(name):
    make, fine, beta_ray = CASES[name]
    res, targets, depths, kp_w = _results(3, fine, beta_ray)
    jax_fn = make(LJ, jnp.asarray(targets), jnp.asarray(depths), jnp.asarray(kp_w))
    torch_fn = make(LT, torch.tensor(targets), torch.tensor(depths),
                    torch.tensor(kp_w))
    _hold(*_both(jax_fn, torch_fn, res))


def test_loss_dict_keys_and_factory_match_jax():
    res, targets, _, _ = _results(5, fine=True)
    for variant in ("nerf", "s-nerf", "sat-nerf"):
        lj, dj = LJ.load_loss(variant, 0.05)(
            {k: jnp.asarray(v) for k, v in res.items()}, jnp.asarray(targets))
        lt, dt = LT.load_loss(variant, 0.05)(
            {k: torch.tensor(v) for k, v in res.items()}, torch.tensor(targets))
        assert list(dj) == list(dt), variant
        np.testing.assert_allclose(float(lt), float(lj), atol=1e-6)
    with pytest.raises(ValueError):
        LT.load_loss("mip-nerf")
    assert LT.BETA_MIN == LJ.BETA_MIN == 0.05


def test_solar_correction_terms_detach_transparency_and_weights():
    res, _, _, _ = _results(7)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in res.items()}
    t2, t3 = LT.solar_correction_terms(leaves, "coarse", 0.05)
    g = torch.autograd.grad(t2 + t3, [leaves["transparency_sc_coarse"],
                                      leaves["weights_sc_coarse"],
                                      leaves["sun_sc_coarse"]],
                            allow_unused=True)
    assert g[0] is None and g[1] is None and g[2] is not None


@pytest.mark.parametrize("name", ["step", "cosine", "exponential", "multistep"])
def test_schedule_matches_jax_around_epoch_boundaries(name):
    lr, num_epochs, spe = 5e-4, 10, 7
    sj = jax_get_schedule(name, lr, num_epochs, spe)
    st = get_schedule(name, lr, num_epochs, spe)
    steps = sorted({s for e in range(0, 13) for s in (e * spe - 1, e * spe, e * spe + 1)
                    if s >= 0})
    for s in steps:
        np.testing.assert_allclose(st(s), float(sj(jnp.asarray(s, jnp.int32))),
                                   rtol=2e-6, atol=1e-12, err_msg=f"step {s}")
    with pytest.raises(ValueError):
        get_schedule("linear", lr, num_epochs, spe)
