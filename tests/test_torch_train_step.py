"""The port's train_step against the JAX step, from the same weights, Adam
state and draws, float32 on the CPU.

The port runs in rays mode (`fused="rays"`: the per-ray kernels' plain
versions on the CPU). JAX side: `_loss_and_metrics` of the XLA path
(`--fused off`) under jax.value_and_grad, then `system.tx.update` and `optax.apply_updates`, the
body of `local_step`. Two JAX steps are taken first, so that the Adam state
the port starts from (train/checkpoints.adam_from_jax) is not empty. Then
six steps on both sides, with the batch indices and the stratified depths
injected: with 3 steps an epoch they cross the beta switch-on (the 1-based
counter puts it at step 2), an epoch boundary with its learning-rate drop
(step 3) and a second one (step 6).

A second trajectory runs the full recipe, solar correction and depth
supervision on (sc_lambda 0.1, ds_lambda 1000, a depth set of its own with
injected draws): its six steps cross the step where the depth term drops out
(ds_drop_step 5: active while step + 1 < 5) and the beta switch-on (epoch 2,
at step 5 by the 1-based counter).

Tolerances: losses 2e-5; parameters 2e-5 absolute after each step. Adam
divides the gradient by its running magnitude, so a gradient entry near
zero can move its parameter by up to lr (1e-3) either way on a sign flip;
none of the entries here does, and 2e-5 is 2 % of one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from satnerf_tpu.config import Config as JaxConfig
from satnerf_tpu.render.sampling import stratified_zvals as jax_zvals
from satnerf_tpu.train.system import NeRFSystem as JaxSystem
from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.train.checkpoints import adam_from_jax, params_from_jax
from satnerf_tpu_torch.train.system import NeRFSystem, TrainState
from satnerf_tpu_torch.utils import jax_prng

torch.set_num_threads(1)

B, N_DATA, LAYERS = 32, 96, 4
KW = dict(batch_size=B, fc_units=32, fc_layers=LAYERS, n_samples=8,
          max_train_steps=30, first_beta_epoch=1, lr=1e-3, noise_std=0.0)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    rays = rng.rand(N_DATA, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    rgbs = rng.rand(N_DATA, 3).astype(np.float32)
    ts = rng.randint(0, 5, N_DATA).astype(np.int32)
    return rays, rgbs, ts


def _draws(step, rays):
    """Batch indices from numpy; depths as the JAX render draws them from
    its key (render.py:99: the first of a 6-way split of k_render)."""
    idx = np.random.RandomState(100 + step).randint(0, N_DATA, B)
    key = jax.random.PRNGKey(1000 + step)
    k_render, _ = jax.random.split(key)
    k_z = jax.random.split(k_render, 6)[0]
    b = jnp.asarray(rays[idx])
    z = jax_zvals(k_z, b[:, 6:7], b[:, 7:8], KW["n_samples"], 1.0, False)
    return idx, key, np.array(z)


def _make_jax_step(system):
    use_ts = system.use_ts

    @jax.jit
    def value_and_grad(params, rays, rgbs, ts, key, step, depth):
        def loss_fn(p):
            return system._loss_and_metrics(p, rays, rgbs,
                                            ts if use_ts else None, key, step,
                                            *depth)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    def step_fn(params, opt_state, step, data, idx, key, depth=()):
        rays, rgbs, ts = (jnp.asarray(a[idx]) for a in data)
        (loss, metrics), grads = value_and_grad(
            params, rays, rgbs, ts, key, jnp.asarray(step, jnp.int32),
            tuple(jnp.asarray(a) for a in depth))
        updates, opt_state = system.tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, float(loss),
                metrics)

    return step_fn


@pytest.mark.parametrize("variant", ["sat-nerf", "s-nerf"])
def test_trajectory_matches_jax_step(eight_devices, variant):
    data = _data()
    sys_j = JaxSystem(JaxConfig(model=variant, fused="off", **KW),
                      dataset_len=N_DATA)
    sys_t = NeRFSystem(Config(model=variant, fused="rays", **KW), device="cpu",
                       dataset_len=N_DATA)
    assert sys_j.spe == sys_t.spe == 3 and sys_t.fused_mode == "rays"
    params = sys_j.init_params(jax.random.PRNGKey(0))
    opt_state = sys_j.tx.init(params)
    _jax_step = _make_jax_step(sys_j)
    step = 0
    for _ in range(2):
        idx, key, _ = _draws(step, data[0])
        params, opt_state, _, _ = _jax_step(params, opt_state, step, data,
                                            idx, key)
        step += 1

    # the port takes over the weights and the Adam state
    state = sys_t.init_state(0)
    state.params.load_state_dict(
        params_from_jax(jax.device_get(params), variant, LAYERS))
    adam = opt_state[0]
    assert int(adam.count) == 2
    adam_from_jax(state.optimizer, state.params, jax.device_get(adam.mu),
                  jax.device_get(adam.nu), int(adam.count), variant, LAYERS)
    state.step = step
    t_data = {"rays": torch.from_numpy(data[0]),
              "rgbs": torch.from_numpy(data[1]),
              "ts": torch.from_numpy(data[2]).long()}

    gates, lrs = [], []
    for _ in range(6):
        idx, key, z = _draws(step, data[0])
        params, opt_state, loss_j, m_j = _jax_step(params, opt_state, step,
                                                   data, idx, key)
        m_t = sys_t.train_step(state, t_data, idx=torch.from_numpy(idx),
                               z_vals=torch.from_numpy(z))
        gates.append(sys_t.beta_gate(step))
        lrs.append(m_t["lr"])
        step += 1
        assert state.step == step
        np.testing.assert_allclose(float(m_t["loss"]), loss_j, atol=2e-5,
                                   err_msg=f"loss at step {step - 1}")
        np.testing.assert_allclose(float(m_t["psnr"]), float(m_j["psnr"]),
                                   atol=1e-3)
        np.testing.assert_allclose(m_t["lr"],
                                   float(sys_j.lr_schedule(step - 1)), rtol=1e-6)
        want = params_from_jax(jax.device_get(params), variant, LAYERS)
        got = state.params.state_dict()
        assert set(want) == set(got)
        for name, ref in want.items():
            np.testing.assert_allclose(
                got[name].numpy(), ref.numpy(), atol=2e-5,
                err_msg=f"{name} after step {step - 1}")
    # steps 2..7: the gate is already on at step 2 (1-based counter); the
    # learning rate drops when step // 3 grows
    if variant == "sat-nerf":
        assert gates == [1.0] * 6
        assert sys_t.beta_gate(1) == 0.0 and sys_t.beta_gate(2) == 1.0
    else:
        assert gates == [0.0] * 6
    np.testing.assert_allclose(
        lrs, [1e-3 * 0.9 ** e for e in (0, 1, 1, 1, 2, 2)], rtol=1e-9)


N_DEPTH = 40
KW_FULL = {**KW, "first_beta_epoch": 2, "sc_lambda": 0.1, "ds_lambda": 1000.0,
           "ds_drop": 5 / 30}


def _depth_data(rays, seed=3):
    """Key-point rays: a subset of the color rays with a target depth inside
    [near, far] and a weight in (0, 1]."""
    rng = np.random.RandomState(seed)
    d_rays = rays[rng.randint(0, N_DATA, N_DEPTH)].copy()
    d_depths = np.stack([rng.uniform(0.2, 0.8, N_DEPTH),
                         rng.uniform(0.3, 1.0, N_DEPTH)], -1).astype(np.float32)
    d_ts = rng.randint(0, 5, N_DEPTH).astype(np.int32)
    return d_rays, d_depths, d_ts


def _depth_draws(step, key, d_rays):
    """The depth batch's indices from numpy; its depths as the JAX render of
    the depth rays draws them (the first of a 6-way split of k_depth)."""
    d_idx = np.random.RandomState(300 + step).randint(0, N_DEPTH, B)
    _, k_depth = jax.random.split(key)
    k_z = jax.random.split(k_depth, 6)[0]
    b = jnp.asarray(d_rays[d_idx])
    z = jax_zvals(k_z, b[:, 6:7], b[:, 7:8], KW["n_samples"], 1.0, False)
    return d_idx, np.array(z)


@pytest.mark.parametrize("variant", ["sat-nerf", "s-nerf"])
def test_full_recipe_trajectory_matches_jax_step(eight_devices, variant):
    data = _data()
    depth = _depth_data(data[0])
    sys_j = JaxSystem(JaxConfig(model=variant, fused="off", **KW_FULL),
                      dataset_len=N_DATA, depth_dataset_len=N_DEPTH)
    sys_t = NeRFSystem(Config(model=variant, fused="rays", **KW_FULL),
                       device="cpu", dataset_len=N_DATA)
    assert sys_j.ds_drop_step == sys_t.ds_drop_step == 5
    assert sys_t.depth and sys_t.render_cfg.solar_correction
    params = sys_j.init_params(jax.random.PRNGKey(0))
    opt_state = sys_j.tx.init(params)
    _jax_step = _make_jax_step(sys_j)

    def jax_step(params, opt_state, step):
        idx, key, z = _draws(step, data[0])
        d_idx, d_z = _depth_draws(step, key, depth[0])
        out = _jax_step(params, opt_state, step, data, idx, key,
                        tuple(a[d_idx] for a in depth))
        return out, (idx, z, d_idx, d_z)

    step = 0
    for _ in range(2):
        (params, opt_state, _, _), _ = jax_step(params, opt_state, step)
        step += 1

    state = sys_t.init_state(0)
    state.params.load_state_dict(
        params_from_jax(jax.device_get(params), variant, LAYERS))
    adam = opt_state[0]
    adam_from_jax(state.optimizer, state.params, jax.device_get(adam.mu),
                  jax.device_get(adam.nu), int(adam.count), variant, LAYERS)
    state.step = step
    t_data = {"rays": torch.from_numpy(data[0]),
              "rgbs": torch.from_numpy(data[1]),
              "ts": torch.from_numpy(data[2]).long(),
              "d_rays": torch.from_numpy(depth[0]),
              "d_depths": torch.from_numpy(depth[1]),
              "d_ts": torch.from_numpy(depth[2]).long()}

    totals = []
    for _ in range(6):
        (params, opt_state, loss_j, m_j), (idx, z, d_idx, d_z) = jax_step(
            params, opt_state, step)
        m_t = sys_t.train_step(
            state, t_data, idx=torch.from_numpy(idx), z_vals=torch.from_numpy(z),
            d_idx=torch.from_numpy(d_idx), d_z_vals=torch.from_numpy(d_z))
        step += 1
        # "loss" is the loss with SC and before DS; "loss_total" has both
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   atol=2e-5, err_msg=f"loss at {step - 1}")
        np.testing.assert_allclose(float(m_t["loss_depth"]),
                                   float(m_j["loss_depth"]), rtol=2e-5,
                                   err_msg=f"loss_depth at {step - 1}")
        np.testing.assert_allclose(float(m_t["loss_total"]), loss_j, rtol=2e-5,
                                   atol=2e-5)
        totals.append(float(m_t["loss_total"]) - float(m_t["loss"]))
        want = params_from_jax(jax.device_get(params), variant, LAYERS)
        got = state.params.state_dict()
        for name, ref in want.items():
            np.testing.assert_allclose(
                got[name].numpy(), ref.numpy(), atol=2e-5,
                err_msg=f"{name} after step {step - 1}")
    # steps 2..7: the depth term is in the total at steps 2 and 3 only
    assert all(t > 0 for t in totals[:2]) and totals[2:] == [0.0] * 4
    if variant == "sat-nerf":
        assert [sys_t.beta_gate(s) for s in range(2, 8)] == [0, 0, 0, 1, 1, 1]


def test_adam_state_round_trips_through_a_checkpoint(tmp_path):
    from satnerf_tpu_torch.train.checkpoints import (load_checkpoint,
                                                     save_checkpoint)

    data = _data(1)
    t_data = {"rays": torch.from_numpy(data[0]),
              "rgbs": torch.from_numpy(data[1]),
              "ts": torch.from_numpy(data[2]).long()}
    system = NeRFSystem(Config(model="sat-nerf", **KW), device="cpu",
                        dataset_len=N_DATA)
    a = system.init_state(3)
    for _ in range(3):
        system.train_step(a, t_data, jax_prng.prng_key(4))
    path = str(tmp_path / "epoch=1.ckpt")
    save_checkpoint(path, a.params, a.optimizer, a.step)

    b = system.init_state(99)
    b.step = load_checkpoint(path, b.params, b.optimizer)
    assert b.step == 3
    idx = torch.arange(B)
    z = torch.sort(torch.rand(B, 8, generator=torch.Generator().manual_seed(5)))[0]
    system.train_step(a, t_data, idx=idx, z_vals=z)
    system.train_step(b, t_data, idx=idx, z_vals=z)
    for (name, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        assert torch.equal(p, q), name

    # a serving checkpoint (no optimizer state) still loads, at step 0
    save_checkpoint(path, a.params)
    c = system.init_state(7)
    assert load_checkpoint(path, c.params, c.optimizer) == 0
    assert torch.equal(c.params["embedding_t"].weight,
                       a.params["embedding_t"].weight)


def test_train_step_draws_and_options():
    data = _data(2)
    t_data = {"rays": torch.from_numpy(data[0]),
              "rgbs": torch.from_numpy(data[1]),
              "ts": torch.from_numpy(data[2]).long()}
    cfg = Config(model="sat-nerf", **{**KW, "noise_std": 1.0})
    system = NeRFSystem(cfg, device="cpu", dataset_len=N_DATA)
    runs = []
    for _ in range(2):  # the same seeds give the same step
        state = system.init_state(0)
        m = system.train_step(state, t_data, jax_prng.prng_key(1))
        runs.append((float(m["loss"]), state.params["nerf_coarse"].fc_net[0]
                     .weight.detach().clone()))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    assert np.isfinite(runs[0][0])
    assert system._noise_std(0) == 1.0 and abs(system._noise_std(2) - 0.81) < 1e-12
    assert NeRFSystem(Config(model="sat-nerf", **KW), "cpu")._noise_std(5) is None

    # the nerf variant trains: its plain step with a fused mode on is K7's
    # plain version here, and it has no refusal left
    s = NeRFSystem(Config(**{**KW, "model": "nerf", "fused": "on"}),
                   device="cpu", dataset_len=N_DATA)
    state = s.init_state(0)
    m = s.train_step(state, t_data, jax_prng.prng_key(1))
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    assert set(m) == {"loss", "psnr", "loss_total", "lr"}
    assert not hasattr(s, "_check_supported")
    for kw in (dict(sc_lambda=0.05), dict(ds_lambda=1.0), dict(grad_accum=2),
               dict(sampling="shuffle"), dict(n_importance=8),
               dict(fused="on"), dict(fused="off")):  # every option constructs
        NeRFSystem(Config(**{**KW, **kw}), device="cpu", dataset_len=N_DATA)
    assert NeRFSystem(Config(device="cpu")).device.type == "cpu"
    assert NeRFSystem(Config()).device.type == "cuda"  # the card by default
    # --fused resolves as in the JAX system: auto is rays on the card, off on
    # the CPU; on is the point-mode field kernel; nerf has no rays mode: rays
    # and auto on the card resolve to points for it
    modes = {("auto", "cuda"): "rays", ("auto", "cpu"): "off",
             ("rays", "cpu"): "rays", ("on", "cuda"): "points",
             ("on", "cpu"): "points", ("off", "cuda"): "off"}
    for (fused, dev), mode in modes.items():
        assert NeRFSystem(Config(fused=fused), dev).fused_mode == mode
    nerf_modes = {("auto", "cuda"): "points", ("auto", "cpu"): "off",
                  ("rays", "cpu"): "points", ("rays", "cuda"): "points",
                  ("on", "cpu"): "points", ("off", "cuda"): "off"}
    for (fused, dev), mode in nerf_modes.items():
        assert NeRFSystem(Config(model="nerf", fused=fused),
                          dev).fused_mode == mode
