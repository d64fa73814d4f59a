"""Hierarchical training (n_importance > 0) with solar correction and depth
supervision: the port's loss_and_grads and train_step against the JAX system,
the same weights, batches and draws, float32 on the CPU.

The port runs in each of its three modes: "rays" (the two-launch dispatch of
the per-ray kernels' plain versions, the sun-ray pass of each model, the depth
pass through the plain renderer over the ray-mode field), "points" (the plain
renderer over the point-mode field) and "off" (over the field modules). The
JAX side is

  (a) `_loss_and_metrics` of the XLA path (`--fused off`) under
      jax.value_and_grad: loss parts 2e-5, gradients 1e-4 of each tensor's
      largest entry;
  (b) `_fused_loss_and_grads` in rays mode and `_loss_and_metrics` with
      `--fused on`, their Pallas kernels in interpret mode: loss parts 5e-4,
      gradients 3e-3 of each tensor's largest entry, the tolerances
      tests/test_fused_train_render.py holds the JAX fused path to against
      its own XLA path (kernel rounding in the coarse weights shifts the
      resampled depths, which the SIREN field amplifies).

The draws are the ones the JAX renders make from their keys (render.py:99),
repeated here and injected into the port. Then a 6-step trajectory from
bridged weights and Adam state, across the beta switch-on and the step where
the depth term drops out: parameters 2e-5 after each step, as
tests/test_torch_train_step.py holds the main path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from satnerf_tpu.config import Config as JaxConfig
from satnerf_tpu.train.system import NeRFSystem as JaxSystem
from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.train.checkpoints import adam_from_jax, params_from_jax
from satnerf_tpu_torch.train.system import NeRFSystem
from tests.test_torch_render_hier import jax_render_draws

torch.set_num_threads(1)

B, N_DATA, N_DEPTH, LAYERS, S, N_IMP = 32, 96, 40, 4, 8, 4
KW = dict(batch_size=B, fc_units=32, fc_layers=LAYERS, n_samples=S,
          n_importance=N_IMP, max_train_steps=30, first_beta_epoch=2, lr=1e-3,
          sc_lambda=0.1, ds_lambda=1000.0, ds_drop=5 / 30)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    rays = rng.rand(N_DATA, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 8:11] /= np.linalg.norm(rays[:, 8:11], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    rgbs = rng.rand(N_DATA, 3).astype(np.float32)
    ts = rng.randint(0, 5, N_DATA).astype(np.int32)
    d_rays = rays[rng.randint(0, N_DATA, N_DEPTH)].copy()
    d_depths = np.stack([rng.uniform(0.2, 0.8, N_DEPTH),
                         rng.uniform(0.3, 1.0, N_DEPTH)], -1).astype(np.float32)
    d_ts = rng.randint(0, 5, N_DEPTH).astype(np.int32)
    return (rays, rgbs, ts), (d_rays, d_depths, d_ts)


def _batch(step, data, depth):
    """Indices from numpy; the key the JAX step splits into k_render and
    k_depth; the draws both renders make from them."""
    idx = np.random.RandomState(100 + step).randint(0, N_DATA, B)
    d_idx = np.random.RandomState(300 + step).randint(0, N_DEPTH, B)
    key = jax.random.PRNGKey(1000 + step)
    return idx, d_idx, key


def _port_draws(key, rays, d_rays, noise_std):
    k_render, k_depth = jax.random.split(key)
    d = jax_render_draws(k_render, rays, S, N_IMP, noise_std)
    dd = jax_render_draws(k_depth, d_rays, S, N_IMP, noise_std)
    kw = {k: v for k, v in d.items()}
    kw.update(d_z_vals=dd["z_vals"], d_noise=dd["noise"], d_u=dd["u"],
              d_fine_noise=dd["fine_noise"])
    return {k: (None if v is None else torch.from_numpy(np.array(v)))
            for k, v in kw.items()}


def _named(tree, variant):
    return {k: v.numpy() for k, v in params_from_jax(tree, variant,
                                                     LAYERS).items()}


def _jax_value_and_grad(system, kernel_path):
    use_ts = system.use_ts

    def run(params, rays, rgbs, ts, key, step, depth):
        ts = ts if use_ts else None
        if kernel_path == "rays":
            return system._fused_loss_and_grads(params, rays, rgbs, ts, key,
                                                step, *depth)

        def loss_fn(p):
            return system._loss_and_metrics(p, rays, rgbs, ts, key, step,
                                            *depth)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    if kernel_path == "off":
        return jax.jit(run)

    def interpreted(*args):
        with pltpu.force_tpu_interpret_mode():
            return run(*args)

    return interpreted


@pytest.fixture(scope="module")
def port_results():
    """loss_and_grads of the port in its three modes, per (variant, step,
    noise_std): computed once, held against each JAX path."""
    cache = {}

    def get(variant, step, noise_std, params_np):
        k = (variant, step, noise_std)
        if k in cache:
            return cache[k]
        data, depth = _data()
        idx, d_idx, key = _batch(step, data, depth)
        std = None if noise_std == 0 else noise_std * 0.9 ** step
        draws = _port_draws(key, data[0][idx], depth[0][d_idx], std)
        out = {}
        for mode, fused in (("rays", "rays"), ("points", "on"),
                            ("off", "off")):
            system = NeRFSystem(Config(model=variant, fused=fused,
                                       noise_std=noise_std, **KW),
                                device="cpu", dataset_len=N_DATA)
            assert system.fused_mode == mode
            params = system.init_params(0)
            params.load_state_dict(params_from_jax(params_np, variant, LAYERS))
            loss, metrics, grads = system.loss_and_grads(
                params, torch.from_numpy(data[0][idx]),
                torch.from_numpy(data[1][idx]),
                torch.from_numpy(data[2][idx]).long(), step,
                depth=(torch.from_numpy(depth[0][d_idx]),
                       torch.from_numpy(depth[1][d_idx]),
                       torch.from_numpy(depth[2][d_idx]).long()), **draws)
            out[mode] = (float(loss), {k: float(v) for k, v in metrics.items()},
                         {k: v.detach().numpy() for k, v in grads.items()})
        cache[k] = out
        return out

    return get


# JAX path, variant, step, noise_std. Step 2 of 3 a epoch: beta gate off,
# depth term on; step 20: gate on, depth term dropped.
GRAD_CASES = [("off", "sat-nerf", 2, 1.0), ("off", "sat-nerf", 20, 1.0),
              ("off", "s-nerf", 2, 0.0), ("rays", "sat-nerf", 2, 1.0),
              ("on", "sat-nerf", 2, 1.0)]


@pytest.mark.parametrize("jax_fused,variant,step,noise_std", GRAD_CASES)
def test_loss_and_grads_match_jax(eight_devices, port_results, jax_fused,
                                  variant, step, noise_std):
    data, depth = _data()
    sys_j = JaxSystem(JaxConfig(model=variant, fused=jax_fused,
                                noise_std=noise_std, **KW),
                      dataset_len=N_DATA, depth_dataset_len=N_DEPTH)
    assert sys_j.fused_mode == {"off": "off", "rays": "rays",
                                "on": "points"}[jax_fused]
    assert sys_j.spe == 3 and sys_j.ds_drop_step == 5
    params = sys_j.init_params(jax.random.PRNGKey(0))
    idx, d_idx, key = _batch(step, data, depth)
    (loss_j, m_j), g_j = _jax_value_and_grad(sys_j, jax_fused)(
        params, *(jnp.asarray(a[idx]) for a in data), key,
        jnp.asarray(step, jnp.int32),
        tuple(jnp.asarray(a[d_idx]) for a in depth))
    want = _named(jax.device_get(g_j), variant)
    a_loss, a_grad = (2e-5, 1e-4) if jax_fused == "off" else (5e-4, 3e-3)

    got = port_results(variant, step, noise_std, jax.device_get(params))
    for mode, (loss_t, m_t, grads) in got.items():
        tag = f"port {mode} vs JAX --fused {jax_fused}"
        np.testing.assert_allclose(loss_t, float(loss_j), atol=a_loss,
                                   rtol=a_loss, err_msg=tag)
        for k in ("loss", "loss_total", "loss_depth"):
            np.testing.assert_allclose(m_t[k], float(m_j[k]), atol=a_loss,
                                       rtol=a_loss, err_msg=f"{tag} {k}")
        np.testing.assert_allclose(m_t["psnr"], float(m_j["psnr"]), atol=5e-3,
                                   err_msg=tag)
        active = step + 1 < 5
        assert (m_t["loss_total"] - m_t["loss"] > 0) == active, tag
        assert set(grads) == set(want), tag
        assert any(k.startswith("nerf_fine.") for k in grads)
        for name, ref in want.items():
            scale = max(np.abs(ref).max(), 1e-12)
            np.testing.assert_allclose(grads[name] / scale, ref / scale,
                                       atol=a_grad, err_msg=f"{tag} {name}")


def _make_jax_step(system):
    value_and_grad = _jax_value_and_grad(system, "off")

    def step_fn(params, opt_state, step, data, depth):
        idx, d_idx, key = _batch(step, data, depth)
        (loss, metrics), grads = value_and_grad(
            params, *(jnp.asarray(a[idx]) for a in data), key,
            jnp.asarray(step, jnp.int32),
            tuple(jnp.asarray(a[d_idx]) for a in depth))
        updates, opt_state = system.tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, float(loss),
                metrics, (idx, d_idx, key))

    return step_fn


@pytest.mark.parametrize("fused", ["rays", "on"])
def test_hierarchical_trajectory_matches_jax_step(eight_devices, fused):
    variant = "sat-nerf"
    data, depth = _data()
    sys_j = JaxSystem(JaxConfig(model=variant, fused="off", noise_std=0.0,
                                **KW),
                      dataset_len=N_DATA, depth_dataset_len=N_DEPTH)
    sys_t = NeRFSystem(Config(model=variant, fused=fused, noise_std=0.0, **KW),
                       device="cpu", dataset_len=N_DATA)
    assert sys_t.ds_drop_step == 5 and sys_t.spe == 3
    params = sys_j.init_params(jax.random.PRNGKey(0))
    opt_state = sys_j.tx.init(params)
    jax_step = _make_jax_step(sys_j)
    step = 0
    for _ in range(2):
        params, opt_state, _, _, _ = jax_step(params, opt_state, step, data,
                                              depth)
        step += 1

    # the port takes over the weights and the Adam state, the fine model's too
    state = sys_t.init_state(0)
    state.params.load_state_dict(
        params_from_jax(jax.device_get(params), variant, LAYERS))
    adam = opt_state[0]
    adam_from_jax(state.optimizer, state.params, jax.device_get(adam.mu),
                  jax.device_get(adam.nu), int(adam.count), variant, LAYERS)
    assert any(n.startswith("nerf_fine.") for n, _ in
               state.params.named_parameters())
    state.step = step
    t_data = {"rays": torch.from_numpy(data[0]),
              "rgbs": torch.from_numpy(data[1]),
              "ts": torch.from_numpy(data[2]).long(),
              "d_rays": torch.from_numpy(depth[0]),
              "d_depths": torch.from_numpy(depth[1]),
              "d_ts": torch.from_numpy(depth[2]).long()}

    totals = []
    for _ in range(6):
        params, opt_state, loss_j, m_j, (idx, d_idx, key) = jax_step(
            params, opt_state, step, data, depth)
        draws = _port_draws(key, data[0][idx], depth[0][d_idx], None)
        draws = {k: v for k, v in draws.items() if v is not None}
        m_t = sys_t.train_step(state, t_data, idx=torch.from_numpy(idx),
                               d_idx=torch.from_numpy(d_idx), **draws)
        step += 1
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
        assert set(want) == set(got)
        for name, ref in want.items():
            np.testing.assert_allclose(
                got[name].numpy(), ref.numpy(), atol=2e-5,
                err_msg=f"{name} after step {step - 1}")
    # steps 2..7: the depth term is in the total at steps 2 and 3 only, the
    # beta gate comes on at step 5 (1-based counter, epoch 2 of 3 steps)
    assert all(t > 0 for t in totals[:2]) and totals[2:] == [0.0] * 4
    assert [sys_t.beta_gate(s) for s in range(2, 8)] == [0, 0, 0, 1, 1, 1]


def test_uninjected_step_consumes_the_generator_in_the_documented_order():
    """The key tree of the JAX loss: k_render, k_depth = split(key), each
    split six ways (z, noise, pdf, fine noise, sc1, sc2) as the JAX render
    splits it; a step that draws from the key equals a step that is given
    those draws, made from jax.random at the same keys."""
    data, depth = _data(1)
    cfg = Config(model="sat-nerf", fused="rays", noise_std=1.0, **KW)
    system = NeRFSystem(cfg, device="cpu", dataset_len=N_DATA)
    params = system.init_params(0)
    idx = np.arange(B)
    args = (params, torch.from_numpy(data[0][idx]),
            torch.from_numpy(data[1][idx]),
            torch.from_numpy(data[2][idx]).long(), 0)
    dep = tuple(torch.from_numpy(a[idx]) for a in depth)
    dep = (dep[0], dep[1], dep[2].long())
    loss_a, _, g_a = system.loss_and_grads(
        *args, np.asarray(jax.random.PRNGKey(5)), depth=dep)

    from satnerf_tpu_torch.render.sampling import stratified_zvals

    k_render, k_depth = jax.random.split(jax.random.PRNGKey(5))
    kz, kn, kp, kf, ks1, ks2 = jax.random.split(k_render, 6)
    dz, dn, dp, df, _, _ = jax.random.split(k_depth, 6)

    def zvals(k, r):  # jitter uniform(k), the port's arithmetic
        return stratified_zvals(np.asarray(k), r[:, 6:7], r[:, 7:8], S, 1.0,
                                False)

    def normal(k, n):  # noise_std 1.0 at step 0
        return torch.from_numpy(np.asarray(jax.random.normal(k, (B, n))))

    def uniform(k):
        return torch.from_numpy(np.asarray(jax.random.uniform(k, (B, N_IMP))))

    kw = dict(z_vals=zvals(kz, args[1]), noise=normal(kn, S), u=uniform(kp),
              fine_noise=normal(kf, S + N_IMP), sc_noise=normal(ks1, S),
              sc_noise_fine=normal(ks2, S + N_IMP))
    kw.update(d_z_vals=zvals(dz, dep[0]), d_noise=normal(dn, S),
              d_u=uniform(dp), d_fine_noise=normal(df, S + N_IMP))
    loss_b, _, g_b = system.loss_and_grads(*args, depth=dep, **kw)
    assert float(loss_a) == float(loss_b)
    for k in g_a:
        assert torch.equal(g_a[k], g_b[k]), k


@pytest.mark.parametrize("fused,want", [
    ("off", [(True, True), (False, False)]), ("rays", [(False, False)])])
def test_depth_pass_marches_no_sun_rays(monkeypatch, fused, want):
    """With sc_lambda > 0 the color render marches the sun rays; the depth
    render, whose loss reads the depths only, does not (eager PyTorch would
    run the passes that XLA removes as dead code in the JAX step)."""
    import satnerf_tpu_torch.train.system as system_mod

    seen = []
    real = system_mod.render_rays

    def spy(models, rays, t_embed, cfg, *args, **kw):
        out = real(models, rays, t_embed, cfg, *args, **kw)
        seen.append((cfg.solar_correction, "weights_sc_fine" in out))
        return out

    monkeypatch.setattr(system_mod, "render_rays", spy)
    data, depth = _data(2)
    system = NeRFSystem(Config(model="sat-nerf", fused=fused, **KW),
                        device="cpu", dataset_len=N_DATA)
    params = system.init_params(0)
    idx = np.arange(B)
    system.loss_and_grads(
        params, torch.from_numpy(data[0][idx]), torch.from_numpy(data[1][idx]),
        torch.from_numpy(data[2][idx]).long(), 0, np.asarray(
            jax.random.PRNGKey(1)),
        depth=(torch.from_numpy(depth[0][idx]), torch.from_numpy(depth[1][idx]),
               torch.from_numpy(depth[2][idx]).long()))
    assert seen == want
