"""The train step's options, float32 on the CPU.

grad_accum: one step with grad_accum 2 on two injected micro-batches equals
the mean of the two micro-batches' losses and gradients (one Adam step from
the averaged gradient), and equals the JAX step: the same two micro-batches
through `_loss_and_metrics` under jax.value_and_grad, averaged as
`local_step` averages them (satnerf_tpu/train/system.py:717-741), one
`tx.update`. Tolerances as the trajectory test: loss 2e-5, parameters 2e-5.

--sampling shuffle: the positions a step reads equal the JAX
`epoch_draw_positions`, an epoch's draws are disjoint, the permutation
depends on the epoch and the seed only, and `fit` refreshes it at the epoch
boundary and on resume.
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
from satnerf_tpu.train.system import epoch_draw_positions as jax_positions
from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.train.checkpoints import params_from_jax
from satnerf_tpu_torch.train.system import NeRFSystem, epoch_draw_positions
from satnerf_tpu_torch.utils import jax_prng

torch.set_num_threads(1)

B, N_DATA, LAYERS = 16, 96, 4
KW = dict(batch_size=B, fc_units=32, fc_layers=LAYERS, n_samples=8,
          max_train_steps=30, first_beta_epoch=0, lr=1e-3, noise_std=0.0)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    rays = rng.rand(N_DATA, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    rgbs = rng.rand(N_DATA, 3).astype(np.float32)
    ts = rng.randint(0, 5, N_DATA).astype(np.int32)
    return rays, rgbs, ts


def _t_data(data):
    return {"rays": torch.from_numpy(data[0]), "rgbs": torch.from_numpy(data[1]),
            "ts": torch.from_numpy(data[2]).long()}


def _micro(m, rays):
    idx = np.random.RandomState(200 + m).randint(0, N_DATA, B)
    key = jax.random.PRNGKey(2000 + m)
    k_z = jax.random.split(jax.random.split(key)[0], 6)[0]
    b = jnp.asarray(rays[idx])
    z = jax_zvals(k_z, b[:, 6:7], b[:, 7:8], KW["n_samples"], 1.0, False)
    return idx, key, np.array(z)


@pytest.mark.parametrize("variant", ["sat-nerf", "s-nerf"])
def test_grad_accum_2_is_the_mean_of_two_micro_batches(eight_devices, variant):
    data = _data()
    sys_j = JaxSystem(JaxConfig(model=variant, fused="off", grad_accum=2, **KW),
                      dataset_len=N_DATA)
    sys_t = NeRFSystem(Config(model=variant, grad_accum=2, fused="rays", **KW), device="cpu",
                       dataset_len=N_DATA)
    assert sys_j.spe == sys_t.spe == N_DATA // (2 * B)
    params = sys_j.init_params(jax.random.PRNGKey(0))
    micro = [_micro(m, data[0]) for m in range(2)]

    # the JAX step's accumulation, written out
    def value_and_grad(idx, key):
        rays, rgbs, ts = (jnp.asarray(a[idx]) for a in data)
        return jax.value_and_grad(
            lambda p: sys_j._loss_and_metrics(
                p, rays, rgbs, ts if sys_j.use_ts else None, key,
                jnp.asarray(0, jnp.int32)), has_aux=True)(params)

    (l0, _), g0 = value_and_grad(*micro[0][:2])
    (l1, _), g1 = value_and_grad(*micro[1][:2])
    g_mean = jax.tree_util.tree_map(lambda a, b: (a + b) * 0.5, g0, g1)
    updates, _ = sys_j.tx.update(g_mean, sys_j.tx.init(params), params)
    want = params_from_jax(jax.device_get(optax.apply_updates(params, updates)),
                           variant, LAYERS)

    start = params_from_jax(jax.device_get(params), variant, LAYERS)
    t_data = _t_data(data)

    # the port's micro-batches one by one
    single = NeRFSystem(Config(model=variant, fused="rays", **KW), device="cpu",
                        dataset_len=N_DATA)
    state1 = single.init_state(0)
    state1.params.load_state_dict(start)
    parts = []
    for idx, _, z in micro:
        i = torch.from_numpy(idx)
        parts.append(single.loss_and_grads(
            state1.params, t_data["rays"][i], t_data["rgbs"][i],
            t_data["ts"][i] if single.use_ts else None, 0,
            z_vals=torch.from_numpy(z)))
    np.testing.assert_allclose(float(parts[0][0]), float(l0), atol=2e-5)
    np.testing.assert_allclose(float(parts[1][0]), float(l1), atol=2e-5)

    state = sys_t.init_state(0)
    state.params.load_state_dict(start)
    m = sys_t.train_step(state, t_data,
                         idx=[torch.from_numpy(i) for i, _, _ in micro],
                         z_vals=[torch.from_numpy(z) for _, _, z in micro])
    assert state.step == 1  # one optimizer step
    np.testing.assert_allclose(
        float(m["loss"]), 0.5 * (float(parts[0][0]) + float(parts[1][0])),
        rtol=1e-6)
    np.testing.assert_allclose(float(m["loss"]), 0.5 * (float(l0) + float(l1)),
                               atol=2e-5)
    for name, p in state.params.named_parameters():
        mean = 0.5 * (parts[0][2][name] + parts[1][2][name])
        np.testing.assert_allclose(p.grad.numpy(), mean.numpy(), rtol=1e-5,
                                   atol=1e-9, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2e-5, err_msg=name)
    assert m["lr"] == pytest.approx(float(sys_j.lr_schedule(0)))
    assert {float(s["step"]) for s in state.optimizer.state.values()} == {1.0}


def test_grad_accum_draws_from_the_generator_and_checks_its_options():
    data = _t_data(_data(1))
    system = NeRFSystem(Config(model="sat-nerf", grad_accum=3, **KW),
                        device="cpu", dataset_len=N_DATA)
    runs = []
    for _ in range(2):
        state = system.init_state(0)
        m = system.train_step(state, data, jax_prng.prng_key(1))
        runs.append(float(m["loss"]))
    assert runs[0] == runs[1] and np.isfinite(runs[0]) and state.step == 1
    with pytest.raises(ValueError, match="grad_accum"):
        NeRFSystem(Config(grad_accum=2, sampling="shuffle"), device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        NeRFSystem(Config(grad_accum=0), device="cpu")


def test_shuffle_positions_match_jax_and_are_disjoint_within_an_epoch():
    n, b = 1000, 64
    spe = n // b
    seen = []
    for step in range(2 * spe):
        pos = epoch_draw_positions(step, spe, b, n)
        np.testing.assert_array_equal(
            pos.numpy(), np.asarray(jax_positions(jnp.asarray(step), spe, b, n)))
        seen.append(pos)
    first = torch.cat(seen[:spe])
    assert first.unique().numel() == spe * b  # no ray twice in an epoch
    assert torch.equal(first, torch.cat(seen[spe:]))  # same slots next epoch


def test_shuffle_step_reads_the_permutation():
    data = _t_data(_data(2))
    cfg = Config(model="sat-nerf", sampling="shuffle", **KW)
    system = NeRFSystem(cfg, device="cpu", dataset_len=N_DATA)
    spe = system.spe
    assert spe == N_DATA // B
    perm0, perm1 = system.epoch_perm(N_DATA, 0), system.epoch_perm(N_DATA, 1)
    assert torch.equal(perm0, system.epoch_perm(N_DATA, 0))  # resume-safe
    assert sorted(perm0.tolist()) == list(range(N_DATA))
    assert not torch.equal(perm0, perm1)
    other = NeRFSystem(Config(model="sat-nerf", sampling="shuffle", seed=7, **KW),
                       device="cpu", dataset_len=N_DATA)
    assert not torch.equal(perm0, other.epoch_perm(N_DATA, 0))

    # a shuffled step equals the step with the permutation's slice injected
    z = torch.sort(torch.rand(B, 8, generator=torch.Generator().manual_seed(5)))[0]
    a = system.init_state(0)
    b = system.init_state(0)
    a.step = b.step = 2
    system.train_step(a, {**data, "perm": perm0}, z_vals=z)
    system.train_step(b, data, idx=perm0[2 * B:3 * B], z_vals=z)
    for (name, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        assert torch.equal(p, q), name


def test_fit_refreshes_the_permutation_at_epoch_boundaries(tmp_path, monkeypatch):
    """`fit` with --sampling shuffle: every ray of the AOI is read exactly
    once in each full epoch, across a resume in the middle of an epoch."""
    from satnerf_tpu_torch.cli import train as cli_train
    from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi

    data_dir, gt_dir = make_synthetic_aoi(str(tmp_path / "aoi"), size=8)
    n, batch = 3 * 8 * 8, 32  # 6 steps an epoch
    seen = []
    real = NeRFSystem.loss_and_grads

    def spy(self, params, rays, *a, **kw):
        seen.append(rays.clone())
        return real(self, params, rays, *a, **kw)

    monkeypatch.setattr(NeRFSystem, "loss_and_grads", spy)

    def argv(steps, name, extra=()):
        return ["--root_dir", data_dir, "--gt_dir", gt_dir, "--exp_name", name,
                "--device", "cpu", "--batch_size", str(batch), "--fc_units", "16",
                "--fc_layers", "4", "--n_samples", "4", "--max_train_steps",
                str(steps), "--sampling", "shuffle", "--save_every_n_epochs",
                "1", "--num_sanity_val_steps", "0", "--chunk", "512",
                "--logs_dir", str(tmp_path / "logs"), "--ckpts_dir",
                str(tmp_path / "ckpts"), *extra]

    first = cli_train.main(argv(9, "a"))  # one epoch and a half
    assert first["system"].spe == 6 and len(seen) == 9
    ckpt = str(tmp_path / "ckpts" / first["cfg"].exp_name / "epoch=1.ckpt")
    seen_first = list(seen)
    seen.clear()
    cli_train.main(argv(12, "b", ["--ckpt_path", ckpt]))  # resumes at step 9
    assert len(seen) == 3
    epochs = [torch.cat(seen_first[:6]), torch.cat(seen_first[6:] + seen)]
    for rays in epochs:
        assert rays.shape[0] == n
        assert torch.unique(rays, dim=0).shape[0] == n  # each ray once
    assert not torch.equal(epochs[0], epochs[1])
