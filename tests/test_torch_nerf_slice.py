"""The classic NeRF variant (`--model nerf`) as a slice, on the CPU in float32.

1. loss_and_grads and a 6-step trajectory of the port against the JAX system
   from bridged weights and Adam state, `--fused on` on both sides: the plain
   step (K7 fused_nerf_train_loss_grads; the JAX side runs its Pallas kernel in
   interpret mode), then `--n_importance` and `--ds_lambda` (the plain renderer
   over K9 fused_nerf_apply, a fine model, a depth pass; `--sc_lambda` is set
   and changes nothing: the variant has no sun head). The draws are the ones
   the JAX renders make from their keys, injected into the port. Parameters
   2e-5 after each step, as tests/test_torch_train_step.py holds the SIREN
   variants; losses 5e-4 and gradients 3e-3 of each tensor's largest entry
   against the interpreted kernels (their fast trig), 2e-5 / 1e-4 against the
   XLA path.
2. `cli.train --model nerf` on a synthetic satellite AOI: train, checkpoint,
   resume, serve with `create_pretty_dsm` and `eval_aoi`; the JAX package
   reads the port's checkpoint and renders the same image.
3. `--data blender`: rays of 8 columns, no sun direction, no DSM.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from satnerf_tpu.config import Config as JaxConfig
from satnerf_tpu.train.checkpoints import import_torch_checkpoint
from satnerf_tpu.train.system import NeRFSystem as JaxSystem
from satnerf_tpu_torch.cli import train as cli_train
from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.data.satellite import SatelliteScene
from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi
from satnerf_tpu_torch.eval.loader import load_nerf
from satnerf_tpu_torch.train.checkpoints import adam_from_jax, params_from_jax
from satnerf_tpu_torch.train.system import NeRFSystem
from satnerf_tpu_torch.utils import jax_prng
from tests.test_blender import build_blender_fixture
from tests.test_torch_render_hier import jax_render_draws

torch.set_num_threads(1)

B, N_DATA, N_DEPTH, LAYERS, S, N_IMP = 32, 96, 40, 6, 8, 4
KW = dict(model="nerf", batch_size=B, fc_units=32, fc_layers=LAYERS,
          n_samples=S, max_train_steps=30, lr=1e-3, noise_std=1.0)
MODES = {
    "k7": dict(),
    "hier": dict(n_importance=N_IMP),
    "depth": dict(ds_lambda=1000.0, ds_drop=5 / 30, sc_lambda=0.1),
}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    rays = rng.rand(N_DATA, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 8:11] /= np.linalg.norm(rays[:, 8:11], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    rgbs = rng.rand(N_DATA, 3).astype(np.float32)
    ts = np.zeros(N_DATA, np.int32)
    d_rays = rays[rng.randint(0, N_DATA, N_DEPTH)].copy()
    d_depths = np.stack([rng.uniform(0.2, 0.8, N_DEPTH),
                         rng.uniform(0.3, 1.0, N_DEPTH)], -1).astype(np.float32)
    return (rays, rgbs, ts), (d_rays, d_depths, np.zeros(N_DEPTH, np.int32))


def _batch(step):
    idx = np.random.RandomState(100 + step).randint(0, N_DATA, B)
    d_idx = np.random.RandomState(300 + step).randint(0, N_DEPTH, B)
    return idx, d_idx, jax.random.PRNGKey(1000 + step)


def _port_draws(key, rays, d_rays, noise_std, n_imp, with_depth):
    """The draws of the JAX step for this key, keyed as the port's keyword
    arguments; those a configuration does not draw are left out."""
    k_render, k_depth = jax.random.split(key)
    d = jax_render_draws(k_render, rays, S, max(n_imp, 1), noise_std)
    kw = dict(z_vals=d["z_vals"], noise=d["noise"])
    if n_imp:
        kw.update(u=d["u"], fine_noise=d["fine_noise"])
    if with_depth:
        dd = jax_render_draws(k_depth, d_rays, S, max(n_imp, 1), noise_std)
        kw.update(d_z_vals=dd["z_vals"], d_noise=dd["noise"])
        if n_imp:
            kw.update(d_u=dd["u"], d_fine_noise=dd["fine_noise"])
    return {k: torch.from_numpy(np.array(v)) for k, v in kw.items()
            if v is not None}


def _named(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree, "nerf",
                                                     LAYERS).items()}


def _jax_value_and_grad(system, with_depth):
    """(loss, metrics), grads of one batch as the JAX train step computes
    them, jitted once; with a fused mode on, its Pallas kernels are traced in
    interpret mode."""
    def run(params, rays, rgbs, key, step, depth):
        depth = depth if with_depth else ()
        if system._use_fused_train_loss:
            return system._fused_loss_and_grads(params, rays, rgbs, None, key,
                                                step, *depth)

        def loss_fn(p):
            return system._loss_and_metrics(p, rays, rgbs, None, key, step,
                                            *depth)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    jitted = jax.jit(run)

    def call(*args):
        if system.fused_mode == "off":
            return jitted(*args)
        with pltpu.force_tpu_interpret_mode():
            return jitted(*args)

    return call


def _systems(mode, jax_fused, noise_std=1.0):
    opts = {**KW, **MODES[mode], "noise_std": noise_std}
    sys_j = JaxSystem(JaxConfig(fused=jax_fused, **opts), dataset_len=N_DATA,
                      depth_dataset_len=N_DEPTH)
    sys_t = NeRFSystem(Config(fused="on", **opts), device="cpu",
                       dataset_len=N_DATA)
    return sys_j, sys_t


def _on_torch(arrays):
    rays, x, ts = (torch.from_numpy(a) for a in arrays)
    return rays, x, ts.long()


@pytest.mark.parametrize("jax_fused", ["on", "off"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_loss_and_grads_match_jax(eight_devices, mode, jax_fused):
    step = 2
    sys_j, sys_t = _systems(mode, jax_fused)
    assert sys_t.fused_mode == "points" and sys_t.is_nerf
    assert sys_j.fused_mode == {"on": "points", "off": "off"}[jax_fused]
    # the plain step is K7 where a fused mode is on; the others take autograd
    assert sys_j._use_fused_train_loss == (mode == "k7" and jax_fused == "on")
    data, depth = _data()
    with_depth = sys_t.depth
    idx, d_idx, key = _batch(step)
    params = sys_j.init_params(jax.random.PRNGKey(0))
    (loss_j, m_j), g_j = _jax_value_and_grad(sys_j, with_depth)(
        params, jnp.asarray(data[0][idx]), jnp.asarray(data[1][idx]), key,
        jnp.asarray(step, jnp.int32),
        tuple(jnp.asarray(a[d_idx]) for a in depth))
    want = _named(jax.device_get(g_j))

    state = sys_t.init_state(0)
    state.params.load_state_dict(
        params_from_jax(jax.device_get(params), "nerf", LAYERS))
    draws = _port_draws(key, data[0][idx], depth[0][d_idx], 0.9 ** step,
                        sys_t.cfg.n_importance, with_depth)
    rays, rgbs, _ = _on_torch([a[idx] for a in data])
    loss_t, m_t, grads = sys_t.loss_and_grads(
        state.params, rays, rgbs, None, step,
        depth=_on_torch([a[d_idx] for a in depth]) if with_depth else None,
        **draws)
    a_loss, a_grad = (2e-5, 1e-4) if jax_fused == "off" else (5e-4, 3e-3)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=a_loss,
                               rtol=a_loss)
    assert set(m_t) == set(m_j) == {"loss", "psnr", "loss_total"} | (
        {"loss_depth"} if with_depth else set())
    for k in m_t:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), atol=5e-3 if
                                   k == "psnr" else a_loss, rtol=a_loss,
                                   err_msg=k)
    assert set(grads) == set(want)
    assert any(k.startswith("nerf_fine.") for k in grads) == (mode == "hier")
    for name, ref in want.items():
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(grads[name].numpy() / scale, ref / scale,
                                   atol=a_grad, err_msg=name)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trajectory_matches_jax_step(eight_devices, mode):
    """Two JAX steps, then the port takes over weights and Adam state and six
    steps run side by side. The JAX side is its XLA path for the two modes
    that go through autograd and its Pallas K7 (interpret mode) for the plain
    step; the port runs `--fused on` throughout."""
    sys_j, sys_t = _systems(mode, "on" if mode == "k7" else "off",
                            noise_std=0.0)
    data, depth = _data()
    with_depth = sys_t.depth
    value_and_grad = _jax_value_and_grad(sys_j, with_depth)

    def jax_step(params, opt_state, step):
        idx, d_idx, key = _batch(step)
        (loss, metrics), grads = value_and_grad(
            params, jnp.asarray(data[0][idx]), jnp.asarray(data[1][idx]), key,
            jnp.asarray(step, jnp.int32),
            tuple(jnp.asarray(a[d_idx]) for a in depth))
        updates, opt_state = sys_j.tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, float(loss),
                metrics, (idx, d_idx, key))

    params = sys_j.init_params(jax.random.PRNGKey(0))
    opt_state = sys_j.tx.init(params)
    step = 0
    for _ in range(2):
        params, opt_state, _, _, _ = jax_step(params, opt_state, step)
        step += 1
    state = sys_t.init_state(0)
    state.params.load_state_dict(
        params_from_jax(jax.device_get(params), "nerf", LAYERS))
    adam = opt_state[0]
    adam_from_jax(state.optimizer, state.params, jax.device_get(adam.mu),
                  jax.device_get(adam.nu), int(adam.count), "nerf", LAYERS)
    state.step = step
    rays, rgbs, ts = _on_torch(data)
    t_data = {"rays": rays, "rgbs": rgbs, "ts": ts}
    if with_depth:
        d_rays, d_depths, d_ts = _on_torch(depth)
        t_data.update(d_rays=d_rays, d_depths=d_depths, d_ts=d_ts)

    totals = []
    for _ in range(6):
        params, opt_state, loss_j, m_j, (idx, d_idx, key) = jax_step(
            params, opt_state, step)
        draws = _port_draws(key, data[0][idx], depth[0][d_idx], None,
                            sys_t.cfg.n_importance, with_depth)
        m_t = sys_t.train_step(
            state, t_data, idx=torch.from_numpy(idx),
            d_idx=torch.from_numpy(d_idx) if with_depth else None, **draws)
        step += 1
        assert state.step == step
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   atol=2e-5 if mode != "k7" else 5e-4,
                                   err_msg=f"loss at step {step - 1}")
        np.testing.assert_allclose(float(m_t["loss_total"]), loss_j,
                                   rtol=5e-4, atol=5e-4)
        totals.append(float(m_t["loss_total"]) - float(m_t["loss"]))
        want = params_from_jax(jax.device_get(params), "nerf", LAYERS)
        got = state.params.state_dict()
        assert set(want) == set(got)
        for name, ref in want.items():
            np.testing.assert_allclose(
                got[name].numpy(), ref.numpy(), atol=2e-5,
                err_msg=f"{name} after step {step - 1}")
    if with_depth:
        # steps 2..7: the depth term is in the total at steps 2 and 3 only
        assert sys_t.ds_drop_step == 5
        assert all(t > 0 for t in totals[:2]) and totals[2:] == [0.0] * 4
    else:
        assert totals == [0.0] * 6


def test_sc_lambda_changes_nothing_for_nerf():
    """The variant has no sun head: --sc_lambda 0.1 draws no sun-ray noise,
    marches no sun rays and gives the loss and gradients of --sc_lambda 0."""
    data, _ = _data(1)
    rays, rgbs, _ = _on_torch([a[:B] for a in data])
    out = []
    for sc in (0.0, 0.1):
        system = NeRFSystem(Config(fused="on", sc_lambda=sc, **KW),
                            device="cpu", dataset_len=N_DATA)
        params = system.init_params(0)
        out.append(system.loss_and_grads(
            params, rays, rgbs, None, 0,
            jax_prng.prng_key(3)))
    assert float(out[0][0]) == float(out[1][0])
    for k, v in out[0][2].items():
        assert torch.equal(v, out[1][2][k]), k


def test_rays_without_a_sun_direction_train_and_render():
    """(N, 8) rays, as the blender dataset gives them: every path of the nerf
    variant asks whether the sun columns exist before it reads them."""
    data, _ = _data(2)
    rays8 = np.ascontiguousarray(data[0][:, :8])
    for opts in (dict(fused="on"), dict(fused="off"),
                 dict(fused="on", n_importance=N_IMP)):
        system = NeRFSystem(Config(**{**KW, **opts}), device="cpu",
                            dataset_len=N_DATA)
        state = system.init_state(0)
        t_data = {"rays": torch.from_numpy(rays8),
                  "rgbs": torch.from_numpy(data[1]),
                  "ts": torch.zeros(N_DATA, dtype=torch.long)}
        m = system.train_step(state, t_data, jax_prng.prng_key(1))
        assert np.isfinite(float(m["loss"]))
        res = system.render_image(state.params, rays8, None)
        typ = "fine" if "n_importance" in opts else "coarse"
        assert res[f"rgb_{typ}"].shape == (N_DATA, 3)
        assert not any(k.startswith(("sun_", "albedo_", "sky_", "beta_"))
                       for k in res)


# ------------------------------------------------------------ through the CLI

STEPS, RESUMED_STEPS, CLI_LAYERS = 24, 30, 4


def _argv(root, data_dir, gt_dir, steps, exp_name, extra=()):
    argv = ["--root_dir", data_dir, "--model", "nerf", "--exp_name", exp_name,
            "--device", "cpu", "--batch_size", "64", "--fc_units", "32",
            "--fc_layers", str(CLI_LAYERS), "--n_samples", "8",
            "--max_train_steps", str(steps), "--log_every_n_steps", "4",
            "--save_every_n_epochs", "1", "--lr", "1e-3", "--chunk", "4096",
            "--num_sanity_val_steps", "1", "--fused", "on",
            "--logs_dir", str(root / "logs"), "--ckpts_dir", str(root / "ckpts"),
            *extra]
    return argv + (["--gt_dir", gt_dir] if gt_dir else [])


def _logged(cfg):
    with open(os.path.join(cfg.logs_dir, cfg.exp_name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("nerf_slice")
    data_dir, gt_dir = make_synthetic_aoi(str(root / "aoi"), size=16)
    out = cli_train.main(_argv(root, data_dir, gt_dir, STEPS, "first"))
    return {"root": root, "data_dir": data_dir, "gt_dir": gt_dir, **out}


def test_cli_trains_checkpoints_and_validates(trained):
    cfg, system = trained["cfg"], trained["system"]
    assert system.fused_mode == "points" and system.is_nerf
    assert system.spe == 12 and trained["state"].step == STEPS
    run_ckpts = os.path.join(cfg.ckpts_dir, cfg.exp_name)
    assert sorted(os.listdir(run_ckpts)) == ["epoch=1.ckpt", "epoch=2.ckpt"]
    ckpt = torch.load(os.path.join(run_ckpts, "epoch=2.ckpt"), weights_only=True)
    assert ckpt["global_step"] == STEPS
    names = set(ckpt["state_dict"])
    assert all(n.startswith("nerf_coarse.") for n in names)  # no embedding
    assert {"nerf_coarse.fc_net.0.weight", "nerf_coarse.rgb_from_xyzdir.2.bias",
            "nerf_coarse.sigma_from_xyz.0.weight"} <= names
    assert ckpt["state_dict"]["nerf_coarse.fc_net.0.weight"].shape == (32, 60)
    rows = [r for r in _logged(cfg) if "train/loss" in r]
    assert [r["step"] for r in rows] == list(range(4, STEPS + 1, 4))
    assert all(np.isfinite(r["train/loss"]) for r in rows)
    assert rows[-1]["train/loss"] < rows[0]["train/loss"]
    m = trained["metrics"]
    assert set(m) == {"val/psnr", "val/ssim", "val/mae"}
    assert all(np.isfinite(v) for v in m.values())


def test_cli_resumes_and_serves(trained, capsys):
    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.cli.eval import eval_aoi

    cfg, root = trained["cfg"], trained["root"]
    ckpt = os.path.join(cfg.ckpts_dir, cfg.exp_name, "epoch=2.ckpt")
    out = cli_train.main(_argv(root, trained["data_dir"], trained["gt_dir"],
                               RESUMED_STEPS, "second", ["--ckpt_path", ckpt]))
    assert f"resumed from {ckpt} at step {STEPS}" in capsys.readouterr().out
    assert out["state"].step == RESUMED_STEPS
    steps = {float(s["step"]) for s in out["state"].optimizer.state.values()}
    assert steps == {float(RESUMED_STEPS)}
    rows = [r for r in _logged(out["cfg"]) if "train/loss" in r]
    assert [r["step"] for r in rows] == [28]
    mae = create_pretty_dsm(cfg.exp_name, cfg.logs_dir, str(root / "out"), 2,
                            device="cpu")
    assert np.isfinite(mae)
    got = eval_aoi(cfg.exp_name, cfg.logs_dir, str(root / "eval"), 2,
                   device="cpu")
    assert set(got) == {"psnr", "ssim", "mae"}
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("extra", [["--n_importance", "4"],
                                   ["--ds_lambda", "1000", "--ds_drop", "0.5"]],
                         ids=["hier", "depth"])
def test_cli_trains_through_the_point_field(trained, tmp_path_factory, extra):
    """--n_importance and --ds_lambda train through the plain renderer over
    fused_nerf_apply; the depth run needs an AOI with key points."""
    root = trained["root"]
    data_dir, gt_dir = trained["data_dir"], trained["gt_dir"]
    if "--ds_lambda" in extra:
        root = tmp_path_factory.mktemp("nerf_depth")
        data_dir, gt_dir = make_synthetic_aoi(
            str(root / "aoi"), size=16, with_keypoints=True, n_kp=40)
    out = cli_train.main(_argv(root, data_dir, gt_dir, 8, "pt", extra))
    assert out["system"].fused_mode == "points" and out["state"].step == 8
    rows = [r for r in _logged(out["cfg"]) if "train/loss" in r]
    assert rows and all(np.isfinite(r["train/loss"]) for r in rows)
    assert ("train/loss_depth" in rows[0]) == ("--ds_lambda" in extra)
    assert all(np.isfinite(v) for v in out["metrics"].values())
    has_fine = any(n.startswith("nerf_fine.") for n, _ in
                   out["state"].params.named_parameters())
    assert has_fine == ("--n_importance" in extra)


def test_jax_package_reads_the_trained_checkpoint(trained):
    """import_torch_checkpoint and the JAX render on the port's weights agree
    with the port's own render of them (1e-4, as the SIREN slice tests)."""
    cfg = trained["cfg"]
    ckpt = os.path.join(cfg.ckpts_dir, cfg.exp_name, "epoch=2.ckpt")
    jparams = import_torch_checkpoint(ckpt, "nerf", layers=CLI_LAYERS)
    assert set(jparams) == {"coarse"}
    jcfg = JaxConfig(model="nerf", fc_layers=CLI_LAYERS, fc_units=32,
                     n_samples=8, chunk=512, fused="off", precision="float32")
    jsys = JaxSystem(jcfg, dataset_len=jcfg.batch_size)
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    system, params = load_nerf(cfg.exp_name, cfg.logs_dir, cfg.ckpts_dir, 2,
                               device="cpu")
    rays = SatelliteScene(cfg.root_dir, None, split="val").load_image(1)["rays"]
    ref = jsys.render_image(jparams, rays, None)
    got = system.render_image(params, rays, None)
    assert set(got) == {"rgb_coarse", "depth_coarse", "opacity_coarse",
                        "weights_coarse"}
    for k in ("rgb_coarse", "depth_coarse"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, err_msg=k)
    fresh = system.init_params(0)
    assert not torch.equal(fresh["nerf_coarse"].fc_net[0].weight,
                           params["nerf_coarse"].fc_net[0].weight)


def test_cli_trains_on_the_blender_dataset(tmp_path_factory):
    """--data blender: (N, 8) rays, PSNR and SSIM only (no DSM to score)."""
    root = tmp_path_factory.mktemp("nerf_blender")
    scene = build_blender_fixture(str(root / "scene"), size=16)
    out = cli_train.main(_argv(root, scene, None, 6, "blend",
                               ["--data", "blender",
                                "--num_sanity_val_steps", "0"]))
    assert out["state"].step == 6 and out["cfg"].data == "blender"
    assert set(out["metrics"]) == {"val/psnr", "val/ssim"}
    assert all(np.isfinite(v) for v in out["metrics"].values())
    rows = [r for r in _logged(out["cfg"]) if "train/loss" in r]
    assert rows and np.isfinite(rows[-1]["train/loss"])
    assert os.path.exists(os.path.join(out["cfg"].ckpts_dir,
                                       out["cfg"].exp_name, "epoch=0.ckpt"))
