"""The training slice end to end on the CPU: `cli.train.main` on a tiny
synthetic AOI (sat-nerf 4 x 32, 8 samples, batch 64, f32), then what a user
does with the run: resume it, serve its checkpoint with the port, and read
the checkpoint with the JAX package. Then the same with the full recipe
(`--sc_lambda 0.1 --ds_lambda 1000`) on an AOI with key points."""

import copy
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from satnerf_tpu.config import Config as JaxConfig
from satnerf_tpu.train.checkpoints import import_torch_checkpoint
from satnerf_tpu.train.system import NeRFSystem as JaxSystem
from satnerf_tpu_torch.cli import train as cli_train
from satnerf_tpu_torch.data import load_dataset
from satnerf_tpu_torch.data.satellite import SatelliteScene
from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi
from satnerf_tpu_torch.eval.loader import load_nerf
from satnerf_tpu_torch.train.checkpoints import load_checkpoint
from satnerf_tpu_torch.train.losses import depth_loss
from satnerf_tpu_torch.utils import jax_prng

torch.set_num_threads(1)

STEPS, RESUMED_STEPS = 24, 30


def _argv(root, data_dir, gt_dir, steps, exp_name, extra=()):
    return ["--root_dir", data_dir, "--gt_dir", gt_dir, "--model", "sat-nerf",
            "--exp_name", exp_name, "--device", "cpu", "--batch_size", "64",
            "--fc_units", "32", "--fc_layers", "4", "--n_samples", "8",
            "--max_train_steps", str(steps), "--log_every_n_steps", "4",
            "--save_every_n_epochs", "1", "--first_beta_epoch", "1",
            "--lr", "1e-3", "--chunk", "512", "--num_sanity_val_steps", "1",
            "--logs_dir", str(root / "logs"), "--ckpts_dir", str(root / "ckpts"),
            *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_slice")
    data_dir, gt_dir = make_synthetic_aoi(str(root / "aoi"), size=16)
    out = cli_train.main(_argv(root, data_dir, gt_dir, STEPS, "first"))
    return {"root": root, "data_dir": data_dir, "gt_dir": gt_dir, **out}


def _logged(cfg):
    with open(os.path.join(cfg.logs_dir, cfg.exp_name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_writes_checkpoints_opts_and_metrics(trained):
    cfg, system = trained["cfg"], trained["system"]
    assert system.spe == 3 * 16 * 16 // 64 == 12
    assert trained["state"].step == STEPS
    run_ckpts = os.path.join(cfg.ckpts_dir, cfg.exp_name)
    assert sorted(os.listdir(run_ckpts)) == ["epoch=1.ckpt", "epoch=2.ckpt"]
    ckpt = torch.load(os.path.join(run_ckpts, "epoch=2.ckpt"),
                      weights_only=True)
    assert ckpt["global_step"] == STEPS
    assert set(ckpt) == {"state_dict", "optimizer_states", "global_step"}
    with open(os.path.join(cfg.logs_dir, cfg.exp_name, "opts.json")) as f:
        opts = json.load(f)
    assert opts["model"] == "sat-nerf" and opts["device"] == "cpu"
    rows = _logged(cfg)
    train_rows = [r for r in rows if "train/loss" in r]
    assert [r["step"] for r in train_rows] == list(range(4, STEPS + 1, 4))
    assert all(np.isfinite(r["train/loss"]) for r in train_rows)
    # lr drops by 0.9 at the epoch boundary; the logged step s ran as step s-1
    assert train_rows[0]["lr"] == pytest.approx(1e-3)
    assert train_rows[-1]["lr"] == pytest.approx(1e-3 * 0.9)
    m = trained["metrics"]
    assert set(m) == {"val/psnr", "val/ssim", "val/mae"}
    assert all(np.isfinite(v) for v in m.values())
    products = os.path.join(cfg.logs_dir, cfg.exp_name, "val")
    assert glob.glob(os.path.join(products, "dsm", "*.tif"))


def test_resume_continues_the_step_count(trained, capsys):
    cfg, root = trained["cfg"], trained["root"]
    ckpt = os.path.join(cfg.ckpts_dir, cfg.exp_name, "epoch=2.ckpt")
    out = cli_train.main(_argv(root, trained["data_dir"], trained["gt_dir"],
                               RESUMED_STEPS, "second",
                               ["--ckpt_path", ckpt]))
    assert f"resumed from {ckpt} at step {STEPS}" in capsys.readouterr().out
    assert out["state"].step == RESUMED_STEPS
    rows = [r for r in _logged(out["cfg"]) if "train/loss" in r]
    assert [r["step"] for r in rows] == [28]
    # Adam's step count came back with its moments
    steps = {float(s["step"]) for s in out["state"].optimizer.state.values()}
    assert steps == {float(RESUMED_STEPS)}
    # the first logged loss is at the trained level (beta loss on: ~1.3),
    # not where a fresh model starts its warm-up
    first_run = [r for r in _logged(cfg) if "train/loss" in r]
    assert abs(rows[0]["train/loss"] - first_run[-1]["train/loss"]) < 0.3


def test_port_serves_the_trained_checkpoint(trained):
    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm

    cfg, root = trained["cfg"], trained["root"]
    mae = create_pretty_dsm(cfg.exp_name, cfg.logs_dir, str(root / "out"), 2,
                            device="cpu")
    assert np.isfinite(mae)
    assert glob.glob(os.path.join(root, "out", cfg.exp_name,
                                  "*_dsm_epoch2.tif"))


def test_jax_package_reads_the_trained_checkpoint(trained):
    """import_torch_checkpoint + the JAX render on the port's weights agree
    with the port's own render of them (1e-4, as the serving slice test)."""
    cfg = trained["cfg"]
    ckpt = os.path.join(cfg.ckpts_dir, cfg.exp_name, "epoch=2.ckpt")
    jparams = import_torch_checkpoint(ckpt, "sat-nerf", layers=4)
    jcfg = JaxConfig(model="sat-nerf", fc_layers=4, fc_units=32, n_samples=8,
                     chunk=512, fused="off", precision="float32")
    jsys = JaxSystem(jcfg, dataset_len=jcfg.batch_size)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, jparams)

    system, params = load_nerf(cfg.exp_name, cfg.logs_dir, cfg.ckpts_dir, 2,
                               device="cpu")
    sample = SatelliteScene(cfg.root_dir, None, split="val").load_image(1)
    rays = sample["rays"]
    ts = np.full(rays.shape[0], 2, np.int32)
    ref = jsys.render_image(jparams, rays, ts)
    out = system.render_image(params, rays, ts)
    for k in ("rgb_coarse", "depth_coarse"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)
    # the trained weights differ from a fresh model's
    fresh = system.init_params(0)
    assert not torch.equal(fresh["nerf_coarse"].fc_net[0].weight,
                           params["nerf_coarse"].fc_net[0].weight)


def test_unported_training_options_raise(trained):
    """No training option is left unported: `--model nerf`, the last that
    raised, trains on the same AOI (tests/test_torch_nerf_slice.py follows the
    run further); an unknown dataset kind is refused by the parser."""
    root = trained["root"]
    out = cli_train.main(_argv(root, trained["data_dir"], trained["gt_dir"],
                               4, "nerf", ["--model", "nerf"]))
    assert out["state"].step == 4 and out["cfg"].model == "nerf"
    assert all(np.isfinite(v) for v in out["metrics"].values())
    with pytest.raises(SystemExit):
        cli_train.main(_argv(root, trained["data_dir"], trained["gt_dir"],
                             4, "no", ["--data", "lidar"]))


def test_more_than_one_device_is_refused(trained):
    """--n_devices 2 on the CPU trains two gloo ranks (ROADMAP M7): this
    process is rank 0, whose run is returned and written; 1 trains as 0
    does, in one process."""
    root = trained["root"]
    out = cli_train.main(_argv(root, trained["data_dir"], trained["gt_dir"], 2,
                               "two", ["--n_devices", "2"]))
    assert out["state"].step == 2 and out["system"].world == 2
    assert all(np.isfinite(v) for v in out["metrics"].values())
    cfg = out["cfg"]
    assert os.path.isfile(os.path.join(cfg.logs_dir, cfg.exp_name,
                                       "opts.json"))
    assert os.listdir(os.path.join(cfg.ckpts_dir, cfg.exp_name)) == \
        ["epoch=0.ckpt"]
    out = cli_train.main(_argv(root, trained["data_dir"], trained["gt_dir"], 1,
                               "one", ["--n_devices", "1"]))
    assert out["state"].step == 1 and out["system"].world == 1


def test_rays_per_sec_counts_validation_as_the_jax_loop_does(trained,
                                                             monkeypatch):
    """One clock across the epoch boundary, as satnerf_tpu/train/loop.py
    keeps it: the log interval that holds the epoch's validation (here made
    to take `pause` seconds) counts that time, rays / (now - last log). The
    sanity validation before the first step is not in any interval."""
    import time

    from satnerf_tpu_torch.train import loop

    pause, every, spe = 1.0, 4, trained["system"].spe

    def slow_validate(*args, **kwargs):
        time.sleep(pause)
        return {}

    monkeypatch.setattr(loop, "validate", slow_validate)
    root = trained["root"]
    out = cli_train.main(_argv(root, trained["data_dir"], trained["gt_dir"],
                               spe + every, "clock"))
    rows = [r for r in _logged(out["cfg"]) if "train/rays_per_sec" in r]
    assert [r["step"] for r in rows] == list(range(every, spe + every + 1, every))
    rays = every * 64  # the interval's steps times the batch
    after = rows[-1]  # steps spe + 1 .. spe + every, after the validation
    assert after["train/rays_per_sec"] <= rays / pause
    # the intervals before the boundary hold no validation: each is faster
    # than the one that does
    assert all(r["train/rays_per_sec"] > after["train/rays_per_sec"]
               for r in rows[:-1])


@pytest.fixture(scope="module")
def jax_checkpoint_run(trained):
    """A run directory whose epoch=1.ckpt the JAX package wrote (msgpack,
    satnerf_tpu.train.checkpoints.save_checkpoint, after two Adam steps),
    beside the port's opts.json of the trained run, at the same toy size.
    Returns (run, checkpoint, JAX system, JAX state)."""
    from satnerf_tpu.train.checkpoints import save_checkpoint
    from tests.test_torch_msgpack_ckpt import jax_trained

    cfg = trained["cfg"]
    run = "jax_written"
    os.makedirs(os.path.join(cfg.logs_dir, run))
    with open(os.path.join(cfg.logs_dir, cfg.exp_name, "opts.json")) as f:
        opts = json.load(f)
    opts["exp_name"] = run
    with open(os.path.join(cfg.logs_dir, run, "opts.json"), "w") as f:
        json.dump(opts, f)
    jsys, state, _ = jax_trained("sat-nerf", 0, fc_layers=4, fc_units=32,
                                 n_samples=8, chunk=512)
    ckpt = os.path.join(cfg.ckpts_dir, run, "epoch=1.ckpt")
    save_checkpoint(ckpt, state)
    with open(ckpt, "rb") as f:
        assert f.read(2) != b"PK"  # not a torch zip archive
    return run, ckpt, jsys, state


@pytest.mark.parametrize("reader", ["load_checkpoint", "load_nerf",
                                    "create_dsm", "eval", "resume"])
def test_jax_checkpoint_is_refused_by_name(trained, jax_checkpoint_run,
                                           reader, capsys):
    """Named for when the port refused them: a msgpack checkpoint of the JAX
    package now loads through every reader of checkpoints (load_checkpoint,
    the loader under cli.eval and cli.create_dsm, both entry points, and
    --ckpt_path of cli.train), and what they serve from it is what the JAX
    package serves from it (float32 on the CPU, 1e-5); a resumed run goes on
    from the JAX step and Adam state."""
    import create_dsm
    import eval as jax_eval
    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.cli.eval import eval_aoi
    from satnerf_tpu_torch.train.checkpoints import load_checkpoint

    cfg, root = trained["cfg"], trained["root"]
    run, ckpt, jsys, jstate = jax_checkpoint_run
    rays = SatelliteScene(cfg.root_dir, None, split="val").load_image(1)["rays"]
    ts = np.full(rays.shape[0], 2, np.int32)
    ref = jsys.render_image(jstate.params, rays, ts)

    def same_render(system, params):
        out = system.render_image(params, rays, ts)
        for k in ("rgb_coarse", "depth_coarse"):
            np.testing.assert_allclose(out[k], ref[k], atol=1e-5, err_msg=k)

    if reader == "load_checkpoint":
        system = trained["system"]
        params = system.init_params()
        optimizer = torch.optim.Adam(params.parameters())
        assert load_checkpoint(ckpt, params, optimizer) == 2
        assert {float(s["step"]) for s in optimizer.state.values()} == {2.0}
        same_render(system, params)
    elif reader == "load_nerf":
        same_render(*load_nerf(run, cfg.logs_dir, cfg.ckpts_dir, 1,
                               device="cpu"))
    elif reader == "create_dsm":
        mae = create_pretty_dsm(run, cfg.logs_dir, str(root / "out_jax"), 1,
                                device="cpu")
        mae_jax = create_dsm.create_pretty_dsm(run, cfg.logs_dir,
                                               str(root / "out_jax_j"), 1)
        assert np.isfinite(mae) and abs(mae - mae_jax) <= 1e-5
    elif reader == "eval":
        got = eval_aoi(run, cfg.logs_dir, str(root / "eval_jax"), 1,
                       device="cpu")
        want = jax_eval.eval_aoi(run, cfg.logs_dir, str(root / "eval_jax_j"),
                                 1)
        for k in ("psnr", "ssim", "mae"):
            assert np.isfinite(got[k])
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    else:
        capsys.readouterr()
        out = cli_train.main(_argv(root, trained["data_dir"], trained["gt_dir"],
                                   4, "from_jax", ["--ckpt_path", ckpt]))
        assert f"resumed from {ckpt} at step 2" in capsys.readouterr().out
        assert out["state"].step == 4
        steps = {float(s["step"]) for s in out["state"].optimizer.state.values()}
        assert steps == {4.0}


FULL = ["--sc_lambda", "0.1", "--ds_lambda", "1000", "--ds_drop", "0.5"]


@pytest.fixture(scope="module")
def trained_full(tmp_path_factory):
    """The paper's full recipe: solar correction and depth supervision on, on
    an AOI with key points; ds_drop 0.5 of 24 steps puts the drop at step 12."""
    root = tmp_path_factory.mktemp("train_full")
    data_dir, gt_dir = make_synthetic_aoi(str(root / "aoi"), size=16,
                                          with_keypoints=True, n_kp=40)
    out = cli_train.main(_argv(root, data_dir, gt_dir, STEPS, "full", FULL))
    return {"root": root, "data_dir": data_dir, "gt_dir": gt_dir, **out}


def test_full_recipe_trains_logs_the_depth_loss_and_checkpoints(trained_full):
    cfg, system = trained_full["cfg"], trained_full["system"]
    assert system.depth and system.render_cfg.solar_correction
    assert system.ds_drop_step == 12 and trained_full["state"].step == STEPS
    assert cfg.sc_lambda == 0.1 and cfg.ds_lambda == 1000.0
    rows = [r for r in _logged(cfg) if "train/loss" in r]
    assert [r["step"] for r in rows] == list(range(4, STEPS + 1, 4))
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["train/loss_depth"])
               for r in rows)
    # depth supervision pulls the depth loss down while it is on: the depth
    # loss over every key point, rendered without jitter, at step 4 and at
    # step 12 (epoch 1, where the term drops out). The steps draw from the
    # run's key, so the run's first twelve replay here step for step: the
    # replay's step 12 is the run's epoch=1.ckpt
    train_ds, depth_ds = load_dataset(cfg, split="train")
    data = {k: torch.from_numpy(np.asarray(v, t)) for k, v, t in (
        ("rays", train_ds.all_rays, np.float32),
        ("rgbs", train_ds.all_rgbs, np.float32),
        ("ts", train_ds.all_ids, np.int64),
        ("d_rays", depth_ds.all_rays, np.float32),
        ("d_depths", depth_ds.all_depths, np.float32),
        ("d_ts", depth_ds.all_ids, np.int64))}
    state, key = system.init_state(cfg.seed), jax_prng.prng_key(cfg.seed + 1)
    for _ in range(4):
        system.train_step(state, data, key)
    at_4 = copy.deepcopy(state.params)
    for _ in range(8):
        system.train_step(state, data, key)
    at_drop = system.init_params(cfg.seed)
    load_checkpoint(os.path.join(cfg.ckpts_dir, cfg.exp_name, "epoch=1.ckpt"),
                    at_drop)
    for name, p in at_drop.state_dict().items():
        assert torch.equal(state.params.state_dict()[name], p), name

    def key_point_loss(params):
        res = system.render_image(params, depth_ds.all_rays, depth_ds.all_ids)
        return float(depth_loss(
            {"depth_coarse": torch.from_numpy(res["depth_coarse"])},
            data["d_depths"][:, 0], data["d_depths"][:, 1], cfg.ds_lambda)[0])

    assert key_point_loss(at_drop) < key_point_loss(at_4)
    run_ckpts = os.path.join(cfg.ckpts_dir, cfg.exp_name)
    assert sorted(os.listdir(run_ckpts)) == ["epoch=1.ckpt", "epoch=2.ckpt"]
    with open(os.path.join(cfg.logs_dir, cfg.exp_name, "opts.json")) as f:
        opts = json.load(f)
    assert opts["sc_lambda"] == 0.1 and opts["ds_lambda"] == 1000.0
    assert all(np.isfinite(v) for v in trained_full["metrics"].values())


def test_full_recipe_resumes_and_is_read_by_the_jax_loader(trained_full, capsys):
    cfg, root = trained_full["cfg"], trained_full["root"]
    ckpt = os.path.join(cfg.ckpts_dir, cfg.exp_name, "epoch=2.ckpt")
    out = cli_train.main(_argv(root, trained_full["data_dir"],
                               trained_full["gt_dir"], RESUMED_STEPS,
                               "full_resumed", FULL + ["--ckpt_path", ckpt]))
    assert f"resumed from {ckpt} at step {STEPS}" in capsys.readouterr().out
    assert out["state"].step == RESUMED_STEPS
    rows = [r for r in _logged(out["cfg"]) if "train/loss" in r]
    assert [r["step"] for r in rows] == [28] and "train/loss_depth" in rows[0]
    # ds_drop_step follows the new max_train_steps: 0.5 * 30 = 15 <= 24
    assert out["system"].ds_drop_step == 15

    jparams = import_torch_checkpoint(ckpt, "sat-nerf", layers=4)
    jcfg = JaxConfig(model="sat-nerf", fc_layers=4, fc_units=32, n_samples=8,
                     chunk=512, fused="off", precision="float32")
    jsys = JaxSystem(jcfg, dataset_len=jcfg.batch_size)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, jparams)
    system, params = load_nerf(cfg.exp_name, cfg.logs_dir, cfg.ckpts_dir, 2,
                               device="cpu")
    sample = SatelliteScene(cfg.root_dir, None, split="val").load_image(1)
    rays = sample["rays"]
    ts = np.full(rays.shape[0], 1, np.int32)
    ref = jsys.render_image(jparams, rays, ts)
    got = system.render_image(params, rays, ts)
    for k in ("rgb_coarse", "depth_coarse"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, err_msg=k)


def test_depth_supervision_without_key_points_fails_at_the_dataset(trained):
    with pytest.raises(FileNotFoundError, match="pts3d.npy"):
        cli_train.main(_argv(trained["root"], trained["data_dir"],
                             trained["gt_dir"], 4, "no", ["--ds_lambda", "1"]))


HIER = FULL + ["--n_importance", "4"]


@pytest.fixture(scope="module")
def trained_hier(trained_full):
    """The full recipe with hierarchical sampling, on the AOI with key
    points: a fine model, four resampled depths a ray. `--fused auto` is the
    plain renderer on the CPU."""
    root = trained_full["root"]
    out = cli_train.main(_argv(root, trained_full["data_dir"],
                               trained_full["gt_dir"], STEPS, "hier", HIER))
    return {**trained_full, **out}


def test_hierarchical_recipe_trains_a_fine_model(trained_hier):
    cfg, system = trained_hier["cfg"], trained_hier["system"]
    assert cfg.n_importance == 4 and system.fused_mode == "off"
    assert system.depth and system.render_cfg.solar_correction
    assert trained_hier["state"].step == STEPS
    rows = [r for r in _logged(cfg) if "train/loss" in r]
    assert [r["step"] for r in rows] == list(range(4, STEPS + 1, 4))
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["train/loss_depth"])
               for r in rows)
    ckpt = torch.load(os.path.join(cfg.ckpts_dir, cfg.exp_name, "epoch=2.ckpt"),
                      weights_only=True)
    names = set(ckpt["state_dict"])
    coarse = {n for n in names if n.startswith("nerf_coarse.")}
    fine = {n for n in names if n.startswith("nerf_fine.")}
    assert fine and {n.replace("nerf_coarse.", "nerf_fine.") for n in coarse} == fine
    # Adam keeps moments for the fine model too
    assert len(ckpt["optimizer_states"][0]["state"]) == len(names)
    # the fine model moved away from the coarse one it was seeded beside
    sd = ckpt["state_dict"]
    assert not torch.equal(sd["nerf_fine.fc_net.0.weight"],
                           sd["nerf_coarse.fc_net.0.weight"])
    assert all(np.isfinite(v) for v in trained_hier["metrics"].values())


def test_hierarchical_run_resumes_and_serves(trained_hier, capsys):
    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.cli.eval import eval_aoi

    cfg, root = trained_hier["cfg"], trained_hier["root"]
    ckpt = os.path.join(cfg.ckpts_dir, cfg.exp_name, "epoch=2.ckpt")
    out = cli_train.main(_argv(root, trained_hier["data_dir"],
                               trained_hier["gt_dir"], RESUMED_STEPS,
                               "hier_resumed", HIER + ["--ckpt_path", ckpt]))
    assert f"resumed from {ckpt} at step {STEPS}" in capsys.readouterr().out
    assert out["state"].step == RESUMED_STEPS
    steps = {float(s["step"]) for s in out["state"].optimizer.state.values()}
    assert steps == {float(RESUMED_STEPS)}
    mae = create_pretty_dsm(cfg.exp_name, cfg.logs_dir, str(root / "out_hier"),
                            2, device="cpu")
    assert np.isfinite(mae)
    assert glob.glob(os.path.join(root, "out_hier", cfg.exp_name,
                                  "*_dsm_epoch2.tif"))
    got = eval_aoi(cfg.exp_name, cfg.logs_dir, str(root / "eval_hier"), 2,
                   device="cpu")
    assert all(np.isfinite(v) for v in got.values())


def test_jax_package_serves_the_hierarchical_checkpoint(trained_hier):
    """The JAX package reads the port's run (opts.json and the torch .ckpt
    through import_torch_checkpoint) and renders the same fine image (1e-4)
    and the same DSM (altitude MAE within 1e-2 m)."""
    import create_dsm
    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm

    cfg, root = trained_hier["cfg"], trained_hier["root"]
    ckpt = os.path.join(cfg.ckpts_dir, cfg.exp_name, "epoch=2.ckpt")
    jparams = import_torch_checkpoint(ckpt, "sat-nerf", layers=4)
    assert "fine" in jparams
    jcfg = JaxConfig(model="sat-nerf", fc_layers=4, fc_units=32, n_samples=8,
                     n_importance=4, chunk=512, fused="off",
                     precision="float32")
    jsys = JaxSystem(jcfg, dataset_len=jcfg.batch_size)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, jparams)
    system, params = load_nerf(cfg.exp_name, cfg.logs_dir, cfg.ckpts_dir, 2,
                               device="cpu")
    rays = SatelliteScene(cfg.root_dir, None, split="val").load_image(1)["rays"]
    ts = np.full(rays.shape[0], 1, np.int32)
    ref = jsys.render_image(jparams, rays, ts)
    got = system.render_image(params, rays, ts)
    for k in ("rgb_coarse", "depth_coarse", "rgb_fine", "depth_fine"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, err_msg=k)
    mae = create_pretty_dsm(cfg.exp_name, cfg.logs_dir, str(root / "dsm_t"), 2,
                            device="cpu")
    mae_jax = create_dsm.create_pretty_dsm(cfg.exp_name, cfg.logs_dir,
                                           str(root / "dsm_j"), 2)
    assert np.isfinite(mae) and abs(mae - mae_jax) <= 1e-2


@pytest.mark.parametrize("fused", ["on", "rays"])
def test_fused_on_and_rays_train_on_the_cpu(trained_full, fused):
    """`--fused on` (the plain renderer over the point-mode field) and
    `--fused rays` (the per-ray chains) with a fine model: on the CPU both
    run their plain versions; neither raises any more."""
    out = cli_train.main(_argv(
        trained_full["root"], trained_full["data_dir"], trained_full["gt_dir"],
        8, f"fused_{fused}", HIER + ["--fused", fused]))
    assert out["system"].fused_mode == {"on": "points", "rays": "rays"}[fused]
    assert out["state"].step == 8
    rows = [r for r in _logged(out["cfg"]) if "train/loss" in r]
    assert rows and all(np.isfinite(r["train/loss"]) for r in rows)
    assert all(np.isfinite(v) for v in out["metrics"].values())
