"""The serving slice end to end on the CPU: the port's NeRFSystem and
create_pretty_dsm against the JAX package's, with the same weights on a
32 x 32 synthetic AOI (8 x 32 sat-nerf, 16 samples, f32, JAX --fused off).
The port's system renders in rays mode (the per-ray products); its entry
points read `fused: off` from opts.json and render through the plain
renderer."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from satnerf_tpu.config import Config
from satnerf_tpu.data.satellite import SatelliteScene
from satnerf_tpu.train.system import NeRFSystem as JaxSystem
from satnerf_tpu_torch.train.checkpoints import (checkpoint_path,
                                                 params_from_jax,
                                                 save_checkpoint)
from satnerf_tpu_torch.train.system import NeRFSystem
from satnerf_tpu_torch.utils import jax_prng

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = "slice"
ATOL = 1e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Synthetic AOI, opts.json, JAX params, and a port .ckpt written from
    them through the weight bridge."""
    root = tmp_path_factory.mktemp("slice")
    aoi = str(root / "aoi")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synthetic_aoi.py"),
                    aoi, "--size", "32"], check=True, cwd=REPO, env=env,
                   timeout=300, stdout=subprocess.DEVNULL)
    cfg = Config(root_dir=os.path.join(aoi, "data"),
                 gt_dir=os.path.join(aoi, "gt"),
                 logs_dir=str(root / "logs"), ckpts_dir=str(root / "ckpts"),
                 exp_name=RUN, model="sat-nerf", fc_layers=8, fc_units=32,
                 n_samples=16, chunk=1024, fused="off", precision="float32")
    cfg.dump()
    jsys = JaxSystem(cfg, dataset_len=cfg.batch_size)
    jparams = jsys.init_params(jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, jax.device_get(jparams))

    system = NeRFSystem(dataclasses.replace(cfg, fused="rays"), device="cpu")
    params = system.init_params()
    params.load_state_dict(params_from_jax(params_np, cfg.model, cfg.fc_layers))
    save_checkpoint(checkpoint_path(cfg.ckpts_dir, RUN, 1), params)
    return {"cfg": cfg, "root": root, "jsys": jsys, "jparams": jparams,
            "system": system, "params": params}


def test_render_image_matches_jax(run):
    cfg = run["cfg"]
    ds = SatelliteScene(cfg.root_dir, None, split="val")
    sample = ds.load_image(0)
    rays = sample["rays"]
    ts = np.full(rays.shape[0], 1, np.int32)
    ref = run["jsys"].render_image(run["jparams"], rays, ts)
    out = run["system"].render_image(run["params"], rays, ts)

    n = rays.shape[0]
    assert out["weights_coarse"].shape == (n, 1)
    w = ref["weights_coarse"]
    assert w.shape == (n, cfg.n_samples)
    for k in ("rgb", "depth"):
        np.testing.assert_allclose(out[f"{k}_coarse"], ref[f"{k}_coarse"],
                                   atol=ATOL, err_msg=k)
    for k in ("sun", "albedo", "sky", "beta"):
        got = out[f"{k}_coarse"]
        assert got.shape[:2] == (n, 1)
        np.testing.assert_allclose(
            got[:, 0], (w[..., None] * ref[f"{k}_coarse"]).sum(-2), atol=ATOL,
            err_msg=k)
    np.testing.assert_allclose(out["opacity_coarse"], w.sum(-1), atol=ATOL)


def test_create_pretty_dsm_matches_jax(run):
    import create_dsm
    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm

    cfg, root = run["cfg"], run["root"]
    mae = create_pretty_dsm(RUN, cfg.logs_dir, str(root / "out_torch"), 1,
                            device="cpu")
    # the JAX loader reads the port's torch .ckpt (import_torch_checkpoint)
    mae_jax = create_dsm.create_pretty_dsm(RUN, cfg.logs_dir,
                                           str(root / "out_jax"), 1)
    assert np.isfinite(mae) and np.isfinite(mae_jax)
    assert abs(mae - mae_jax) <= 1e-2
    dsm = [f for f in os.listdir(root / "out_torch" / RUN)
           if f.endswith("_dsm_epoch1.tif")]
    assert len(dsm) == 1


def test_eval_aoi_matches_jax(run):
    import eval as jax_eval
    from satnerf_tpu_torch.cli.eval import eval_aoi

    cfg, root = run["cfg"], run["root"]
    got = eval_aoi(RUN, cfg.logs_dir, str(root / "eval_torch"), 1,
                   device="cpu")
    ref = jax_eval.eval_aoi(RUN, cfg.logs_dir, str(root / "eval_jax"), 1)
    assert all(np.isfinite(v) for v in got.values())
    assert abs(got["psnr"] - ref["psnr"]) <= 1e-3
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-3
    assert abs(got["mae"] - ref["mae"]) <= 1e-2


def test_create_dsm_cli_entry_point(run):
    cfg, root = run["cfg"], run["root"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    proc = subprocess.run(
        [sys.executable, "-m", "satnerf_tpu_torch.cli.create_dsm",
         "--run_id", RUN, "--logs_dir", cfg.logs_dir,
         "--output_dir", str(root / "out_cli"), "--epoch_number", "1",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Altitude MAE:" in proc.stdout


def test_precision_and_card_only_limits():
    """--precision auto: bf16 operands for the card, f32 on the CPU; every
    variant has its kernels, so no configuration is refused for the card
    (nothing is allocated on a device here)."""
    assert NeRFSystem(Config(), "cpu").compute_dtype == torch.float32
    assert NeRFSystem(Config(), "cuda").compute_dtype == torch.bfloat16
    assert (NeRFSystem(Config(precision="bfloat16"), "cpu").compute_dtype
            == torch.bfloat16)
    assert (NeRFSystem(Config(precision="float32"), "cuda").compute_dtype
            == torch.float32)
    assert NeRFSystem(Config(model="nerf"), "cpu").fused_mode == "off"
    assert NeRFSystem(Config(n_importance=8), "cuda").fused_mode == "rays"
    on_card = NeRFSystem(Config(model="nerf"), "cuda")
    assert on_card.fused_mode == "points" and on_card.is_nerf
    assert on_card.compute_dtype == torch.bfloat16
    assert not hasattr(on_card, "_check_supported")


def test_unported_paths_raise(run):
    """Nothing is left that raises for want of a kernel: the nerf variant,
    which used to, takes a training step, and the hierarchical path renders
    a fine model."""
    rays = np.zeros((4, 11), np.float32)
    rays[:, 7] = 1.0
    rays[:, 5] = rays[:, 10] = 1.0
    nerf = NeRFSystem(Config(**{**run["cfg"].__dict__, "model": "nerf",
                                "fused": "on", "batch_size": 4}), device="cpu")
    state = nerf.init_state(0)
    data = {"rays": torch.from_numpy(rays), "rgbs": torch.rand(4, 3),
            "ts": torch.zeros(4, dtype=torch.long)}
    m = nerf.train_step(state, data, jax_prng.prng_key(1))
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    for fused, n_w in (("rays", 1), ("off", 16 + 8)):
        cfg = Config(**{**run["cfg"].__dict__, "n_importance": 8,
                        "fused": fused})
        system = NeRFSystem(cfg, device="cpu")
        out = system.render_image(
            system.init_params(0), rays, None)
        assert out["rgb_fine"].shape == (4, 3)
        assert out["weights_fine"].shape == (4, n_w)
        assert np.isfinite(out["depth_fine"]).all()


@pytest.fixture(scope="module")
def run_hier(run, tmp_path_factory):
    """The same AOI with a fine model: JAX params {coarse, fine, t} through
    params_from_jax into a port .ckpt, 16 + 8 samples."""
    root = tmp_path_factory.mktemp("slice_hier")
    cfg = dataclasses.replace(run["cfg"], n_importance=8,
                              logs_dir=str(root / "logs"),
                              ckpts_dir=str(root / "ckpts"))
    cfg.dump()
    jsys = JaxSystem(cfg, dataset_len=cfg.batch_size)
    jparams = jsys.init_params(jax.random.PRNGKey(1))
    params_np = jax.tree_util.tree_map(np.asarray, jax.device_get(jparams))
    assert set(params_np) == {"coarse", "fine", "t"}
    system = NeRFSystem(dataclasses.replace(cfg, fused="rays"), device="cpu")
    params = system.init_params()
    params.load_state_dict(params_from_jax(params_np, cfg.model, cfg.fc_layers))
    save_checkpoint(checkpoint_path(cfg.ckpts_dir, RUN, 1), params)
    return {"cfg": cfg, "root": root, "jsys": jsys, "jparams": jparams,
            "system": system, "params": params}


def test_hierarchical_render_image_matches_jax(run_hier):
    """The two-launch serving dispatch (coarse products with weights, the
    deterministic resampling, the fine products) against the JAX plain
    render of the same weights."""
    cfg = run_hier["cfg"]
    rays = SatelliteScene(cfg.root_dir, None, split="val").load_image(0)["rays"]
    ts = np.full(rays.shape[0], 1, np.int32)
    ref = run_hier["jsys"].render_image(run_hier["jparams"], rays, ts)
    out = run_hier["system"].render_image(run_hier["params"], rays, ts)
    n = rays.shape[0]
    assert out["weights_fine"].shape == (n, 1)
    w = ref["weights_fine"]
    assert w.shape == (n, cfg.n_samples + cfg.n_importance)
    for typ in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(out[f"{k}_{typ}"], ref[f"{k}_{typ}"],
                                       atol=ATOL, err_msg=f"{k}_{typ}")
    for k in ("sun", "albedo", "sky", "beta"):
        np.testing.assert_allclose(
            out[f"{k}_fine"][:, 0], (w[..., None] * ref[f"{k}_fine"]).sum(-2),
            atol=ATOL, err_msg=k)
    np.testing.assert_allclose(out["opacity_fine"], w.sum(-1), atol=ATOL)


def test_hierarchical_dsm_and_eval_match_jax(run_hier):
    import create_dsm
    import eval as jax_eval
    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.cli.eval import eval_aoi

    cfg, root = run_hier["cfg"], run_hier["root"]
    mae = create_pretty_dsm(RUN, cfg.logs_dir, str(root / "out_torch"), 1,
                            device="cpu")
    mae_jax = create_dsm.create_pretty_dsm(RUN, cfg.logs_dir,
                                           str(root / "out_jax"), 1)
    assert np.isfinite(mae) and abs(mae - mae_jax) <= 1e-2
    got = eval_aoi(RUN, cfg.logs_dir, str(root / "eval_torch"), 1,
                   device="cpu")
    ref = jax_eval.eval_aoi(RUN, cfg.logs_dir, str(root / "eval_jax"), 1)
    assert abs(got["psnr"] - ref["psnr"]) <= 1e-3
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-3
    assert abs(got["mae"] - ref["mae"]) <= 1e-2
