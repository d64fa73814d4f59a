"""The port's whole training loop against the JAX package's, through `fit`
on both sides, float32 on the CPU: the BA capability experiment's noba_ds
recipe (tools/run_capability_experiments.py:131-144, its overrides
:154-168) at a small size.

The AOI is the experiment's noisy one (smooth terrain, key points, RPC
noise 2.5 px, altitude bounds from the terrain, view spread 0.25, an 8 px
checker) at 24 px with 4 training views; the model sat-nerf 4 x 32, 8
samples, batch 256, 40 steps, the cosine schedule, lr 5e-4, ds_lambda 1000,
noise_std 0. With 9 steps an epoch the run crosses four epoch boundaries,
the step where the depth term drops out (ds_drop 0.25: step 10) and the
beta switch-on (epoch 2 by the 1-based counter: step 17).

JAX: `satnerf_tpu.train.loop.fit` on one CPU device, the XLA path. The
port: `satnerf_tpu_torch.train.loop.fit` with `--device cpu`. Both start
from the same initial weights (the JAX package's draw) and draw the same
rays, depth rays and depths at every step (the key tree of
satnerf_tpu/train/system.py, utils/jax_prng.py), with replacement and with
`--sampling shuffle`, at seeds 0 and 1. Both log every step; held:

  - the loss, the depth loss and the learning rate at every step, within
    2e-5 relative (measured over the four cases: at most 2.4e-6);
  - every parameter at the end, within 1e-4 of its tensor's largest entry
    (measured: at most 2.6e-6).
The tolerances keep a margin of eight and forty over what was measured:
XLA's CPU code and PyTorch's sum in other orders. On the parent tree's
draws (torch.Generators) the first step's loss was already 1.2e-2 apart.

Seconds, on two cores of this suite's CPU host: the first case 43 s, the
other three 22-23 s each (117 s for the file). The JAX side's compilation
is most of it: its eager initial draw compiles each operation once a
process, then each fit compiles its jitted step and render anew; the port's
fit takes about 3 s.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from satnerf_tpu.config import Config as JaxConfig
from satnerf_tpu.train.loop import fit as jax_fit
from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.data import synthetic
from satnerf_tpu_torch.train.checkpoints import params_from_jax
from satnerf_tpu_torch.train.loop import fit

torch.set_num_threads(2)

STEPS, LAYERS = 40, 4
LOSS_RTOL, PARAM_TOL = 2e-5, 1e-4
# tools/run_capability_experiments.py experiment_table: the ba_noisy AOI
AOI_FLAGS = ["--size", "24", "--n_train", "4", "--n_test", "1",
             "--alt_bounds", "terrain", "--view_spread", "0.25", "--checker",
             "8", "--terrain", "smooth", "--keypoints", "300", "--rpc_noise",
             "2.5"]
# the tool's _phase_train overrides and the noba_ds run's, at a small size
RECIPE = dict(save_every_n_epochs=10 ** 6, val_every_n_epochs=10 ** 6,
              num_sanity_val_steps=0, noise_std=0.0, precision="float32",
              lr_scheduler="cosine", model="sat-nerf", sc_lambda=0.0,
              ds_lambda=1000.0, fc_units=32, fc_layers=LAYERS, n_samples=8,
              batch_size=256, max_train_steps=STEPS, lr=5e-4,
              log_every_n_steps=1, n_devices=1)


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("noisy_aoi"))
    synthetic.main([root, "--seed", "0"] + AOI_FLAGS)
    return root


def _rows(cfg) -> list:
    path = os.path.join(cfg.logs_dir, cfg.exp_name, "metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "train/loss" in r]


@pytest.mark.parametrize("sampling", ["replacement", "shuffle"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fit_follows_the_jax_fit_step_by_step(aoi, tmp_path, seed, sampling):
    runs = {}
    for side, make, train in (("jax", JaxConfig, jax_fit),
                              ("torch", Config, fit)):
        kw = dict(RECIPE, seed=seed, sampling=sampling, exp_name=side,
                  root_dir=os.path.join(aoi, "data"),
                  gt_dir=os.path.join(aoi, "gt"),
                  cache_dir=str(tmp_path / f"cache_{side}"),
                  logs_dir=str(tmp_path / "logs"),
                  ckpts_dir=str(tmp_path / f"ckpts_{side}"))
        if side == "torch":
            kw["device"] = "cpu"
        cfg = make(**kw)
        runs[side] = (train(cfg), _rows(cfg))
    (out_j, rows_j), (out_t, rows_t) = runs["jax"], runs["torch"]
    assert out_t["system"].ds_drop_step == out_j["system"].ds_drop_step == 10
    assert out_t["system"].spe == out_j["system"].spe == 9
    assert [r["step"] for r in rows_t] == [r["step"] for r in rows_j] \
        == list(range(1, STEPS + 1))
    for a, b in zip(rows_j, rows_t):
        for k in ("train/loss", "train/loss_depth", "lr"):
            np.testing.assert_allclose(b[k], a[k], rtol=LOSS_RTOL,
                                       err_msg=f"{k} at step {a['step']}")
    want = params_from_jax(jax.device_get(out_j["state"].params), "sat-nerf",
                           LAYERS)
    got = out_t["state"].params.state_dict()
    assert out_t["state"].step == int(out_j["state"].step) == STEPS
    for name, ref in want.items():
        err = float((got[name] - ref).abs().max())
        assert err <= PARAM_TOL * float(ref.abs().max()), (name, err)
