"""The port stands on its own files: in a fresh interpreter, import every
module of the port, take two CPU train steps and a render, then three steps
of the full recipe (solar correction and depth supervision, with grad_accum
and with shuffle) and the classic NeRF variant's three kinds of step, then
look at sys.modules. No jax, jaxlib, flax or optax, and no module of the JAX package
satnerf_tpu, may have been loaded."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib
import pkgutil
import sys
import numpy as np
import torch
torch.set_num_threads(1)

import satnerf_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    satnerf_tpu_torch.__path__, "satnerf_tpu_torch."))
for name in names:
    importlib.import_module(name)
print("IMPORTED", len(names))
assert "satnerf_tpu_torch.cli.train" in names
assert "satnerf_tpu_torch.data.synthetic" in names
assert "satnerf_tpu_torch.data.satellite_depth" in names
assert "satnerf_tpu_torch.data.blender" in names
assert "satnerf_tpu_torch.ops.fused_nerf" in names

from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.train.system import NeRFSystem

rng = np.random.RandomState(0)
rays = rng.rand(64, 11).astype(np.float32)
rays[:, 6], rays[:, 7] = 0.0, 1.0
data = {"rays": torch.from_numpy(rays),
        "rgbs": torch.from_numpy(rng.rand(64, 3).astype(np.float32)),
        "ts": torch.from_numpy(rng.randint(0, 5, 64))}
for model in ("sat-nerf", "s-nerf"):
    cfg = Config(model=model, fc_layers=8, fc_units=16, n_samples=8, chunk=5,
                 batch_size=16, device="cpu")
    system = NeRFSystem(cfg, dataset_len=64)
    state = system.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        m = system.train_step(state, data, gen)
    assert state.step == 2 and np.isfinite(float(m["loss"])), model
    out = system.render_image(state.params, rays[:7], np.zeros(7, np.int32))
    assert out["rgb_coarse"].shape == (7, 3), model
    assert np.isfinite(out["depth_coarse"]).all(), model

# the full recipe: solar correction, depth supervision, two micro-batches
depth = {"d_rays": data["rays"][:20],
         "d_depths": torch.from_numpy(rng.rand(20, 2).astype(np.float32)),
         "d_ts": data["ts"][:20]}
for extra in (dict(grad_accum=2), dict(sampling="shuffle")):
    cfg = Config(model="sat-nerf", fc_layers=8, fc_units=16, n_samples=8,
                 batch_size=16, device="cpu", sc_lambda=0.1, ds_lambda=1000.0,
                 noise_std=1.0, max_train_steps=8, **extra)
    system = NeRFSystem(cfg, dataset_len=64)
    state = system.init_state(torch.Generator().manual_seed(0))
    full = {**data, **depth, "perm": system.epoch_perm(64, 0)}
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        m = system.train_step(state, full, gen)
    assert state.step == 3 and np.isfinite(float(m["loss_total"])), extra
    assert np.isfinite(float(m["loss_depth"])), extra
print("FULL RECIPE OK")

# the classic NeRF variant: the plain step, the hierarchical step and the
# depth-supervised step with a fused mode on, a render, and (N, 8) rays
for extra in (dict(), dict(n_importance=4), dict(ds_lambda=1000.0)):
    cfg = Config(model="nerf", fc_layers=8, fc_units=16, n_samples=8, chunk=5,
                 batch_size=16, device="cpu", fused="on", max_train_steps=8,
                 **extra)
    system = NeRFSystem(cfg, dataset_len=64)
    assert system.fused_mode == "points"
    state = system.init_state(torch.Generator().manual_seed(0))
    nerf_data = {**data, **depth, "rays": data["rays"][:, :8].contiguous(),
                 "d_rays": depth["d_rays"][:, :8].contiguous()}
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        m = system.train_step(state, nerf_data, gen)
    assert state.step == 2 and np.isfinite(float(m["loss_total"])), extra
    out = system.render_image(state.params, rays[:7, :8], None)
    typ = "fine" if "n_importance" in extra else "coarse"
    assert np.isfinite(out[f"depth_{typ}"]).all(), extra
print("NERF OK")

loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "satnerf_tpu"))
print("LOADED", loaded)
assert not loaded, loaded
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    assert "FULL RECIPE OK" in proc.stdout
    assert "NERF OK" in proc.stdout
