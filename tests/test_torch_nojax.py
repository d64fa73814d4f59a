"""The port loads no jax or flax: import every module of the slice and run a
tiny CPU render in a fresh interpreter, then look at sys.modules."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)

import satnerf_tpu_torch
import satnerf_tpu_torch.cli.create_dsm
import satnerf_tpu_torch.cli.eval
import satnerf_tpu_torch.eval
import satnerf_tpu_torch.eval.loader
import satnerf_tpu_torch.models.nerf
import satnerf_tpu_torch.ops._build
import satnerf_tpu_torch.ops.fused_mlp
import satnerf_tpu_torch.render
import satnerf_tpu_torch.train.checkpoints
import satnerf_tpu_torch.train.system
# the shared host modules the port imports from satnerf_tpu
import satnerf_tpu.config, satnerf_tpu.data.satellite, satnerf_tpu.utils.sort
import satnerf_tpu.ops.ssim, satnerf_tpu.ops.dsm_raster
import satnerf_tpu.ops.dsm_registration, satnerf_tpu.native
import satnerf_tpu.utils.flops, satnerf_tpu.eval.val_ts
from satnerf_tpu.config import Config
from satnerf_tpu_torch.train.system import NeRFSystem

for model in ("sat-nerf", "s-nerf", "nerf"):
    cfg = Config(model=model, fc_layers=8, fc_units=16, n_samples=8, chunk=5)
    system = NeRFSystem(cfg, device="cpu")
    params = system.init_params(torch.Generator().manual_seed(0))
    rays = np.random.RandomState(0).rand(7, 11).astype(np.float32)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    out = system.render_image(params, rays, np.zeros(7, np.int32))
    assert out["rgb_coarse"].shape == (7, 3), model
    assert np.isfinite(out["depth_coarse"]).all(), model

loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
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
