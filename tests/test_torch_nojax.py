"""The port stands on its own files: in a fresh interpreter, import every
module of the port, take two CPU train steps and a render, then three steps
of the full recipe (solar correction and depth supervision, with grad_accum
and with shuffle) and the classic NeRF variant's three kinds of step, then
read a checkpoint the JAX package wrote, build a synthetic AOI with
transients and RPC noise, run the solar study and load the capability tool,
run the DSM oracle of cli.dsm_diagnostics, load the convergence tool and a
JAX initial checkpoint (equal to the port's own draw of its seed), shard
rays as a rank of two does, load the parity tool, render as a world of one
through the render group, run the bench and list the bench matrix's rows,
import every other entry point, and look at sys.modules. No jax, jaxlib, flax or optax, no module of the
JAX package satnerf_tpu, and neither msgpack nor matplotlib (the machine
with the card has neither) may have been loaded."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib
import os
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
assert "satnerf_tpu_torch.train.msgpack_ckpt" in names
assert "satnerf_tpu_torch.cli.study_solar_interpolation" in names
assert "satnerf_tpu_torch.utils.colormap" in names
for name in ("study_depth_supervision", "dsm_diagnostics", "eval_s2p",
             "create_satellite_dataset"):
    assert f"satnerf_tpu_torch.cli.{name}" in names, name
for name in ("parallel.distributed", "parallel.mesh", "utils.jax_prng",
             "ops.jax_draws"):
    assert f"satnerf_tpu_torch.{name}" in names, name

from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.train.system import NeRFSystem
from satnerf_tpu_torch.utils import jax_prng

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
    state = system.init_state(0)
    gen = jax_prng.prng_key(1)
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
    state = system.init_state(0)
    full = {**data, **depth, "perm": system.epoch_perm(64, 0)}
    gen = jax_prng.prng_key(1)
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
    state = system.init_state(0)
    nerf_data = {**data, **depth, "rays": data["rays"][:, :8].contiguous(),
                 "d_rays": depth["d_rays"][:, :8].contiguous()}
    gen = jax_prng.prng_key(1)
    for _ in range(2):
        m = system.train_step(state, nerf_data, gen)
    assert state.step == 2 and np.isfinite(float(m["loss_total"])), extra
    out = system.render_image(state.params, rays[:7, :8], None)
    typ = "fine" if "n_importance" in extra else "coarse"
    assert np.isfinite(out[f"depth_{typ}"]).all(), extra
print("NERF OK")

# a checkpoint the JAX package wrote, through the port's msgpack reader;
# the synthetic AOI with its newer options; the solar study on a port
# checkpoint (its depth montage through the port's viridis table); the
# capability tool's module
import importlib.util
import tempfile
from satnerf_tpu_torch.cli.study_solar_interpolation import sun_interp
from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi
from satnerf_tpu_torch.train.checkpoints import (load_checkpoint,
                                                 save_checkpoint)
cfg = Config(model="sat-nerf", fc_layers=4, fc_units=32, n_samples=8,
             device="cpu", fused="rays")
system = NeRFSystem(cfg)
state = system.init_state()
assert load_checkpoint("tests/data/jax_satnerf_4x32.ckpt", state.params,
                       state.optimizer) == 2
out = system.render_image(state.params, rays[:7], np.zeros(7, np.int32))
assert np.isfinite(out["rgb_coarse"]).all()
tmp = tempfile.mkdtemp()
data_dir, gt_dir = make_synthetic_aoi(tmp + "/aoi", size=8, n_train=2,
                                      n_test=1, shading=True,
                                      transient_frac=1.0, rpc_noise_px=1.0)
cfg = Config(exp_name="study", root_dir=data_dir, gt_dir=gt_dir,
             logs_dir=tmp + "/logs", ckpts_dir=tmp + "/ckpts", model="s-nerf",
             fc_layers=4, fc_units=16, n_samples=8, device="cpu")
cfg.dump()
system = NeRFSystem(cfg)
save_checkpoint(tmp + "/ckpts/study/epoch=1.ckpt", system.init_params())
sun_interp("study", tmp + "/logs", tmp + "/out", 1, n_interp=2, device="cpu")
assert os.path.exists(tmp + "/out/study/summary/depth_v1.png")
spec = importlib.util.spec_from_file_location(
    "capability_tool", "tools/run_capability_experiments_torch.py")
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
assert set(tool.experiment_table(tool.PRESETS["smoke"])) == {
    "shadow", "solar", "transient", "ba"}
print("M5 M2 OK")

# the remaining entry points on the AOI above (no model), the convergence
# tool's module, and the JAX initial checkpoints under tests/data
import contextlib
import io
from satnerf_tpu_torch.cli import dsm_diagnostics
from satnerf_tpu_torch.train.checkpoints import jax_init_path
with contextlib.redirect_stdout(io.StringIO()):
    mae = dsm_diagnostics.main(["oracle", "--root_dir", data_dir, "--gt_dir",
                                gt_dir, "--samples", "32", "--out_dir",
                                tmp + "/oracle"])
assert np.isfinite(mae)
spec = importlib.util.spec_from_file_location(
    "convergence_tool", "tools/convergence_torch.py")
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
assert tool.run_config("full")["fc_units"] == 64
state = NeRFSystem(Config(model="sat-nerf", fc_units=64, precision="float32",
                          device="cpu")).init_state()
assert load_checkpoint(jax_init_path("tests/data", "sat-nerf", 8, 64, 2),
                       state.params, state.optimizer) == 0
print("M6 M4 OK")

# R4: the port's own seed-2 draw is the JAX package's, as the fixture holds
# it; M7's shards; M8's tool loads
own = NeRFSystem(Config(model="sat-nerf", fc_units=64, precision="float32",
                        device="cpu")).init_params(2)
for k, v in own.state_dict().items():
    assert torch.equal(v, state.params.state_dict()[k]), k
from satnerf_tpu_torch.parallel.distributed import world
from satnerf_tpu_torch.parallel.mesh import shard_rays
assert world() == 1
assert shard_rays(np.arange(5), world=2, rank=1)[1][0].tolist() == [3, 4, 0]
spec = importlib.util.spec_from_file_location(
    "parity_tool", "tools/parity_report_torch.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("R4 M7 M8 OK")

# M9: the collective render as a world of one (gloo) is the render without
# a group
import socket
from satnerf_tpu_torch.parallel import distributed as D
with socket.socket() as sock:
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
system = NeRFSystem(Config(model="sat-nerf", fc_layers=4, fc_units=16,
                           n_samples=8, chunk=5, device="cpu", fused="rays"))
params = system.init_params(0)
ts7 = np.zeros(7, np.int32)
plain = system.render_image(params, rays[:7], ts7)
os.environ.update(SATNERF_COORDINATOR=f"localhost:{port}",
                  SATNERF_NUM_PROCS="1", SATNERF_PROC_ID="0")
one = D.run_in_group(system.render_image, (params, rays[:7], ts7), 1, "cpu")
for k in D.ENV:
    os.environ.pop(k)
assert D.render_world() == 1 and not D.is_distributed()
assert all(np.array_equal(plain[k], one[k]) for k in plain)
print("M9 OK")

# the bench at this script's size (its size constants set), as
# `python -m satnerf_tpu_torch.cli.bench` runs it, and the matrix's --list
import contextlib
import io
import json
import runpy
from satnerf_tpu_torch.cli import bench as B
(B.FEAT, B.SAMPLES, B.N_RAYS, B.TRAIN_BATCH, B.SERVE_BATCH, B.STEPS,
 B.CHUNK) = 32, 16, 64, 64, 64, 2, 64
os.environ["BENCH_DEVICE"] = "cpu"
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    line = B.main()
assert json.loads(buf.getvalue()) == line and line["vs_baseline"] is None
buf = io.StringIO()
sys.argv = ["tools/bench_matrix_torch.py", "--list"]
with contextlib.redirect_stdout(buf):
    try:
        runpy.run_path("tools/bench_matrix_torch.py", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
assert "train_default_b1024" in buf.getvalue()
print("BENCH OK")

loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "satnerf_tpu", "msgpack",
                                       "matplotlib"))
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
    assert "M5 M2 OK" in proc.stdout
    assert "M6 M4 OK" in proc.stdout
    assert "R4 M7 M8 OK" in proc.stdout
    assert "M9 OK" in proc.stdout
    assert "BENCH OK" in proc.stdout
