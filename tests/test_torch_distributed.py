"""Training across devices through the port (ROADMAP M7), on the CPU: gloo
process groups of satnerf_tpu_torch/parallel/, sat-nerf 4 x 32, 16 samples,
batch 64, float32.

- Two ranks (tests/torch_dist_worker.py, started by `parallel.spawn`) take
  three steps on their shards with injected draws: they end with bit-equal
  parameters, within 1e-6 of one process stepping on the two ranks'
  half-batches concatenated (the same rays and depths, injected), which
  tests/test_torch_train_step.py holds against the JAX step; a batch the
  world does not divide is refused on each rank.
- Two `cli.train` processes launched with the JAX package's SATNERF_*
  variables: only rank 0 writes logs, opts.json and checkpoints.
- A world of one through SATNERF_COORDINATOR equals the same tree's `fit`
  without a process group, bit for bit (weights, Adam state, metrics).
- Each rank's rows are what satnerf_tpu.parallel.mesh.shard_rays puts on
  each device of a 2-device CPU mesh, padding included.
- A rank that fails, before it joins or mid-run, ends `spawn` within
  seconds, its children ended.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from satnerf_tpu.parallel.mesh import make_mesh  # noqa: E402
from satnerf_tpu.parallel.mesh import shard_rays as jax_shard_rays  # noqa: E402
from satnerf_tpu_torch.config import Config  # noqa: E402
from satnerf_tpu_torch.parallel import distributed as D  # noqa: E402
from satnerf_tpu_torch.parallel.mesh import shard_rays  # noqa: E402
from satnerf_tpu_torch.train.checkpoints import load_checkpoint  # noqa: E402
from satnerf_tpu_torch.train.system import NeRFSystem  # noqa: E402
from tests import torch_dist_worker as W  # noqa: E402

torch.set_num_threads(1)

N_ROWS, STEPS = 203, 3  # an odd row count: the last rank's block is padded


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks"))
    D.spawn(W.run, (out, N_ROWS, STEPS), 2)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
            for r in range(2)]


def test_ranks_end_bit_equal(two_ranks):
    a, b = two_ranks
    assert a["world"] == b["world"] == 2
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert a["losses"] == b["losses"] and np.isfinite(a["losses"]).all()


def test_ranks_step_as_one_process_on_both_half_batches(two_ranks):
    """One process, no group, the whole batch of 64: rank 0's 32 rays then
    rank 1's, at their rows of the padded set, with their depths."""
    system = NeRFSystem(Config(**W.KW), device="cpu", dataset_len=N_ROWS)
    assert system.world == 1
    _, (rays, rgbs, ts) = shard_rays(*W.dataset(N_ROWS), world=2, rank=0)
    _, (rays1, rgbs1, ts1) = shard_rays(*W.dataset(N_ROWS), world=2, rank=1)
    data = {"rays": torch.from_numpy(np.concatenate([rays, rays1])),
            "rgbs": torch.from_numpy(np.concatenate([rgbs, rgbs1])),
            "ts": torch.from_numpy(np.concatenate([ts, ts1]))}
    state = system.init_state(0)
    per, losses = rays.shape[0], []
    for step in range(STEPS):
        halves = [W.draws(r, step, per, 32, 16) for r in range(2)]
        idx = torch.cat([halves[0][0], halves[1][0] + per])
        z = torch.cat([halves[0][1], halves[1][1]])
        m = system.train_step(state, data, idx=idx, z_vals=z)
        losses.append(float(m["loss"]))
    got = two_ranks[0]["params"]
    for k, v in state.params.state_dict().items():
        assert float((got[k] - v).abs().max()) <= 1e-6, k
    np.testing.assert_allclose(two_ranks[0]["losses"], losses, rtol=1e-6,
                               atol=1e-7)


def test_a_batch_that_does_not_divide_is_refused(two_ranks):
    for r in two_ranks:
        assert "batch_size 63 must divide across 2 devices" in r["refused"]
    # one process takes it
    NeRFSystem(Config(**{**W.KW, "batch_size": 63}), device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi

    root = tmp_path_factory.mktemp("aoi")
    return make_synthetic_aoi(str(root / "aoi"), size=16)


def _argv(data_dir, gt_dir, logs, ckpts, steps=3, extra=()):
    return ["--root_dir", data_dir, "--gt_dir", gt_dir, "--model", "sat-nerf",
            "--exp_name", "dist", "--device", "cpu", "--batch_size", "64",
            "--fc_units", "32", "--fc_layers", "4", "--n_samples", "16",
            "--max_train_steps", str(steps), "--log_every_n_steps", "1",
            "--save_every_n_epochs", "1", "--lr", "1e-3", "--chunk", "512",
            "--num_sanity_val_steps", "1", "--logs_dir", logs,
            "--ckpts_dir", ckpts, *extra]


def test_only_rank_zero_writes(aoi, tmp_path):
    """Two `cli.train` processes joined by the SATNERF_* variables, each
    with directories of its own: rank 1's stay empty."""
    data_dir, gt_dir = aoi
    env = {**os.environ, "SATNERF_COORDINATOR": f"localhost:{_free_port()}",
           "SATNERF_NUM_PROCS": "2", "PYTHONPATH": REPO}
    procs = []
    for r in range(2):
        logs, ckpts = str(tmp_path / f"logs{r}"), str(tmp_path / f"ckpts{r}")
        cmd = [sys.executable, "-m", "satnerf_tpu_torch.cli.train",
               *_argv(data_dir, gt_dir, logs, ckpts)]
        procs.append(subprocess.Popen(
            cmd, env={**env, "SATNERF_PROC_ID": str(r)}, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    run = os.listdir(tmp_path / "logs0")
    assert len(run) == 1
    assert {"opts.json", "metrics.jsonl"} <= set(
        os.listdir(tmp_path / "logs0" / run[0]))
    assert os.listdir(tmp_path / "ckpts0" / run[0]) == ["epoch=0.ckpt"]
    assert not os.path.exists(tmp_path / "logs1") or \
        not os.listdir(tmp_path / "logs1")
    assert not os.path.exists(tmp_path / "ckpts1")
    assert "step 3/3" in outs[0] and "step 3/3" not in outs[1]


def test_a_world_of_one_is_the_run_without_a_group(aoi, tmp_path,
                                                   monkeypatch):
    from satnerf_tpu_torch.cli import train as cli_train

    data_dir, gt_dir = aoi
    runs, reduced = [], []
    all_reduce_mean = D.all_reduce_mean
    monkeypatch.setattr(D, "all_reduce_mean",
                        lambda ts: (reduced.append(1), all_reduce_mean(ts)))
    for tag, env in (("plain", {}),
                     ("group", {"SATNERF_COORDINATOR":
                                f"localhost:{_free_port()}",
                                "SATNERF_NUM_PROCS": "1",
                                "SATNERF_PROC_ID": "0"})):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        out = cli_train.main(_argv(
            data_dir, gt_dir, str(tmp_path / tag / "logs"),
            str(tmp_path / tag / "ckpts"), steps=4,
            extra=("--noise_std", "1.0")))
        assert not D.is_distributed()  # fit left its group
        runs.append(out)
        # two all-reduces a step in the group (gradients, metrics), none
        # without it
        assert len(reduced) == (8 if env else 0)
        reduced.clear()
        for k in env:
            monkeypatch.delenv(k)
    (a, b) = runs
    assert a["system"].world == b["system"].world == 1
    assert a["state"].step == b["state"].step == 4
    for (k, v), w in zip(a["state"].params.state_dict().items(),
                         b["state"].params.state_dict().values()):
        assert torch.equal(v, w), k
    sa, sb = (r["state"].optimizer.state_dict()["state"] for r in runs)
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a["metrics"] == b["metrics"]
    # the checkpoint rank 0 wrote loads as the run's state
    cfg = b["cfg"]
    params = b["system"].init_params()
    load_checkpoint(os.path.join(cfg.ckpts_dir, cfg.exp_name,
                                 "epoch=0.ckpt"), params)
    for k, v in params.state_dict().items():
        assert torch.equal(v, b["state"].params.state_dict()[k]), k


@pytest.mark.parametrize("n_rows", [8, 11])
def test_rows_are_the_jax_mesh_shards(n_rows):
    mesh = make_mesh(2)
    rng = np.random.RandomState(n_rows)
    arrays = (rng.rand(n_rows, 11).astype(np.float32),
              rng.rand(n_rows, 3).astype(np.float32),
              rng.randint(0, 9, n_rows).astype(np.int32))
    padded, placed = jax_shard_rays(mesh, *arrays)
    for r, device in enumerate(mesh.devices.ravel()):
        got_padded, blocks = shard_rays(*arrays, world=2, rank=r)
        assert got_padded == padded == n_rows + n_rows % 2
        for block, arr in zip(blocks, placed):
            shard = next(s for s in arr.addressable_shards
                         if s.device == device)
            want = np.asarray(jax.device_get(shard.data))
            assert block.dtype == want.dtype
            np.testing.assert_array_equal(block, want)


@pytest.mark.parametrize("who,before_join", [(1, False), (0, False),
                                             (1, True)])
def test_a_rank_that_fails_ends_the_run(who, before_join, monkeypatch):
    """Rank `who` raises while the other waits: in an all-reduce (gloo's
    fails once a child's process has ended; a rank 0 that raised ends the
    child) or in the join, which rank 0 waits on for JOIN_TIMEOUT, here
    cut to 3 s. The mid-run cases keep the default: their ranks must all
    join first, which a child slow to start may take longer than 3 s to."""
    import datetime
    import multiprocessing

    if before_join:
        monkeypatch.setattr(D, "JOIN_TIMEOUT", datetime.timedelta(seconds=3))
    t0 = time.monotonic()
    try:
        with pytest.raises(Exception) as err:
            D.spawn(W.fail, (who, before_join), 2)
    finally:
        D.destroy()  # rank 0 leaves a group it raised in as it stands
    assert time.monotonic() - t0 < 60
    if who == 0:
        assert str(err.value) == "rank 0 fails"
    else:
        assert "rank(s) [1] of 2 failed too" in getattr(err.value,
                                                       "__notes__", [])
    assert not multiprocessing.active_children()
