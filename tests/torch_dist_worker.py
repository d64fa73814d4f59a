"""A rank of the 2-process gloo groups of tests/test_torch_distributed.py
and tests/test_torch_render_group.py.

`run(out_dir, n_rows, steps)` joins the group from the SATNERF_* variables
(parallel/distributed.py), checks that a batch the world does not divide is
refused, then takes `steps` train steps of sat-nerf 4 x 32 (16 samples,
batch 64: 32 rays a rank) on its shard of a seeded ray set with injected
ray indices and depths, and saves its parameters and the draws it was given.

`render_group(out_dir, cases, run)` renders each case through the
collective `render_image`, recording the rows each chunk gave this rank,
then trains `run` with `fit` (validation on both ranks, the rows each rank
rendered counted) and serves it through every eval entry point, each rank
writing into its own directory where the entry point takes one.
"""

import contextlib
import os
import pickle

import numpy as np
import torch

from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.parallel import distributed as D
from satnerf_tpu_torch.parallel.mesh import shard_rays
from satnerf_tpu_torch.train.system import NeRFSystem

KW = dict(model="sat-nerf", fc_layers=4, fc_units=32, n_samples=16,
          batch_size=64, precision="float32", fused="off", noise_std=0.0,
          first_beta_epoch=1, lr=1e-3, max_train_steps=30, device="cpu")


def dataset(n_rows: int):
    """Seeded rays (n, 11), colours (n, 3), image ids (n,)."""
    rng = np.random.RandomState(0)
    rays = rng.rand(n_rows, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 8:11] /= np.linalg.norm(rays[:, 8:11], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    rgbs = rng.rand(n_rows, 3).astype(np.float32)
    ts = rng.randint(0, 5, n_rows).astype(np.int64)
    return rays, rgbs, ts


def draws(rank: int, step: int, n_local: int, batch: int, samples: int):
    """Rank `rank`'s injected draws at `step`: local ray indices and sorted
    depths in [0, 1)."""
    rng = np.random.RandomState(1000 * rank + step)
    idx = rng.randint(0, n_local, batch)
    z = np.sort(rng.rand(batch, samples).astype(np.float32), axis=1)
    return torch.from_numpy(idx), torch.from_numpy(z)


def run(out_dir: str, n_rows: int, steps: int) -> None:
    torch.set_num_threads(1)
    world = D.maybe_init_distributed("cpu")
    rank = D.rank()
    try:
        NeRFSystem(Config(**{**KW, "batch_size": 63}), device="cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    system = NeRFSystem(Config(**KW), device="cpu", dataset_len=n_rows)
    _, (rays, rgbs, ts) = shard_rays(*dataset(n_rows), world=world,
                                     rank=rank)
    data = {"rays": torch.from_numpy(rays), "rgbs": torch.from_numpy(rgbs),
            "ts": torch.from_numpy(ts)}
    state = system.init_state(0)
    losses = []
    for step in range(steps):
        idx, z = draws(rank, step, rays.shape[0], 64 // world, 16)
        m = system.train_step(state, data, idx=idx, z_vals=z)
        losses.append(float(m["loss"]))
    torch.save({"params": state.params.state_dict(), "losses": losses,
                "refused": refused, "world": world},
               os.path.join(out_dir, f"rank{rank}.pt"))
    D.destroy()


def fail(who: int, before_join: bool) -> None:
    """A rank of a group in which rank `who` raises, before it joins or
    while the others wait in an all-reduce; rank 0 leaves the group it
    raised in as it is, as a rank that fails mid-run does."""
    me = int(os.environ["SATNERF_PROC_ID"])
    if me == who and before_join:
        raise RuntimeError(f"rank {me} fails before it joins")
    D.maybe_init_distributed("cpu")
    if me == who:
        raise RuntimeError(f"rank {me} fails")
    while True:  # waits on the rank that failed
        D.all_reduce_mean([torch.ones(4)])


def _recording(system, seen: list):
    """Make system.render_chunk record the (rays, ts) it is given."""
    chunk = system.render_chunk

    def render_chunk(params, rays, ts):
        seen.append((rays.numpy().copy(),
                     None if ts is None else ts.numpy().copy()))
        return chunk(params, rays, ts)

    system.render_chunk = render_chunk


def render_group(out_dir: str, cases: dict, run: dict) -> None:
    """cases: name -> (Config kwargs, state_dict, rays, ts); run: the
    arguments of the trained run's entry points (see
    tests/test_torch_render_group.py)."""
    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.cli.eval import eval_aoi
    from satnerf_tpu_torch.cli.study_solar_interpolation import sun_interp
    from satnerf_tpu_torch.train.loop import fit
    from tools import parity_report_torch

    torch.set_num_threads(1)
    D.maybe_init_distributed("cpu")
    r = D.rank()
    got = {"world": D.world(), "render_world": D.render_world(),
           "render_rank": D.render_rank()}
    for name, (kw, state, rays, ts) in cases.items():
        system = NeRFSystem(Config(**kw), device="cpu")
        params = system.init_params()
        params.load_state_dict(state)
        seen = []
        _recording(system, seen)
        got[name] = {"out": system.render_image(params, rays, ts),
                     "rows": seen}

    # fit: every rank of the render group validates; count the rows
    rows = []
    chunk = NeRFSystem.render_chunk
    NeRFSystem.render_chunk = lambda self, p, rr, tt: (
        rows.append(rr.shape[0]), chunk(self, p, rr, tt))[1]
    try:
        got["fit_metrics"] = fit(Config(**run["cfg"]))["metrics"]
    finally:
        NeRFSystem.render_chunk = chunk
    got["fit_rows"] = rows

    # the entry points on the run, rank r writing under out/rank{r} where
    # the entry point takes a directory; what each rank prints
    out = os.path.join(out_dir, f"rank{r}")
    stdout = os.path.join(out_dir, f"stdout{r}.txt")
    with open(stdout, "w") as f, contextlib.redirect_stdout(f):
        kw = dict(checkpoints_dir=run["ckpts"], device="cpu")
        got["eval"] = eval_aoi(run["id"], run["logs"], os.path.join(out, "eval"),
                               run["epoch"], **kw)
        got["dsm"] = create_pretty_dsm(run["id"], run["logs"],
                                       os.path.join(out, "dsm"), run["epoch"],
                                       **kw)
        sun_interp(run["id"], run["logs"], os.path.join(out, "solar"),
                   run["epoch"], n_interp=2, **kw)
        got["parity"] = parity_report_torch.main(run["parity_argv"])
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(got, f)
    D.destroy()
