"""The port's training draws are the JAX package's, bit for bit, on the CPU
(ops/jax_draws.py over utils/jax_prng.py; csrc/jax_draws.cu draws the same
on the card, which chip_smoke.py phase 12 holds against these).

- jax.random's randint, permutation, uniform and normal at several keys and
  shapes: n not a power of two, n past 2^16, a span of 1 and an empty one,
  permutations of one and of two sort rounds.
- A training step's draws against the JAX step's own: the color rays'
  indices, the depth rays' indices, the stratified jitter and depths and the
  sigma noise of both passes, captured inside the JAX package's jitted
  train step (make_train_step on a 2-device CPU mesh, the XLA path) at steps
  0, 1 and the first of the second epoch, on both devices, against
  NeRFSystem.train_step as rank 0 and as rank 1 of a world of two; and with
  --sampling shuffle, the epoch's permutation of each rank's shard.
- A run resumed at step k draws what the uninterrupted run draws from k on.

The depths: the JAX render computes the bin edges near * (1 - t) + far * t
and lower + (upper - lower) * u, whose multiply-adds XLA's CPU code may fuse
into one rounding each; the port rounds every product and sum apart. The
uniforms u are equal to the bit; the depths are held within 1e-6 relative,
a few float32 ulps (seen: 4 ulps at most).

About 46 s here on two cores.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.config import Config as JaxConfig
from satnerf_tpu.parallel.mesh import DATA_AXIS
from satnerf_tpu.parallel.mesh import shard_rays as jax_shard_rays
from satnerf_tpu.train.system import NeRFSystem as JaxSystem
from satnerf_tpu.train.system import TrainState as JaxState
from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.ops import jax_draws as JD
from satnerf_tpu_torch.parallel import distributed as D
from satnerf_tpu_torch.parallel.mesh import shard_rays
from satnerf_tpu_torch.train import system as system_mod
from satnerf_tpu_torch.train.system import NeRFSystem
from satnerf_tpu_torch.utils import jax_prng as P

torch.set_num_threads(1)

SEEDS = (0, 1, 12345, 2**31 + 3)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((7,), 0, 5), ((1000,), 0, 40960), ((3, 5), -3, 1 << 20),
    ((70000,), 0, 2**31 - 1), ((97, 64), 0, 3 * 2**28 + 7),
    ((9,), 5, 6), ((9,), 5, 5), ((50,), -2**31, 2**31 - 1)])
def test_randint_is_jax_randint(seed, shape, lo, hi):
    got = JD.randint(P.prng_key(seed), shape, lo, hi)
    want = np.asarray(jax.random.randint(_jkey(seed), shape, lo, hi))
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,rounds", [(1, 0), (2, 1), (1000, 1), (1625, 1),
                                      (1626, 2), (70001, 2)])
def test_permutation_is_jax_permutation(seed, n, rounds):
    assert P.permutation_rounds(n) == rounds
    got = JD.permutation(P.prng_key(seed), n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.permutation(_jkey(seed), n)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (97, 64), (70001,), (4, 3, 5)])
def test_bits_uniform_and_normal_are_jax_s(seed, shape):
    key, jk = P.prng_key(seed), _jkey(seed)
    np.testing.assert_array_equal(
        JD.bits(key, shape).numpy().view(np.uint32),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (-2.5, 7.0)):
        np.testing.assert_array_equal(
            JD.uniform(key, shape, minval=lo, maxval=hi).numpy().view(
                np.uint32),
            np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo,
                                          hi)).view(np.uint32))
    np.testing.assert_array_equal(
        JD.normal(key, shape).numpy().view(np.uint32),
        np.asarray(jax.random.normal(jk, shape, jnp.float32)).view(np.uint32))


@pytest.mark.parametrize("accum", [1, 3])
@pytest.mark.parametrize("rank", [0, 1])
def test_step_keys_are_the_jax_key_tree_across_blocks(rank, accum):
    """step_keys derives P.STEP_BLOCK steps' keys at once: the steps at both
    sides of a block's edge and far into a run against jax.random's
    fold_in and split."""
    key, jk = P.prng_key(5), _jkey(5)
    for step in (0, P.STEP_BLOCK - 1, P.STEP_BLOCK, 7 * P.STEP_BLOCK + 3,
                 2**31 + 1):
        k = jax.random.fold_in(jax.random.fold_in(jk, rank), step)
        subs = [k] if accum == 1 else list(jax.random.split(k, accum))
        want = [np.asarray(jax.random.split(s, 3)) for s in subs]
        got = P.step_keys(key, rank, step, accum)
        assert len(got) == accum
        for g, w in zip(got, want):
            assert all(x.dtype == np.uint32 for x in g)
            np.testing.assert_array_equal(np.stack(g), w, err_msg=str(step))


def test_a_draw_that_is_needed_and_has_no_key_is_refused():
    system = NeRFSystem(Config(**KW), device="cpu", dataset_len=N_DATA)
    rays, rgbs, ts = (torch.from_numpy(a) for a in _data()[:3])
    with pytest.raises(ValueError, match="z_vals is neither injected"):
        system.loss_and_grads(system.init_params(0), rays[:B], rgbs[:B],
                              ts[:B].long(), 0)


# ---------------------------------------------------------------- the step

B, N_DATA, N_DEPTH, S = 32, 203, 61, 8  # odd counts: rank 1's block is padded
KW = dict(model="sat-nerf", batch_size=B, fc_units=32, fc_layers=4,
          n_samples=S, max_train_steps=30, lr=1e-3, ds_lambda=1000.0,
          noise_std=1.0, seed=3)


def _data():
    rng = np.random.RandomState(0)
    rays = rng.rand(N_DATA, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.5, 2.0 + rng.rand(N_DATA)
    rgbs = rng.rand(N_DATA, 3).astype(np.float32)
    ts = rng.randint(0, 5, N_DATA).astype(np.int32)
    d_rays = rays[rng.randint(0, N_DATA, N_DEPTH)].copy()
    d_depths = rng.rand(N_DEPTH, 2).astype(np.float32)
    d_ts = rng.randint(0, 5, N_DEPTH).astype(np.int32)
    return rays, rgbs, ts, d_rays, d_depths, d_ts


class _Recorder:
    """Tags the draws of a step: (name, call number). A draw made inside
    another (jax.random.normal draws through jax.random.uniform) is the
    outer draw's and gets no tag; the depths ("z") are tagged beside the
    uniform they are made from."""

    def __init__(self):
        self.counts = {}
        self.busy = False

    def tag(self, name):
        n = self.counts.get(name, 0)
        self.counts[name] = n + 1
        return name, n


def _jax_draws(steps, sampling, monkeypatch):
    """{(step, device): {(name, k): array}} from the JAX package's jitted
    step on a 2-device mesh: its randint, uniform and normal calls and its
    stratified depths, captured by jax.debug.callback as they run."""
    rec = _Recorder()
    got = {}
    current = {}

    def record(tag, axis, value):
        got.setdefault((current["step"], int(axis)), {})[tag] = \
            np.asarray(value)

    def wrap(name, fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            if rec.busy:
                return fn(*a, **kw)
            rec.busy = name != "z"  # the depths are made from a draw
            try:
                out = fn(*a, **kw)
            finally:
                rec.busy = False
            jax.debug.callback(functools.partial(record, rec.tag(name)),
                               jax.lax.axis_index(DATA_AXIS), out)
            return out
        return inner

    import satnerf_tpu.render.render as jax_render

    cfg = JaxConfig(**{**KW, "fused": "off", "n_devices": 2,
                       "sampling": sampling})
    system = JaxSystem(cfg, dataset_len=N_DATA, depth_dataset_len=N_DEPTH)
    # drawn before the wraps; host copies, since the step donates its state
    params = jax.device_get(system.init_params(jax.random.PRNGKey(0)))
    for name in ("randint", "uniform", "normal"):
        monkeypatch.setattr(jax.random, name,
                            wrap(name, getattr(jax.random, name)))
    monkeypatch.setattr(jax_render, "stratified_zvals",
                        wrap("z", jax_render.stratified_zvals))
    rays, rgbs, ts, d_rays, d_depths, d_ts = _data()
    mesh = system.mesh
    _, (r, c, t) = jax_shard_rays(mesh, rays, rgbs, ts)
    _, (dr, dd, dt) = jax_shard_rays(mesh, d_rays, d_depths, d_ts)
    data = {"rays": r, "rgbs": c, "ts": t, "d_rays": dr, "d_depths": dd,
            "d_ts": dt}
    step_fn = system.make_train_step()
    perm_fn = system.make_epoch_perm() if sampling == "shuffle" else None
    perms = {}
    for step in steps:
        current["step"] = step
        if perm_fn is not None:
            epoch = step // system.spe
            data["perm"] = perm_fn(
                r, jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 2), epoch))
            perms[epoch] = np.asarray(data["perm"])
        fresh = jax.tree_util.tree_map(jnp.asarray, params)
        state = JaxState(fresh, system.tx.init(fresh),
                         jnp.asarray(step, jnp.int32))
        step_fn(state, data, jax.random.PRNGKey(cfg.seed + 1))
        jax.effects_barrier()
    # the tags count traces too, and JAX traces some bodies more than once;
    # the draws that ran, in their order, are numbered afresh
    for draws in got.values():
        tags = sorted(draws, key=lambda t: t[1])
        renamed = {}
        for name, _ in tags:
            renamed[(name, sum(n == name for n, _ in renamed))] = \
                draws[(name, _)]
        draws.clear()
        draws.update(renamed)
    return got, system.spe, perms


def _port_draws(steps, sampling, rank, monkeypatch):
    """{step: {(name, k): array}} from NeRFSystem.train_step as rank `rank`
    of a world of two (its shard of the data; no process group: the step's
    all-reduce is the group's, not its draws). The state starts at
    steps[0], as a resumed one does, and jumps only where `steps` does."""
    rec = _Recorder()
    got = {}
    current = {}

    def wrap(name, fn):
        def inner(*a, **kw):
            if rec.busy:
                return fn(*a, **kw)
            rec.busy = name != "z"  # the depths are made from a draw
            try:
                out = fn(*a, **kw)
            finally:
                rec.busy = False
            got.setdefault(current["step"], {})[rec.tag(name)] = \
                out.numpy().copy()
            return out
        return inner

    with monkeypatch.context() as m:
        for name in ("randint", "uniform", "normal"):
            m.setattr(JD, name, wrap(name, getattr(JD, name)))
        m.setattr(system_mod, "stratified_zvals",
                  wrap("z", system_mod.stratified_zvals))
        m.setattr(D, "rank", lambda: rank)
        m.setattr(D, "world", lambda: 2)
        system = NeRFSystem(Config(**{**KW, "sampling": sampling}),
                            device="cpu", dataset_len=N_DATA)
        assert (system.rank, system.world) == (rank, 2)
        rays, rgbs, ts, d_rays, d_depths, d_ts = _data()
        _, (r, c, t) = shard_rays(rays, rgbs, ts, world=2, rank=rank)
        _, (dr, dd, dt) = shard_rays(d_rays, d_depths, d_ts, world=2,
                                     rank=rank)
        data = {"rays": torch.from_numpy(r), "rgbs": torch.from_numpy(c),
                "ts": torch.from_numpy(t).long(),
                "d_rays": torch.from_numpy(dr),
                "d_depths": torch.from_numpy(dd),
                "d_ts": torch.from_numpy(dt).long()}
        state = system.init_state(0)
        key = P.prng_key(KW["seed"] + 1)
        perms = {}
        for step in steps:
            current["step"] = step
            rec.counts.clear()
            if sampling == "shuffle":
                epoch = step // system.spe
                data["perm"] = system.epoch_perm(r.shape[0], epoch)
                perms[epoch] = data["perm"].numpy()
            if state.step != step:
                state.step = step
            system.train_step(state, data, key)
    return got, system.spe, perms


@pytest.mark.parametrize("sampling", ["replacement", "shuffle"])
def test_a_step_draws_what_the_jax_step_draws_on_each_rank(
        eight_devices, monkeypatch, sampling):
    spe = N_DATA // B
    steps = (0, 1, spe)
    with monkeypatch.context() as mp:
        want, spe_j, perms_j = _jax_draws(steps, sampling, mp)
    assert spe_j == spe
    for rank in (0, 1):
        got, spe_t, perms_t = _port_draws(steps, sampling, rank, monkeypatch)
        assert spe_t == spe
        for epoch, perm in perms_t.items():
            half = perms_j[epoch].shape[0] // 2
            np.testing.assert_array_equal(
                perm, perms_j[epoch][rank * half:(rank + 1) * half])
        for step in steps:
            ours, theirs = got[step], want[(step, rank)]
            assert ours.keys() == theirs.keys()
            # idx then d_idx; with shuffle the color rays are read from the
            # permutation and d_idx is the one randint
            n_rand = 1 if sampling == "shuffle" else 2
            assert {k for k in ours if k[0] == "randint"} == {
                ("randint", k) for k in range(n_rand)}
            for k in range(n_rand):
                np.testing.assert_array_equal(
                    ours[("randint", k)], theirs[("randint", k)],
                    err_msg=f"randint {k} at step {step} rank {rank}")
            for k in range(2):  # color then depth: u, noise, z
                for name in ("uniform", "normal"):
                    np.testing.assert_array_equal(
                        ours[(name, k)].view(np.uint32),
                        theirs[(name, k)].reshape(
                            ours[(name, k)].shape).view(np.uint32),
                        err_msg=f"{name} {k} at step {step} rank {rank}")
                np.testing.assert_allclose(
                    ours[("z", k)], theirs[("z", k)], rtol=1e-6, atol=0,
                    err_msg=f"z {k} at step {step} rank {rank}")


def test_a_resumed_run_draws_what_the_uninterrupted_run_draws(monkeypatch):
    whole, _, _ = _port_draws((0, 1, 2, 3, 4), "replacement", 0, monkeypatch)
    resumed, _, _ = _port_draws((3, 4), "replacement", 0, monkeypatch)
    for step in (3, 4):
        assert whole[step].keys() == resumed[step].keys()
        for k, v in whole[step].items():
            np.testing.assert_array_equal(resumed[step][k], v, err_msg=str(k))
    assert not np.array_equal(whole[3][("randint", 0)],
                              whole[4][("randint", 0)])
