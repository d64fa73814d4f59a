"""Checkpoints of the JAX package read by the port
(satnerf_tpu_torch/train/msgpack_ckpt.py, train/checkpoints.py).

For each variant, with and without a fine model, the JAX system takes two
Adam steps (float32 on the CPU, `--fused off`) and writes its checkpoint
with satnerf_tpu.train.checkpoints.save_checkpoint. Then:

- the port's decoder gives what flax.serialization.msgpack_restore gives
  for the same bytes, array for array (dtype, shape and bytes), and the same
  for a bfloat16 copy of the parameters;
- `load_checkpoint` resumes from it: the weights, the Adam moments and count
  and the step are the JAX state's, and one port step from it equals the
  next JAX step from the same state with the same injected draws (loss and
  every parameter within 1e-5);
- an ext type flax does not write, and a type byte msgpack does not use, are
  refused by name.

The committed fixture under tests/data/ (sat-nerf 4 x 32, written by the
JAX package, and the JAX render of a fixed ray batch) is read by both
packages: the JAX package still renders the stored products from it, and so
does the port on the CPU (1e-5). `python tests/test_torch_msgpack_ckpt.py`
writes the fixture anew.
"""

import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from flax import serialization

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from satnerf_tpu.config import Config as JaxConfig  # noqa: E402
from satnerf_tpu.train.checkpoints import save_checkpoint  # noqa: E402
from satnerf_tpu.train.system import NeRFSystem as JaxSystem  # noqa: E402
from satnerf_tpu.train.system import TrainState  # noqa: E402
from satnerf_tpu_torch.config import Config  # noqa: E402
from satnerf_tpu_torch.train.checkpoints import (load_checkpoint,  # noqa: E402
                                                 params_from_jax)
from satnerf_tpu_torch.train.msgpack_ckpt import msgpack_restore  # noqa: E402
from satnerf_tpu_torch.train.system import NeRFSystem  # noqa: E402
from tests.test_torch_render_hier import jax_render_draws  # noqa: E402

torch.set_num_threads(1)

B, N_DATA, LAYERS, FEAT, S = 32, 96, 4, 32, 8
KW = dict(batch_size=B, fc_units=FEAT, fc_layers=LAYERS, n_samples=S,
          max_train_steps=30, first_beta_epoch=1, lr=1e-3, noise_std=0.0)
VARIANTS = ("nerf", "s-nerf", "sat-nerf")
JAX_STEPS = 2

FIXTURE_DIR = os.path.join(REPO, "tests", "data")
FIXTURE_CKPT = os.path.join(FIXTURE_DIR, "jax_satnerf_4x32.ckpt")
FIXTURE_RENDER = os.path.join(FIXTURE_DIR, "jax_satnerf_4x32_render.npz")
# the fixture's configuration: sat-nerf 4 x 32, 32 samples a ray, float32
FIXTURE_CFG = dict(model="sat-nerf", fc_layers=4, fc_units=32, n_samples=32,
                   chunk=1024)
FIXTURE_PRODUCTS = ("rgb", "depth", "sun", "albedo", "beta")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    rays = rng.rand(N_DATA, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 8:11] /= np.linalg.norm(rays[:, 8:11], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    rgbs = rng.rand(N_DATA, 3).astype(np.float32)
    ts = rng.randint(0, 5, N_DATA).astype(np.int32)
    return rays, rgbs, ts


def _batch(step):
    return (np.random.RandomState(100 + step).randint(0, N_DATA, B),
            jax.random.PRNGKey(1000 + step))


def make_jax_step(system):
    """step_fn(params, opt_state, step, data) -> (params, opt_state, loss,
    idx, key): value_and_grad of the XLA path's _loss_and_metrics, then the
    system's optax Adam, on the batch and key of `step`."""
    ts_on = system.use_ts

    @jax.jit
    def value_and_grad(params, rays, rgbs, ts, key, step):
        def loss_fn(p):
            return system._loss_and_metrics(p, rays, rgbs,
                                            ts if ts_on else None, key, step)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    def step_fn(params, opt_state, step, data):
        idx, key = _batch(step)
        rays, rgbs, ts = (jnp.asarray(a[idx]) for a in data)
        (loss, _), grads = value_and_grad(params, rays, rgbs, ts, key,
                                          jnp.asarray(step, jnp.int32))
        updates, opt_state = system.tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, float(loss),
                idx, key)

    return step_fn


def jax_trained(variant, n_imp, steps=JAX_STEPS, **kw):
    """A JAX system of the test size and its TrainState after `steps` Adam
    steps on _data(); returns (system, state, step_fn)."""
    cfg = JaxConfig(model=variant, fused="off", precision="float32",
                    n_importance=n_imp, **{**KW, **kw})
    system = JaxSystem(cfg, dataset_len=N_DATA)
    params = system.init_params(jax.random.PRNGKey(0))
    opt_state = system.tx.init(params)
    step_fn = make_jax_step(system)
    data = _data()
    for step in range(steps):
        params, opt_state, _, _, _ = step_fn(params, opt_state, step, data)
    return system, TrainState(params, opt_state, jnp.asarray(steps, jnp.int32)), \
        step_fn


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """(variant, n_importance) -> (JAX system, state, step_fn, checkpoint)."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    cache = {}

    def get(variant, n_imp):
        if (variant, n_imp) not in cache:
            system, state, step_fn = jax_trained(variant, n_imp)
            path = str(root / f"{variant}_{n_imp}" / "epoch=1.ckpt")
            save_checkpoint(path, state)
            cache[variant, n_imp] = (system, state, step_fn, path)
        return cache[variant, n_imp]

    return get


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_same_arrays(ours, ref):
    ours, ref = _leaves(ours), _leaves(ref)
    assert ours.keys() == ref.keys()
    for name, want in ref.items():
        got = ours[name]
        if not isinstance(want, np.ndarray) and not isinstance(want,
                                                               np.generic):
            assert got == want and type(got) is type(want), name
            continue
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:
            assert torch.is_tensor(got) and got.dtype == torch.bfloat16, name
            got = got.view(torch.int16).numpy()
            want = want.view(np.int16)
        else:
            assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("n_imp", [0, 4])
@pytest.mark.parametrize("variant", VARIANTS)
def test_decoder_matches_flax(jax_ckpts, variant, n_imp):
    _, state, _, path = jax_ckpts(variant, n_imp)
    with open(path, "rb") as f:
        data = f.read()
    _assert_same_arrays(msgpack_restore(data),
                        serialization.msgpack_restore(data))
    assert ("fine" in msgpack_restore(data)["params"]) == (n_imp > 0)
    # a bfloat16 copy of the parameters, with a numpy scalar and a complex
    bf16 = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(ml_dtypes.bfloat16),
        jax.device_get(state.params))
    tree = {"params": bf16, "scalar": np.float32(1.5), "complex": 2 - 3j,
            "step": np.asarray(7)}
    data = serialization.msgpack_serialize(tree)
    _assert_same_arrays(msgpack_restore(data),
                        serialization.msgpack_restore(data))


@pytest.mark.parametrize("n_imp", [0, 4])
@pytest.mark.parametrize("variant", VARIANTS)
def test_resume_takes_the_jax_step(jax_ckpts, variant, n_imp):
    sys_j, state_j, step_fn, path = jax_ckpts(variant, n_imp)
    sys_t = NeRFSystem(Config(model=variant, fused="off", n_importance=n_imp,
                              **KW), device="cpu", dataset_len=N_DATA)
    state = sys_t.init_state(0)
    state.step = load_checkpoint(path, state.params, state.optimizer)
    assert state.step == JAX_STEPS

    # the weights and the Adam state are the JAX state's, through the bridge
    params_j = jax.device_get(state_j.params)
    for name, ref in params_from_jax(params_j, variant, LAYERS).items():
        assert torch.equal(state.params.state_dict()[name], ref), name
    adam = state_j.opt_state[0]
    moments = [params_from_jax(jax.device_get(m), variant, LAYERS)
               for m in (adam.mu, adam.nu)]
    for name, p in state.params.named_parameters():
        st = state.optimizer.state[p]
        assert float(st["step"]) == int(adam.count) == JAX_STEPS
        assert torch.equal(st["exp_avg"], moments[0][name]), name
        assert torch.equal(st["exp_avg_sq"], moments[1][name]), name

    # the next step on both sides, from the same state and draws
    data = _data()
    params_j, _, loss_j, idx, key = step_fn(state_j.params, state_j.opt_state,
                                            JAX_STEPS, data)
    k_render, _ = jax.random.split(key)
    d = jax_render_draws(k_render, data[0][idx], S, max(n_imp, 1), None)
    draws = {"z_vals": d["z_vals"]}
    if n_imp:
        draws["u"] = d["u"]
    t_data = {"rays": torch.from_numpy(data[0]),
              "rgbs": torch.from_numpy(data[1]),
              "ts": torch.from_numpy(data[2]).long()}
    m = sys_t.train_step(state, t_data, idx=torch.from_numpy(idx),
                         **{k: torch.from_numpy(np.array(v))
                            for k, v in draws.items()})
    assert state.step == JAX_STEPS + 1
    np.testing.assert_allclose(float(m["loss"]), loss_j, atol=1e-5)
    want = params_from_jax(jax.device_get(params_j), variant, LAYERS)
    got = state.params.state_dict()
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), atol=1e-5,
                                   err_msg=name)


def test_unknown_types_are_refused_by_name():
    with pytest.raises(ValueError, match="ext type 5 is not one of flax's"):
        msgpack_restore(b"\x81\xa1a\xd4\x05\x00")  # {"a": fixext1 type 5}
    with pytest.raises(ValueError, match="type byte 0xc1"):
        msgpack_restore(b"\x91\xc1")
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(b"\x92\x01")


# ------------------------------------------------------- committed fixture


def fixture_rays(n=512, seed=7):
    """The fixed ray batch the fixture's render is of, and its image ids."""
    rng = np.random.RandomState(seed)
    rays = rng.rand(n, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 8:11] /= np.linalg.norm(rays[:, 8:11], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    return rays, rng.randint(0, 5, n).astype(np.int32)


def render_products(res: dict) -> dict:
    """Per-ray products of a render's results: rgb, depth, and the sun,
    albedo and beta integrated over the samples (the port's fused render
    pre-integrates them over a singleton sample axis of weight 1)."""
    w = res["weights_coarse"][..., None]
    out = {"rgb": res["rgb_coarse"], "depth": res["depth_coarse"]}
    for k in ("sun", "albedo", "beta"):
        out[k] = (w * res[f"{k}_coarse"]).sum(1)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def build_fixture():
    """Write FIXTURE_CKPT (the JAX package's checkpoint of sat-nerf 4 x 32
    after two Adam steps) and FIXTURE_RENDER (its render of fixture_rays)."""
    system, state, _ = jax_trained("sat-nerf", 0, fc_layers=4, fc_units=32,
                                   n_samples=32)
    save_checkpoint(FIXTURE_CKPT, state)
    np.savez(FIXTURE_RENDER, **_jax_render_fixture())
    return system


def _jax_render_fixture():
    from satnerf_tpu.train.checkpoints import load_checkpoint as jax_load

    cfg = JaxConfig(fused="off", precision="float32", **FIXTURE_CFG)
    system = JaxSystem(cfg, dataset_len=cfg.batch_size)
    params, _, step = jax_load(FIXTURE_CKPT,
                               system.init_state(jax.random.PRNGKey(0)))
    rays, ts = fixture_rays()
    return {**render_products(system.render_image(params, rays, ts)),
            "rays": rays, "ts": ts, "step": np.asarray(step)}


def test_jax_package_renders_the_committed_fixture():
    assert os.path.getsize(FIXTURE_CKPT) < 300_000
    stored = np.load(FIXTURE_RENDER)
    now = _jax_render_fixture()
    assert int(stored["step"]) == int(now["step"]) == JAX_STEPS
    np.testing.assert_array_equal(now["rays"], stored["rays"])
    for k in FIXTURE_PRODUCTS:
        np.testing.assert_allclose(now[k], stored[k], atol=1e-6, err_msg=k)


def test_port_renders_the_committed_fixture():
    stored = np.load(FIXTURE_RENDER)
    system = NeRFSystem(Config(precision="float32", fused="rays",
                               **FIXTURE_CFG), device="cpu")
    params = system.init_params()
    assert load_checkpoint(FIXTURE_CKPT, params) == JAX_STEPS
    got = render_products(system.render_image(params, stored["rays"],
                                              stored["ts"]))
    for k in FIXTURE_PRODUCTS:
        np.testing.assert_allclose(got[k], stored[k], atol=1e-5, err_msg=k)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    build_fixture()
    print(f"wrote {FIXTURE_CKPT} and {FIXTURE_RENDER}")
