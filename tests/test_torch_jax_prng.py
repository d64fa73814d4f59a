"""The port draws the JAX package's initial weights (utils/jax_prng.py).

utils/jax_prng.py is JAX's threefry PRNG and flax's per-parameter keys in
numpy; `NeRFSystem.init_params(seed)` draws through it what the JAX
package's `init_params(PRNGKey(seed))` draws (satnerf_tpu/train/system.py:
216-232). Held here to the bit: every primitive against `jax.random` at
several seeds and shapes, the three variants' initial weights (a fine model
or not, seeds 0-3, widths 32 and 96) against the JAX package's through the
weight bridge, and the committed JAX initial checkpoints against the port's
own draw.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from satnerf_tpu.config import Config as JaxConfig  # noqa: E402
from satnerf_tpu.train.system import NeRFSystem as JaxSystem  # noqa: E402
from satnerf_tpu_torch.config import Config  # noqa: E402
from satnerf_tpu_torch.train.checkpoints import (jax_init_path,  # noqa: E402
                                                 load_checkpoint,
                                                 params_from_jax)
from satnerf_tpu_torch.train.system import NeRFSystem  # noqa: E402
from satnerf_tpu_torch.utils import jax_prng as P  # noqa: E402

torch.set_num_threads(1)

SEEDS = (0, 1, 7, 12345, 2**31 + 3)
SHAPES = ((1,), (7,), (3, 5), (30, 4), (97, 64))
FIXTURE_DIR = os.path.join(REPO, "tests", "data")
FIXTURES = [("s-nerf", 8, 96, s) for s in (0, 1)] + \
    [("nerf", 8, 96, s) for s in (0, 1)] + \
    [("sat-nerf", 8, 64, s) for s in (0, 1, 2)]


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in(seed):
    key = P.prng_key(seed)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for n in (2, 3, 4, 9):
        np.testing.assert_array_equal(P.split(key, n),
                                      np.asarray(jax.random.split(jkey, n)))
    for data in (0, 1, 2**31 + 5, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            P.fold_in(key, data),
            np.asarray(jax.random.fold_in(jkey, np.uint32(data))))


def test_threefry_against_jax():
    from jax._src import prng

    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, 2, dtype=np.uint32)
    x = rng.integers(0, 2**32, (2, 37), dtype=np.uint32)
    want = prng.threefry_2x32(k, x.ravel())
    got = np.concatenate(P.threefry_2x32(k[0], k[1], x[0], x[1]))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_and_normal(seed, shape):
    key = P.prng_key(seed)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        P.random_bits(key, shape),
        np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (-0.125, 0.125),
                   (-np.float32(1) / np.sqrt(np.float32(96)),
                    np.float32(1) / np.sqrt(np.float32(96)))):
        np.testing.assert_array_equal(
            _bits(P.uniform(key, shape, lo, hi)),
            _bits(jax.random.uniform(jkey, shape, jnp.float32, lo, hi)))
    np.testing.assert_array_equal(
        _bits(P.normal(key, shape)), _bits(jax.random.normal(jkey, shape)))


def test_erf_inv_against_xla_everywhere():
    """erf_inv on 200,000 points spread over (-1, 1), its tails and edges:
    XLA's polynomial, its log1p and log, to the bit."""
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.uniform(-1, 1, 100_000), 1 - np.exp(rng.uniform(-16, -1, 50_000)),
        -np.exp(rng.uniform(-30, 0, 50_000)),
        [0.0, -1.0, 1.0, np.nextafter(np.float32(-1), np.float32(0))],
    ]).astype(np.float32)
    np.testing.assert_array_equal(_bits(P.erf_inv(x)),
                                  _bits(jax.jit(lax.erf_inv)(x)))


def test_fma32_rounds_once():
    """a * b + c rounded once: against the exact sum in rationals."""
    from fractions import Fraction

    rng = np.random.default_rng(2)
    a, b, c = (rng.standard_normal(2000).astype(np.float32) for _ in range(3))
    c[:500] = -(a[:500] * b[:500])  # cancellation
    got = P.fma32(a, b, c)
    for i in range(0, 2000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        g = Fraction(float(got[i]))
        up = Fraction(float(np.nextafter(got[i], np.float32(np.inf))))
        dn = Fraction(float(np.nextafter(got[i], np.float32(-np.inf))))
        assert abs(g - exact) <= abs(up - exact) and \
            abs(g - exact) <= abs(dn - exact), i


def _jax_params(model, layers, units, n_importance, seed) -> dict:
    cfg = JaxConfig(model=model, fc_layers=layers, fc_units=units,
                    n_samples=8, n_importance=n_importance, seed=seed)
    params = JaxSystem(cfg, dataset_len=64).init_params(
        jax.random.PRNGKey(seed))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params), model,
                           layers)


@pytest.mark.parametrize("model", ("sat-nerf", "s-nerf", "nerf"))
@pytest.mark.parametrize("n_importance", (0, 4))
@pytest.mark.parametrize("units", (32, 96))
def test_init_params_is_the_jax_draw(model, n_importance, units):
    system = NeRFSystem(Config(model=model, fc_layers=8, fc_units=units,
                               n_samples=8, n_importance=n_importance),
                        device="cpu", dataset_len=64)
    for seed in range(4):
        want = _jax_params(model, 8, units, n_importance, seed)
        got = system.init_params(seed).state_dict()
        assert set(got) == set(want)
        assert any(k.startswith("nerf_fine.") for k in got) == \
            (n_importance > 0)
        assert ("embedding_t.weight" in got) == (model == "sat-nerf")
        for k, v in want.items():
            np.testing.assert_array_equal(_bits(got[k].numpy()),
                                          _bits(v.numpy()), err_msg=(seed, k))


def test_seeds_draw_apart():
    system = NeRFSystem(Config(model="sat-nerf", fc_layers=4, fc_units=32),
                        device="cpu", dataset_len=64)
    a, b = system.init_params(0), system.init_params(1)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert not torch.equal(va, vb), k
    assert all(torch.equal(x, y) for x, y in zip(
        a.state_dict().values(), system.init_params(0).state_dict().values()))


@pytest.mark.parametrize("spec", FIXTURES,
                         ids=lambda s: f"{s[0]}_{s[1]}x{s[2]}_seed{s[3]}")
def test_committed_fixtures_are_the_ports_own_draw(spec):
    model, layers, units, seed = spec
    cfg = Config(model=model, fc_layers=layers, fc_units=units, seed=seed,
                 precision="float32", fused="off")
    system = NeRFSystem(cfg, device="cpu", dataset_len=cfg.batch_size)
    own = system.init_state(seed).params.state_dict()
    loaded = system.init_state(seed + 1)
    assert load_checkpoint(jax_init_path(FIXTURE_DIR, *spec), loaded.params,
                           loaded.optimizer) == 0
    for k, v in loaded.params.state_dict().items():
        np.testing.assert_array_equal(_bits(own[k].numpy()),
                                      _bits(v.numpy()), err_msg=k)
