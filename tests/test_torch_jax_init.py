"""The JAX package's initial checkpoints under tests/data, which the port's
runs can start from (`--ckpt_path`; `--init_dir` of
tools/run_capability_experiments_torch.py and tools/convergence_torch.py).

Each file is what the JAX `fit` starts from at its configuration:
`NeRFSystem(cfg).init_state(jax.random.PRNGKey(cfg.seed))`
(satnerf_tpu/train/loop.py:171), written by
satnerf_tpu.train.checkpoints.save_checkpoint at step 0. The card has no
JAX, so they are committed:

- s-nerf and nerf 8 x 96 at seeds 0 and 1: the capability experiments'
  full preset (the shadow experiment trains both, the solar one s-nerf);
- sat-nerf 8 x 64 at seeds 0, 1 and 2: CONVERGENCE_r05.json's config.

The JAX package rebuilds each one bit for bit, the port loads each one as
the JAX initial state (weights, zero Adam moments, step 0), and a
configuration with no file is refused by name.
`python tests/test_torch_jax_init.py` writes them anew.
"""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from satnerf_tpu.config import Config as JaxConfig  # noqa: E402
from satnerf_tpu.train.checkpoints import save_checkpoint  # noqa: E402
from satnerf_tpu.train.system import NeRFSystem as JaxSystem  # noqa: E402
from satnerf_tpu_torch.config import Config  # noqa: E402
from satnerf_tpu_torch.train.checkpoints import (jax_init_name,  # noqa: E402
                                                 jax_init_path,
                                                 load_checkpoint,
                                                 params_from_jax)
from satnerf_tpu_torch.train.system import NeRFSystem  # noqa: E402

torch.set_num_threads(1)

FIXTURE_DIR = os.path.join(REPO, "tests", "data")
# (model, layers, units, seed)
CAPABILITY = [(m, 8, 96, s) for m in ("s-nerf", "nerf") for s in (0, 1)]
CONVERGENCE = [("sat-nerf", 8, 64, s) for s in (0, 1, 2)]
FIXTURES = CAPABILITY + CONVERGENCE


def _jax_system(model, layers, units, seed):
    cfg = JaxConfig(model=model, fc_layers=layers, fc_units=units, seed=seed,
                    precision="float32", fused="off")
    return JaxSystem(cfg, dataset_len=cfg.batch_size)


@functools.lru_cache(maxsize=None)
def jax_init_state(model, layers, units, seed):
    """What the JAX `fit` starts from at this configuration."""
    system = _jax_system(model, layers, units, seed)
    return system.init_state(jax.random.PRNGKey(seed))


def build_jax_init(model, layers, units, seed, directory=FIXTURE_DIR) -> str:
    """Write the JAX initial checkpoint of one configuration into
    `directory`; returns its path."""
    path = os.path.join(directory, jax_init_name(model, layers, units, seed))
    save_checkpoint(path, jax_init_state(model, layers, units, seed))
    return path


def build_jax_init_fixtures(directory=FIXTURE_DIR) -> list:
    """Write every fixture of FIXTURES; returns the paths."""
    os.makedirs(directory, exist_ok=True)
    return [build_jax_init(*spec, directory=directory) for spec in FIXTURES]


def _id(spec):
    return jax_init_name(*spec)[len("jax_init_"):-len(".ckpt")]


@pytest.mark.parametrize("spec", FIXTURES, ids=_id)
def test_jax_package_rebuilds_the_fixture(spec, tmp_path):
    committed = jax_init_path(FIXTURE_DIR, *spec)
    rebuilt = build_jax_init(*spec, directory=str(tmp_path))
    with open(committed, "rb") as a, open(rebuilt, "rb") as b:
        assert a.read() == b.read()


def test_fixture_sizes():
    sizes = {spec: os.path.getsize(jax_init_path(FIXTURE_DIR, *spec))
             for spec in FIXTURES}
    assert all(n < 1_200_000 for n in sizes.values()), sizes
    assert sum(sizes.values()) < 6_000_000, sizes


@pytest.mark.parametrize("spec", FIXTURES, ids=_id)
def test_port_starts_from_the_fixture(spec):
    model, layers, units, seed = spec
    jax_params = jax.tree_util.tree_map(np.asarray,
                                        jax_init_state(*spec).params)
    cfg = Config(model=model, fc_layers=layers, fc_units=units, seed=seed,
                 precision="float32", fused="off")
    system = NeRFSystem(cfg, device="cpu", dataset_len=cfg.batch_size)
    # the port's own draw first, so that the load has something to replace
    state = system.init_state(torch.Generator().manual_seed(seed))
    step = load_checkpoint(jax_init_path(FIXTURE_DIR, *spec), state.params,
                           state.optimizer)
    assert step == 0
    want = params_from_jax(jax_params, model, layers)
    got = state.params.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    for st in state.optimizer.state.values():
        assert float(st["step"]) == 0.0
        assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()


def test_a_configuration_without_a_fixture_is_refused_by_name():
    with pytest.raises(FileNotFoundError,
                       match=r"looked for .*jax_init_s-nerf_8x96_seed2\.ckpt"):
        jax_init_path(FIXTURE_DIR, "s-nerf", 8, 96, 2)


def test_capability_runs_take_the_fixture_of_their_variant_and_seed():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import run_capability_experiments_torch as cap

    full = cap.PRESETS["full"]
    specs = cap.run_specs(full, ["shadow", "solar"], 1, FIXTURE_DIR)
    got = {spec["name"]: os.path.basename(spec["overrides"]["ckpt_path"])
           for _, _, spec in specs}
    assert got == {"shadow_nerf": "jax_init_nerf_8x96_seed1.ckpt",
                   "shadow_snerf_sc00": "jax_init_s-nerf_8x96_seed1.ckpt",
                   "shadow_snerf_sc05": "jax_init_s-nerf_8x96_seed1.ckpt",
                   "solar_snerf_sc10": "jax_init_s-nerf_8x96_seed1.ckpt"}
    # no fallback to the port's own draw: a missing file stops the tool
    with pytest.raises(FileNotFoundError, match="jax_init_nerf_8x96_seed2"):
        cap.run_specs(full, ["shadow"], 2, FIXTURE_DIR)
    with pytest.raises(FileNotFoundError, match="s-nerf_8x96_seed2"):
        cap.run_specs(full, ["solar"], 2, FIXTURE_DIR)
    with pytest.raises(FileNotFoundError, match="sat-nerf_8x96_seed0"):
        cap.run_specs(full, ["transient"], 0, FIXTURE_DIR)
    with pytest.raises(FileNotFoundError):
        cap.main([os.path.join(REPO, "build", "never"), "--device", "cpu",
                  "--experiments", "ba", "--init_dir", FIXTURE_DIR])
    assert not os.path.exists(os.path.join(REPO, "build", "never"))
    # without --init_dir the runs draw their own weights
    assert all("ckpt_path" not in spec["overrides"]
               for _, _, spec in cap.run_specs(full, ["shadow"], 0))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for path in build_jax_init_fixtures():
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
