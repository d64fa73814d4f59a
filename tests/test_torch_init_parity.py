"""The port's initial weights follow the JAX package's distributions, tensor
by tensor, for the three variants (a fine model included).

satnerf_tpu/models/nerf.py:35-61 and 150-215 draw each Dense layer's kernel
from U(+-bound) with bound 1/sqrt(fan_in) (torch.nn.Linear's default), or
for the SIREN layers sqrt(6/fan_in), 1/fan_in for the first trunk layer and
sun_v_0; every bias from U(+-1/sqrt(fan_in)); the transient embedding from
N(0, 1). satnerf_tpu_torch/models/nerf.py:41-52 and 140-182 draw from a
torch.Generator instead. The draws cannot agree bit for bit, so each
tensor's values are pooled over many seeds on both sides and held to the
same law: the shape, the bound (no value past it, and the largest near it),
the mean and the standard deviation. The JAX tensors come through the
weight bridge (train/checkpoints.params_from_jax), so each law is checked
under the port's name.
"""

import math
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from satnerf_tpu.config import Config as JaxConfig  # noqa: E402
from satnerf_tpu.train.system import NeRFSystem as JaxSystem  # noqa: E402
from satnerf_tpu_torch.config import Config  # noqa: E402
from satnerf_tpu_torch.train.checkpoints import params_from_jax  # noqa: E402
from satnerf_tpu_torch.train.system import NeRFSystem  # noqa: E402

torch.set_num_threads(1)

# six layers put the skip layer (4) in the trunk; a fine model as well
KW = dict(fc_layers=6, fc_units=32, n_samples=8, n_importance=4,
          precision="float32", fused="off")
SEEDS = 128
VARIANTS = ("nerf", "s-nerf", "sat-nerf")


def _kernel_kind(variant: str, torch_name: str) -> str:
    """The JAX model's kernel init of a layer, by the port's name."""
    siren = variant != "nerf"
    m = re.fullmatch(r"nerf_(?:coarse|fine)\.fc_net\.(\d+)", torch_name)
    if m:
        if not siren:
            return "torch"
        return "siren_first" if m.group(1) == "0" else "siren"
    if siren and torch_name.endswith("sun_v_net.0"):
        return "siren_first"
    if siren and re.search(r"sun_v_net\.[24]$", torch_name):
        return "siren"
    return "torch"


def _laws(variant: str, shapes: dict) -> dict:
    """name -> ("uniform", bound) or ("normal", std) of every tensor."""
    laws = {}
    for key in shapes:
        if key == "embedding_t.weight":
            laws[key] = ("normal", 1.0)
            continue
        layer, what = key.rsplit(".", 1)
        fan_in = shapes[f"{layer}.weight"][1]
        kind = "torch" if what == "bias" else _kernel_kind(variant, layer)
        laws[key] = ("uniform", {"torch": 1.0 / math.sqrt(fan_in),
                                 "siren": math.sqrt(6.0 / fan_in),
                                 "siren_first": 1.0 / fan_in}[kind])
    return laws


def jax_draws(variant: str) -> dict:
    """name -> (SEEDS, *shape) of the JAX initial weights at SEEDS seeds,
    through the weight bridge."""
    system = JaxSystem(JaxConfig(model=variant, **KW), dataset_len=64)
    keys = jax.vmap(jax.random.PRNGKey)(np.arange(SEEDS))
    stacked = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.vmap(system.init_params))(keys))
    per_seed = [params_from_jax(
        jax.tree_util.tree_map(lambda a, i=i: a[i], stacked), variant,
        KW["fc_layers"]) for i in range(SEEDS)]
    return {k: np.stack([sd[k].numpy() for sd in per_seed])
            for k in per_seed[0]}


def port_draws(variant: str) -> dict:
    system = NeRFSystem(Config(model=variant, **KW), device="cpu",
                        dataset_len=64)
    per_seed = [system.init_params(torch.Generator().manual_seed(s))
                .state_dict() for s in range(SEEDS)]
    return {k: np.stack([sd[k].numpy() for sd in per_seed])
            for k in per_seed[0]}


def _hold(values: np.ndarray, law: tuple, where: str):
    kind, scale = law
    x = values.astype(np.float64).ravel()
    n = x.size
    if kind == "uniform":
        std, bound = scale / math.sqrt(3.0), scale
        assert np.abs(x).max() <= bound * (1 + 1e-6), (where, bound)
        # P(max |x| < b (1 - 20 / n)) = (1 - 20 / n)^n < e^-20
        assert np.abs(x).max() >= bound * (1 - 20.0 / n), (where, bound)
        std_se = std * math.sqrt(0.8 / (4 * n))  # uniform: kurtosis 1.8
    else:
        std = scale
        std_se = std / math.sqrt(2 * n)
    assert abs(x.mean()) <= 6 * std / math.sqrt(n), (where, x.mean())
    assert abs(x.std() - std) <= 6 * std_se, (where, x.std(), std)


@pytest.mark.parametrize("variant", VARIANTS)
def test_initial_weights_follow_the_jax_laws(variant):
    jax_w, port_w = jax_draws(variant), port_draws(variant)
    assert {k: v.shape for k, v in port_w.items()} == \
        {k: v.shape for k, v in jax_w.items()}
    laws = _laws(variant, {k: v.shape[1:] for k, v in port_w.items()})
    assert any(k.startswith("nerf_fine.") for k in laws)
    assert ("embedding_t.weight" in laws) == (variant == "sat-nerf")
    for key, law in laws.items():
        _hold(jax_w[key], law, ("jax", key))
        _hold(port_w[key], law, ("port", key))


def test_the_laws_tell_the_kinds_apart():
    """The check can see a wrong kind: each SIREN layer's draws fail it when
    held to either of the other two kernel bounds."""
    draws = port_draws("s-nerf")
    laws = _laws("s-nerf", {k: v.shape[1:] for k, v in draws.items()})
    for key in ("nerf_coarse.fc_net.0.weight", "nerf_coarse.fc_net.2.weight",
                "nerf_coarse.sun_v_net.0.weight",
                "nerf_coarse.sun_v_net.2.weight"):
        fan_in = draws[key].shape[-1]
        _hold(draws[key], laws[key], key)
        for bound in (1.0 / math.sqrt(fan_in), math.sqrt(6.0 / fan_in),
                      1.0 / fan_in):
            if not math.isclose(bound, laws[key][1]):
                with pytest.raises(AssertionError):
                    _hold(draws[key], ("uniform", bound), key)
