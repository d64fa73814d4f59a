"""The port's FLOP model (satnerf_tpu_torch/utils/flops.py): the same counts
as the JAX package's, and a speed of light against the card the port runs
on, the H100, by default."""

import pytest

from satnerf_tpu.utils import flops as jax_flops
from satnerf_tpu_torch.utils import flops


def test_default_peak_is_the_h100s():
    assert flops.H100_PEAK_BF16 == 989e12 and flops.H100_PEAK_F32 == 67e12
    rate = flops.speed_of_light_rays_per_sec("sat-nerf", 8, 512, 64)
    assert rate == pytest.approx(989e12 / flops.flops_per_ray("sat-nerf", 8,
                                                              512, 64))
    assert rate == flops.speed_of_light_rays_per_sec(
        "sat-nerf", 8, 512, 64, peak=flops.H100_PEAK_BF16)


def test_tpu_names_stay_for_importers():
    assert flops.V5E_PEAK_BF16 == jax_flops.V5E_PEAK_BF16
    assert flops.V5E_PEAK_F32 == jax_flops.V5E_PEAK_F32


@pytest.mark.parametrize("model,layers,feat", [("sat-nerf", 8, 512),
                                               ("s-nerf", 8, 512),
                                               ("nerf", 8, 256),
                                               ("sat-nerf", 4, 96)])
@pytest.mark.parametrize("mode,sc,n_importance", [("train", False, 0),
                                                  ("train", True, 64),
                                                  ("render", False, 0)])
def test_counts_match_the_jax_package(model, layers, feat, mode, sc,
                                      n_importance):
    kw = dict(mode=mode, sc=sc, n_importance=n_importance)
    assert flops.flops_per_ray(model, layers, feat, 64, **kw) == \
        jax_flops.flops_per_ray(model, layers, feat, 64, **kw)
