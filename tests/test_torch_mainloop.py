"""Which mainloop siren_dense and siren_dense_dgrad take on the card, and the
`mainloop=` keyword on the CPU.

`dense_mainloop` is the rule of the two kernels' C entries
(csrc/fused_render.cu, csrc/fused_train.cu) in Python; the wrappers call it
to build the mainloop argument they pass, and count each launch under its
answer in MAINLOOP_LAUNCHES. Every shape the main path gives the two kernels
(K, N in {256, 512}, bf16, tensors from torch.empty) must take wgmma; the
capability presets' width 96 keeps wmma; an operand whose pointer is not a
multiple of 16 bytes keeps off wgmma. On the CPU the wrappers run their
plain versions whatever mainloop is asked for, and refuse a name they do not
know. The card's side of the same rule is held in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from satnerf_tpu_torch.ops import fused_mlp as FM

BF16, F32 = torch.bfloat16, torch.float32

# (kernel, dtype, K, N, inputs aligned, outputs aligned, mainloop)
RULE = [
    # the main path, sat-nerf 8 x 512: siren_dense (K -> N) ...
    ("siren_dense", BF16, 512, 512, True, True, "wgmma"),  # trunk, skip, feats
    ("siren_dense", BF16, 512, 256, True, True, "wgmma"),  # rgb_0, sun_v_0, beta_0
    ("siren_dense", BF16, 256, 256, True, True, "wgmma"),  # sun_v_1, sun_v_2
    ("siren_dense", BF16, 0, 512, True, True, "k0"),       # layer 0
    ("siren_dense", BF16, 0, 256, True, True, "k0"),       # sky_0
    # ... and siren_dense_dgrad (K = dX's columns, N = the reduction)
    ("siren_dense_dgrad", BF16, 512, 256, True, True, "wgmma"),  # rgb_0 ...
    ("siren_dense_dgrad", BF16, 256, 256, True, True, "wgmma"),  # sun_v_2, _1
    ("siren_dense_dgrad", BF16, 512, 512, True, True, "wgmma"),  # feats, trunk
    # fp32 stays exact on SIMT FMAs
    ("siren_dense", F32, 512, 512, True, True, "simt"),
    ("siren_dense", F32, 0, 512, True, True, "k0"),
    ("siren_dense_dgrad", F32, 512, 512, True, True, "simt"),
    # the capability presets' width 96 (heads 48): not a multiple of 64
    ("siren_dense", BF16, 96, 96, True, True, "wmma"),
    ("siren_dense", BF16, 96, 48, True, True, "wmma"),
    ("siren_dense_dgrad", BF16, 96, 96, True, True, "wmma"),
    ("siren_dense_dgrad", BF16, 96, 48, True, True, "wmma"),
    # a multiple of 64 on one side only
    ("siren_dense", BF16, 512, 200, True, True, "wmma"),
    ("siren_dense_dgrad", BF16, 320, 512, True, True, "wgmma"),
    ("siren_dense", BF16, 320, 192, True, True, "wgmma"),
    ("siren_dense_dgrad", BF16, 40, 512, True, True, "wmma"),
    # siren_dense's W slice must fit shared memory; the dgrad streams W
    ("siren_dense", BF16, 1024, 512, True, True, "wmma"),
    ("siren_dense_dgrad", BF16, 1024, 512, True, True, "wgmma"),
    # shapes no tensor-core mainloop takes
    ("siren_dense", BF16, 36, 100, True, True, "simt"),
    ("siren_dense_dgrad", BF16, 36, 100, True, True, "simt"),
    # pointers: an unaligned weight (an input of both) goes to SIMT, as
    # before; an unaligned Y / slope / dX keeps the wmma path
    ("siren_dense", BF16, 512, 512, False, True, "simt"),
    ("siren_dense", BF16, 512, 512, True, False, "wmma"),
    ("siren_dense_dgrad", BF16, 512, 512, False, True, "simt"),
    ("siren_dense_dgrad", BF16, 512, 512, True, False, "wmma"),
]


@pytest.mark.parametrize("kernel,dtype,k,n,ins,outs,want", RULE)
def test_rule(kernel, dtype, k, n, ins, outs, want):
    got = FM.dense_mainloop(kernel, dtype, k, n, inputs_aligned=ins,
                            outputs_aligned=outs)
    assert got == want
    if want in FM.MAINLOOPS:  # asking for what the rule gives is the same
        assert FM.dense_mainloop(kernel, dtype, k, n, inputs_aligned=ins,
                                 outputs_aligned=outs, mainloop=want) == want


@pytest.mark.parametrize("kernel,dtype,k,n,ins,outs,mainloop", [
    ("siren_dense", BF16, 96, 96, True, True, "wgmma"),
    ("siren_dense", BF16, 512, 512, True, False, "wgmma"),
    ("siren_dense", BF16, 0, 512, True, True, "wgmma"),
    ("siren_dense", BF16, 0, 512, True, True, "wmma"),
    ("siren_dense", F32, 512, 512, True, True, "wmma"),
    ("siren_dense", BF16, 36, 100, True, True, "wmma"),
    ("siren_dense_dgrad", BF16, 512, 512, True, False, "wgmma"),
    ("siren_dense_dgrad", BF16, 512, 512, False, True, "wmma"),
    ("siren_dense_dgrad", F32, 512, 512, True, True, "wgmma"),
])
def test_a_mainloop_that_cannot_run_is_refused(kernel, dtype, k, n, ins, outs,
                                               mainloop):
    with pytest.raises(ValueError):
        FM.dense_mainloop(kernel, dtype, k, n, inputs_aligned=ins,
                          outputs_aligned=outs, mainloop=mainloop)


def test_unknown_names_are_refused():
    with pytest.raises(ValueError):
        FM.dense_mainloop("siren_dense", BF16, 512, 512, mainloop="tma")
    with pytest.raises(ValueError):
        FM.dense_mainloop("siren_dense_wgrad", BF16, 512, 512)


def _dense_inputs(k, n, seed=0):
    rng = np.random.default_rng(seed)
    n_rays, samples = 5, 4
    rays16 = torch.from_numpy(rng.uniform(-0.5, 0.5, (n_rays, 16))).float()
    z = torch.from_numpy(np.sort(rng.uniform(0, 1, (n_rays, samples)), 1)).float()
    p = n_rays * samples
    x = torch.from_numpy(rng.uniform(-1, 1, (p, k))).float()
    w = torch.from_numpy(rng.normal(0, k ** -0.5, (k, n))).float()
    b = torch.from_numpy(rng.normal(0, 1, n)).float()
    c = torch.from_numpy(rng.normal(0, 0.3, (3, n))).float()
    return (x, w, b, rays16, samples), dict(extra="xyz", extra_weight=c, z=z)


@pytest.mark.parametrize("mainloop", ["wgmma", "wmma", None])
@pytest.mark.parametrize("k,n", [(64, 64), (36, 20)])
def test_cpu_runs_the_plain_version_whatever_mainloop(mainloop, k, n):
    args, kw = _dense_inputs(k, n)
    launches, by_loop = dict(FM.LAUNCHES), dict(FM.MAINLOOP_LAUNCHES)
    y, slope = FM.siren_dense(*args, save=True, mainloop=mainloop, **kw)
    ref, ref_slope = FM.siren_dense_reference(*args, save=True, **kw)
    assert torch.equal(y, ref) and torch.equal(slope, ref_slope)
    rng = np.random.default_rng(1)
    dy = torch.from_numpy(rng.normal(0, 1, (20, n))).float()
    sl = torch.from_numpy(rng.normal(0, 1, (20, n))).float()
    w = args[1]
    out = torch.from_numpy(rng.normal(0, 1, (20, k))).float()
    got = FM.siren_dense_dgrad(dy, sl, w, out=out.clone(), mainloop=mainloop)
    assert torch.equal(got, FM.siren_dense_dgrad_reference(dy, sl, w,
                                                           out=out.clone()))
    # nothing was launched, so nothing was counted
    assert FM.LAUNCHES == launches and FM.MAINLOOP_LAUNCHES == by_loop


def test_cpu_refuses_an_unknown_mainloop():
    args, kw = _dense_inputs(64, 64)
    with pytest.raises(ValueError):
        FM.siren_dense(*args, mainloop="tma", **kw)
    dy = torch.zeros(20, 64)
    with pytest.raises(ValueError):
        FM.siren_dense_dgrad(dy, None, args[1], mainloop="WGMMA")


def test_reset_clears_the_mainloop_counts():
    FM.MAINLOOP_LAUNCHES[("siren_dense", "wgmma")] = 3
    FM.reset_launches()
    assert FM.MAINLOOP_LAUNCHES == {} and FM.LAUNCHES["siren_dense"] == 0
