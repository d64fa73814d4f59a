"""Which mainloop siren_dense, siren_dense_dgrad and siren_dense_wgrad (and
the nerf variant's nerf_dense, nerf_dense_dgrad and nerf_dense_wgrad) take on
the card, when the SIREN wgrad launches small_grads and the nerf wgrad
nerf_bias_grad, and the `mainloop=` keyword on the CPU.

`dense_mainloop` is the rule of the three kernels' C entries
(csrc/fused_render.cu, csrc/fused_train.cu) in Python; the wrappers call it
to build the mainloop argument they pass, and count each launch under its
answer in MAINLOOP_LAUNCHES. Every shape the main path gives the three
kernels with K > 0 (K, N in {256, 512}, bf16, tensors from torch.empty) must
take wgmma; the capability presets' width 96 keeps wmma; an operand whose
pointer is not a multiple of 16 bytes keeps off wgmma. `small_grads_mode`
decides, from the wgrad's mainloop and E operand, whether small_grads runs
and whether it sums db: on the main path 5 of a step's 15 wgrad launches ask
for it. On the CPU the wrappers run their plain versions whatever mainloop
is asked for, and refuse a name they do not know. The card's side of the
same rule is held in tests/test_torch_cuda.py.

The nerf variant at 8 x 256 (skip 4, n_freq (10, 4): encoding weights of 64
and 32 rows) gives its 10 forward, 9 dgrad and 10 wgrad launches a step bf16
shapes that all take wgmma (layer 0's encoding-only forward and wgrad, K = 0,
too), so nerf_bias_grad, which sums db beside every other mainloop, runs for
none of them.
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
    # ... and siren_dense_wgrad (K = X's columns, N = dW's)
    ("siren_dense_wgrad", BF16, 512, 512, True, True, "wgmma"),  # trunk, feats
    ("siren_dense_wgrad", BF16, 512, 256, True, True, "wgmma"),  # rgb_0 ...
    ("siren_dense_wgrad", BF16, 256, 256, True, True, "wgmma"),  # sun_v_1, _2
    ("siren_dense_wgrad", BF16, 0, 512, True, True, "k0"),       # layer 0
    ("siren_dense_wgrad", BF16, 0, 256, True, True, "k0"),       # sky_0
    # fp32 stays exact on SIMT FMAs
    ("siren_dense", F32, 512, 512, True, True, "simt"),
    ("siren_dense", F32, 0, 512, True, True, "k0"),
    ("siren_dense_dgrad", F32, 512, 512, True, True, "simt"),
    ("siren_dense_wgrad", F32, 512, 512, True, True, "simt"),
    ("siren_dense_wgrad", F32, 0, 512, True, True, "k0"),
    # the capability presets' width 96 (heads 48): not a multiple of 64
    ("siren_dense", BF16, 96, 96, True, True, "wmma"),
    ("siren_dense", BF16, 96, 48, True, True, "wmma"),
    ("siren_dense_dgrad", BF16, 96, 96, True, True, "wmma"),
    ("siren_dense_dgrad", BF16, 96, 48, True, True, "wmma"),
    ("siren_dense_wgrad", BF16, 96, 96, True, True, "wmma"),
    ("siren_dense_wgrad", BF16, 96, 48, True, True, "wmma"),
    # a multiple of 64 on one side only
    ("siren_dense", BF16, 512, 200, True, True, "wmma"),
    ("siren_dense_dgrad", BF16, 320, 512, True, True, "wgmma"),
    ("siren_dense", BF16, 320, 192, True, True, "wgmma"),
    ("siren_dense_dgrad", BF16, 40, 512, True, True, "wmma"),
    ("siren_dense_wgrad", BF16, 512, 200, True, True, "wmma"),
    ("siren_dense_wgrad", BF16, 40, 512, True, True, "wmma"),
    ("siren_dense_wgrad", BF16, 320, 192, True, True, "wgmma"),
    # the wgrad streams X and G: no limit on K
    ("siren_dense_wgrad", BF16, 1024, 512, True, True, "wgmma"),
    # siren_dense's W slice must fit shared memory; the dgrad streams W
    ("siren_dense", BF16, 1024, 512, True, True, "wmma"),
    ("siren_dense_dgrad", BF16, 1024, 512, True, True, "wgmma"),
    # shapes no tensor-core mainloop takes
    ("siren_dense", BF16, 36, 100, True, True, "simt"),
    ("siren_dense_dgrad", BF16, 36, 100, True, True, "simt"),
    ("siren_dense_wgrad", BF16, 36, 100, True, True, "simt"),
    # pointers: an unaligned weight (an input of both) goes to SIMT, as
    # before; an unaligned Y / slope / dX keeps the wmma path
    ("siren_dense", BF16, 512, 512, False, True, "simt"),
    ("siren_dense", BF16, 512, 512, True, False, "wmma"),
    ("siren_dense_dgrad", BF16, 512, 512, False, True, "simt"),
    ("siren_dense_dgrad", BF16, 512, 512, True, False, "wmma"),
    # the wgrad's inputs are X, dY and the slope: unaligned, SIMT as before
    ("siren_dense_wgrad", BF16, 512, 512, False, True, "simt"),
    ("siren_dense_wgrad", BF16, 0, 512, False, True, "k0"),
]

# (kernel, dtype, K, N, e_rows, inputs aligned, outputs aligned, mainloop)
NERF_RULE = [
    # the nerf variant's main path, 8 x 256: nerf_dense (K -> N, the
    # encoding's rows; feats is a trunk layer's shape without the relu)
    ("nerf_dense", BF16, 0, 256, 64, True, True, "wgmma"),     # layer 0, xyz
    ("nerf_dense", BF16, 256, 256, 0, True, True, "wgmma"),    # trunk, feats
    ("nerf_dense", BF16, 256, 256, 64, True, True, "wgmma"),   # skip, xyz
    ("nerf_dense", BF16, 256, 128, 32, True, True, "wgmma"),   # rgb_0, dir
    ("nerf_dense", BF16, 512, 256, 64, True, True, "wgmma"),   # --fc_units 512
    ("nerf_dense", F32, 256, 256, 64, True, True, "simt"),
    ("nerf_dense", F32, 0, 256, 64, True, True, "simt"),
    # an unaligned input leaves both tensor-core mainloops, an unaligned Y
    # only wgmma (its 16-byte stores)
    ("nerf_dense", BF16, 256, 256, 64, False, True, "simt"),
    ("nerf_dense", BF16, 256, 256, 64, True, False, "wmma"),
    # shapes the wgmma mainloop does not take: K past the W slice's 512, K
    # or N not multiples of 64, an encoding of 96 rows; e_rows not a
    # multiple of 32 leaves wmma too
    ("nerf_dense", BF16, 576, 256, 0, True, True, "wmma"),
    ("nerf_dense", BF16, 40, 200, 64, True, True, "wmma"),
    ("nerf_dense", BF16, 256, 256, 96, True, True, "wmma"),
    ("nerf_dense", BF16, 0, 100, 32, True, True, "simt"),
    ("nerf_dense", BF16, 256, 256, 40, True, True, "simt"),
    # the nerf variant's main path, 8 x 256: nerf_dense_dgrad (K <- N) ...
    ("nerf_dense_dgrad", BF16, 256, 128, 0, True, True, "wgmma"),  # rgb_0
    ("nerf_dense_dgrad", BF16, 256, 256, 0, True, True, "wgmma"),  # feats, trunk
    # ... and nerf_dense_wgrad (K = X's columns, N = dW's, the encoding's rows)
    ("nerf_dense_wgrad", BF16, 256, 128, 32, True, True, "wgmma"),  # rgb_0, dir
    ("nerf_dense_wgrad", BF16, 256, 256, 0, True, True, "wgmma"),   # feats, trunk
    ("nerf_dense_wgrad", BF16, 256, 256, 64, True, True, "wgmma"),  # skip, xyz
    ("nerf_dense_wgrad", BF16, 0, 256, 64, True, True, "wgmma"),    # layer 0
    # fp32 stays exact on SIMT FMAs
    ("nerf_dense_dgrad", F32, 256, 256, 0, True, True, "simt"),
    ("nerf_dense_wgrad", F32, 256, 256, 64, True, True, "simt"),
    ("nerf_dense_wgrad", F32, 0, 256, 64, True, True, "simt"),
    # widths that are not multiples of 64: the tests' 96 and 64 / 32
    ("nerf_dense_dgrad", BF16, 96, 96, 0, True, True, "wmma"),
    ("nerf_dense_wgrad", BF16, 96, 48, 32, True, True, "wmma"),
    ("nerf_dense_wgrad", BF16, 64, 32, 32, True, True, "wmma"),
    ("nerf_dense_dgrad", BF16, 64, 32, 0, True, True, "wmma"),
    # an encoding the wgmma tile does not hold (n_freq 16: 96 rows); beside
    # more than one 256-column tile of X it is a tile of its own all the same
    ("nerf_dense_wgrad", BF16, 256, 256, 96, True, True, "wmma"),
    ("nerf_dense_wgrad", BF16, 512, 256, 64, True, True, "wgmma"),
    ("nerf_dense_wgrad", BF16, 512, 256, 0, True, True, "wgmma"),
    # pointers: an unaligned input leaves both tensor-core mainloops; an
    # unaligned dX only wgmma
    ("nerf_dense_dgrad", BF16, 256, 256, 0, False, True, "simt"),
    ("nerf_dense_dgrad", BF16, 256, 256, 0, True, False, "wmma"),
    ("nerf_dense_wgrad", BF16, 256, 256, 64, False, True, "simt"),
    # shapes no tensor-core mainloop takes
    ("nerf_dense_dgrad", BF16, 36, 100, 0, True, True, "simt"),
    ("nerf_dense_wgrad", BF16, 36, 100, 32, True, True, "simt"),
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
    ("siren_dense_wgrad", BF16, 96, 96, True, True, "wgmma"),
    ("siren_dense_wgrad", BF16, 512, 200, True, True, "wgmma"),
    ("siren_dense_wgrad", BF16, 512, 512, False, True, "wgmma"),
    ("siren_dense_wgrad", BF16, 512, 512, False, True, "wmma"),
    ("siren_dense_wgrad", BF16, 0, 512, True, True, "wgmma"),
    ("siren_dense_wgrad", BF16, 0, 256, True, True, "wmma"),
    ("siren_dense_wgrad", F32, 512, 512, True, True, "wgmma"),
    ("siren_dense_wgrad", F32, 512, 512, True, True, "wmma"),
])
def test_a_mainloop_that_cannot_run_is_refused(kernel, dtype, k, n, ins, outs,
                                               mainloop):
    with pytest.raises(ValueError):
        FM.dense_mainloop(kernel, dtype, k, n, inputs_aligned=ins,
                          outputs_aligned=outs, mainloop=mainloop)


@pytest.mark.parametrize("k,n,want", [
    (64, 64, "wmma"), (64, 128, "wmma"), (128, 64, "wgmma"), (512, 512, "wgmma")])
def test_siren_dense_at_k64_leaves_wgmma(k, n, want):
    """siren_dense's wgmma kernel hung at K = 64 (one depth block a tile)
    with an E operand or a saved slope from 262,144 points on (a 64-wide
    field): the rule, as csrc/fused_render.cu's, sends K = 64 to wmma and
    refuses wgmma there by hand."""
    assert FM.dense_mainloop("siren_dense", BF16, k, n) == want
    if want == "wmma":
        with pytest.raises(ValueError):
            FM.dense_mainloop("siren_dense", BF16, k, n, mainloop="wgmma")


@pytest.mark.parametrize("kernel,dtype,k,n,e_rows,ins,outs,want", NERF_RULE)
def test_nerf_rule(kernel, dtype, k, n, e_rows, ins, outs, want):
    got = FM.dense_mainloop(kernel, dtype, k, n, e_rows=e_rows,
                            inputs_aligned=ins, outputs_aligned=outs)
    assert got == want
    if want in FM.MAINLOOPS:
        assert FM.dense_mainloop(kernel, dtype, k, n, e_rows=e_rows,
                                 inputs_aligned=ins, outputs_aligned=outs,
                                 mainloop=want) == want


@pytest.mark.parametrize("kernel,dtype,k,n,e_rows,ins,outs,mainloop", [
    ("nerf_dense", BF16, 256, 256, 96, True, True, "wgmma"),
    ("nerf_dense", BF16, 256, 256, 64, True, False, "wgmma"),
    ("nerf_dense", BF16, 256, 256, 64, False, True, "wmma"),
    ("nerf_dense", BF16, 576, 256, 0, True, True, "wgmma"),
    ("nerf_dense", BF16, 40, 200, 64, True, True, "wgmma"),
    ("nerf_dense", BF16, 256, 256, 40, True, True, "wmma"),
    ("nerf_dense", F32, 256, 256, 64, True, True, "wgmma"),
    ("nerf_dense", F32, 0, 256, 64, True, True, "wmma"),
    ("nerf_dense_dgrad", BF16, 96, 96, 0, True, True, "wgmma"),
    ("nerf_dense_dgrad", BF16, 256, 256, 0, True, False, "wgmma"),
    ("nerf_dense_dgrad", BF16, 256, 256, 0, False, True, "wmma"),
    ("nerf_dense_dgrad", F32, 256, 256, 0, True, True, "wgmma"),
    ("nerf_dense_dgrad", F32, 256, 256, 0, True, True, "wmma"),
    ("nerf_dense_wgrad", BF16, 256, 256, 96, True, True, "wgmma"),
    ("nerf_dense_wgrad", BF16, 256, 256, 40, True, True, "wgmma"),
    ("nerf_dense_wgrad", BF16, 256, 256, 64, False, True, "wgmma"),
    ("nerf_dense_wgrad", BF16, 256, 256, 64, False, True, "wmma"),
    ("nerf_dense_wgrad", BF16, 36, 100, 32, True, True, "wmma"),
    ("nerf_dense_wgrad", F32, 0, 256, 64, True, True, "wgmma"),
])
def test_a_nerf_mainloop_that_cannot_run_is_refused(kernel, dtype, k, n, e_rows,
                                                    ins, outs, mainloop):
    with pytest.raises(ValueError):
        FM.dense_mainloop(kernel, dtype, k, n, e_rows=e_rows, inputs_aligned=ins,
                          outputs_aligned=outs, mainloop=mainloop)


def test_unknown_names_are_refused():
    with pytest.raises(ValueError):
        FM.dense_mainloop("siren_dense", BF16, 512, 512, mainloop="tma")
    with pytest.raises(ValueError, match="has one mainloop"):
        FM.dense_mainloop("composite_loss_bwd", BF16, 512, 512)


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


# ------------------------------------------- siren_dense_wgrad and small_grads


@pytest.mark.parametrize("mainloop,extra,want", [
    ("wgmma", None, "none"), ("wgmma", "xyz", "fold"), ("wgmma", "t", "fold"),
    ("wmma", None, "db"), ("wmma", "sun", "db"), ("simt", None, "db"),
    ("k0", "xyz", "db"), ("k0", None, "db")])
def test_small_grads_mode(mainloop, extra, want):
    """narrow="rays", the rule: the wgmma wgrad sums db, and folds dC of an
    E operand of at most FOLD_MAX columns; narrow_grads takes the rest."""
    assert FM.small_grads_mode(mainloop, extra) == want


@pytest.mark.parametrize("mainloop,extra,narrow,n_extra,want", [
    # the column walk small_grads, kept to compare: as before narrow_grads
    ("wgmma", None, "walk", 0, "none"), ("wgmma", "xyz", "walk", 3, "no_db"),
    ("wgmma", "t", "walk", 4, "no_db"), ("wmma", "sun", "walk", 3, "db"),
    ("k0", "xyz", "walk", 3, "db"), ("simt", None, "walk", 0, "db"),
    # an E operand wider than the fold takes: narrow_grads forms dC
    ("wgmma", "t", "rays", 5, "dc"), ("wgmma", "t", "rays", 4, "fold"),
    ("wmma", "t", "rays", 5, "db")])
def test_small_grads_mode_by_body(mainloop, extra, narrow, n_extra, want):
    assert FM.small_grads_mode(mainloop, extra, narrow, n_extra) == want
    with pytest.raises(ValueError):
        FM.small_grads_mode(mainloop, extra, "lanes", n_extra)


@pytest.mark.parametrize("p,k,n,e_rows,want", [
    (65536, 512, 512, 0, 4096),  # 8 tiles, 16 ranges: 128 blocks on 132 SMs
    (65536, 512, 256, 0, 2016),  # 4 tiles, 33 ranges
    (65536, 256, 256, 0, 1024),  # 2 tiles, 64 ranges
    (1037 * 72, 512, 512, 0, 4672),
    (48, 512, 512, 0, 32),       # fewer points than one range: one stage
    (65536, 4096, 4096, 0, 65536),  # more tiles than SMs: one range
    # the nerf variant at 8 x 256: the encoding is a k tile of its own
    # beside X's (the skip layer: 4 tiles; rgb_0: 2), or alone (layer 0,
    # K = 0: 2); the ragged batch of 1,037 rays x 72
    (65536, 256, 256, 64, 2016),
    (65536, 256, 128, 32, 1024),
    (65536, 0, 256, 64, 1024),
    (1037 * 72, 256, 256, 0, 1152),
    (1037 * 72, 256, 256, 64, 2272)])
def test_wgrad_split(p, k, n, e_rows, want):
    split = FM.wgrad_split(p, k, n, 132, e_rows)
    assert split == want and split % FM.WGRAD_STAGE_POINTS == 0
    tiles = -(-n // 128) * max(1, -(-k // 256) + (e_rows > 0))
    assert tiles * -(-p // split) <= max(132, tiles)


def _recorded_chain(dtype, sc: bool):
    """Every siren_dense_wgrad call of _chain_backward at the main path's
    widths (sat-nerf 8 x 512, skip 4) on a few CPU rays: the arguments it was
    given. The plain versions run; nothing is launched."""
    from satnerf_tpu_torch.models.nerf import build_model

    calls = []

    class Recorder(FM.TrainOps):
        @staticmethod
        def wgrad(x, dy, slope, rays16, samples, **kw):
            calls.append((x, dy, slope, kw.get("extra"), kw.get("extra_weight"),
                          kw.get("extra_grad", False), kw.get("defer") is not None))
            return FM.siren_dense_wgrad(x, dy, slope, rays16, samples, **kw)

    field = build_model("sat-nerf", 8, 512, t_dim=4,
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    n_rays, n_s = 2, 4
    o, d, sun = (torch.from_numpy(rng.normal(0, 1, (n_rays, 3))).float()
                 for _ in range(3))
    t = torch.from_numpy(rng.normal(0, 1, (n_rays, 4))).float()
    z = torch.from_numpy(np.sort(rng.uniform(0, 1, (n_rays, n_s)), 1)).float()
    rays16 = FM.pack_rays(o, d, sun, t, 4)
    packed = FM.pack_params(field, skip=4, use_beta=True, dtype=dtype)
    with torch.no_grad():
        if sc:
            FM._sc_staged(packed, rays16, z, None, 0.1 / 3, skip=4,
                          use_beta=True, ops=Recorder)
        else:
            gt = torch.from_numpy(rng.uniform(0, 1, (n_rays, 3))).float()
            FM._train_staged(packed, rays16, z, None, gt, 1.0, skip=4,
                             use_beta=True, rgb_padding=0.001, beta_min=0.05,
                             return_weights=False, ops=Recorder)
    plan = []
    for x, dy, slope, extra, c, extra_grad, deferred in calls:
        k = 0 if x is None else x.shape[1]
        loop = FM.dense_mainloop("siren_dense_wgrad",
                                 FM._wgrad_dtype(x, c, dy), k, dy.shape[1],
                                 inputs_aligned=FM._aligned(x, dy, slope))
        n_extra = 0 if c is None else c.shape[0]
        plan.append((k, dy.shape[1], extra, loop,
                     FM.small_grads_mode(loop, extra, "rays", n_extra),
                     extra_grad, deferred))
    return plan


def _narrow_launches(plan) -> tuple:
    """(narrow_grads launches on the card, jobs in the joined launch): a job
    a wgrad call that has narrow work, each launched alone unless deferred
    into the chain's one joined launch (at most NARROW_MAX_JOBS a launch; on
    the CPU the plain version runs at once and nothing is deferred)."""
    jobs = [(mode in ("db", "dc") or extra_grad, deferred)
            for *_, mode, extra_grad, deferred in plan]
    alone = sum(1 for has, deferred in jobs if has and not deferred)
    together = sum(1 for has, deferred in jobs if has and deferred)
    return alone + -(-together // FM.NARROW_MAX_JOBS), together


@pytest.mark.parametrize("chain,calls,asking", [("train", 15, 2), ("sc", 12, 1)])
def test_small_grads_launches_of_the_main_path(chain, calls, asking):
    """bf16 at 8 x 512: every wgrad call with K > 0 takes wgmma, which sums db
    itself and folds dC of the E operand (sun_v_0, beta_0, the skip layer);
    narrow_grads runs for the two layers without X (layer 0: db and dC of
    xyz; sky_0: db and dC of sun_dir) and for beta_0's t_grad (dE), sky_0's
    job and beta_0's in one launch. K1 (and K4, K5, whose backward is the
    same chain): 2 narrow launches for 15 wgrad calls, 13 of which launch a
    GEMM; K3: 1 for 12."""
    plan = _recorded_chain(torch.bfloat16, sc=chain == "sc")
    assert len(plan) == calls
    assert all(loop == ("wgmma" if k else "k0") for k, _, _, loop, *_ in plan)
    launches, joined = _narrow_launches(plan)
    assert launches == asking
    # db is summed once: by the GEMM's epilogue, or narrow_grads where there
    # is no GEMM; dC of every E operand folded where there is one
    assert all(mode == ("db" if k == 0 else "fold" if extra else "none")
               for k, _, extra, _, mode, *_ in plan)
    folded = {(k, n, extra) for k, n, extra, _, mode, *_ in plan if mode == "fold"}
    want = {(512, 256, "sun"), (512, 512, "xyz")}
    if chain == "train":
        want.add((512, 256, "t"))
        assert joined == 2  # sky_0's job and beta_0's t_grad
    else:
        assert joined == 0
    assert folded == want
    assert [(k, extra) for k, _, extra, *_, eg, _ in plan if eg] == (
        [(512, "t")] if chain == "train" else [])


def test_small_grads_sums_db_of_every_fp32_launch():
    """fp32: every wgrad with K > 0 is SIMT, so narrow_grads sums db of each
    of the 15 layers: 13 launches, the heads' sun_v_0, sky_0 and beta_0 in
    one."""
    plan = _recorded_chain(torch.float32, sc=False)
    assert [mode for _, _, _, _, mode, *_ in plan] == ["db"] * 15
    assert _narrow_launches(plan) == (13, 3)


def _wgrad_inputs(k, n, seed=3):
    rng = np.random.default_rng(seed)
    n_rays, samples = 5, 4
    rays16 = torch.from_numpy(rng.uniform(-0.5, 0.5, (n_rays, 16))).float()
    z = torch.from_numpy(np.sort(rng.uniform(0, 1, (n_rays, samples)), 1)).float()
    p = n_rays * samples
    x = torch.from_numpy(rng.uniform(-1, 1, (p, k))).float() if k else None
    dy = torch.from_numpy(rng.normal(0, 1, (p, n))).float()
    slope = torch.from_numpy(rng.normal(0, 1, (p, n))).float()
    c = torch.from_numpy(rng.normal(0, 0.3, (3, n))).float()
    return (x, dy, slope, rays16, samples), dict(extra="xyz", extra_weight=c,
                                                 z=z, extra_grad=True)


@pytest.mark.parametrize("mainloop", ["wgmma", "wmma", None])
@pytest.mark.parametrize("k,n", [(64, 64), (36, 20), (0, 64)])
def test_cpu_wgrad_runs_the_plain_version_whatever_mainloop(mainloop, k, n):
    args, kw = _wgrad_inputs(k, n)
    launches, by_loop = dict(FM.LAUNCHES), dict(FM.MAINLOOP_LAUNCHES)
    got = FM.siren_dense_wgrad(*args, mainloop=mainloop, **kw)
    ref = FM.siren_dense_wgrad_reference(*args, **kw)
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    assert FM.LAUNCHES == launches and FM.MAINLOOP_LAUNCHES == by_loop


def test_cpu_wgrad_refuses_an_unknown_mainloop():
    args, kw = _wgrad_inputs(64, 64)
    with pytest.raises(ValueError):
        FM.siren_dense_wgrad(*args, mainloop="tma", **kw)


def test_bias_only_layer_has_db_alone():
    """A layer with neither X nor E: db = sum of G, nothing else."""
    (_, dy, slope, rays16, samples), _ = _wgrad_inputs(0, 64)
    dw, db, dc, de = FM.siren_dense_wgrad(None, dy, slope, rays16, samples)
    assert dw is None and dc is None and de is None
    assert torch.allclose(db, (dy * slope).sum(0))


# ------------------------------------ nerf_dense_dgrad and nerf_dense_wgrad


def _nerf_inputs(k, n, enc, seed=4):
    """A nerf layer's backward operands on the CPU: dy, the stored relu
    output y, the weight and the rays of 5 rays x 4 samples."""
    from satnerf_tpu_torch.ops import fused_nerf as FN

    rng = np.random.default_rng(seed)
    n_rays, samples = 5, 4
    p = n_rays * samples
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (n_rays, 3))).float()
    d = torch.from_numpy(rng.normal(0, 1, (n_rays, 3))).float()
    z = torch.from_numpy(np.sort(rng.uniform(0, 1, (n_rays, samples)), 1)).float()
    rays8 = FN.pack_rays(o, d / d.norm(dim=1, keepdim=True))
    x = torch.from_numpy(rng.uniform(0, 1, (p, k))).float() if k else None
    dy = torch.from_numpy(rng.normal(0, 1, (p, n))).float()
    y = torch.relu(torch.from_numpy(rng.normal(0, 1, (p, n))).float())
    w = torch.from_numpy(rng.normal(0, 0.1, (max(k, 1), n))).float()
    n_freq = {"xyz": 10, "dir": 4, None: 0}[enc]
    kw = dict(enc=enc, z=z, n_freq=n_freq,
              enc_rows=FN._enc_rows(n_freq) if enc else 0, dtype=F32)
    return x, dy, y, w, rays8, samples, kw


@pytest.mark.parametrize("mainloop", ["wgmma", "wmma", None])
@pytest.mark.parametrize("k,n,enc", [(64, 64, "xyz"), (64, 32, "dir"),
                                     (36, 20, None), (0, 64, "xyz")])
def test_cpu_nerf_runs_the_plain_version_whatever_mainloop(mainloop, k, n, enc):
    from satnerf_tpu_torch.ops import fused_nerf as FN

    x, dy, y, w, rays8, samples, kw = _nerf_inputs(k, n, enc)
    launches, by_loop = dict(FM.LAUNCHES), dict(FM.MAINLOOP_LAUNCHES)
    c = (torch.from_numpy(np.random.default_rng(6).normal(
        0, 0.3, (kw["enc_rows"], n))).float() if enc else None)
    fkw = dict(enc=enc, enc_weight=c, z=kw["z"], n_freq=kw["n_freq"])
    fwd = (x, w if k else None, dy[0], rays8, samples)  # dy's first row: a bias
    got = FN.nerf_dense(*fwd, mainloop=mainloop, **fkw)
    assert torch.equal(got, FN.nerf_dense_reference(*fwd, **fkw))
    got = FN.nerf_dense_wgrad(x, dy, y, rays8, samples, mainloop=mainloop, **kw)
    ref = FN.nerf_dense_wgrad_reference(x, dy, y, rays8, samples, **kw)
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    if k:
        out = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (20, k))).float()
        dx = FN.nerf_dense_dgrad(dy, y, w, out=out.clone(), mainloop=mainloop)
        assert torch.equal(dx, FN.nerf_dense_dgrad_reference(dy, y, w,
                                                             out=out.clone()))
    # nothing was launched, so nothing was counted (nerf_bias_grad neither)
    assert FM.LAUNCHES == launches and FM.MAINLOOP_LAUNCHES == by_loop


def test_cpu_nerf_refuses_an_unknown_mainloop():
    from satnerf_tpu_torch.ops import fused_nerf as FN

    x, dy, y, w, rays8, samples, kw = _nerf_inputs(64, 64, "xyz")
    with pytest.raises(ValueError):
        FN.nerf_dense(x, w, dy[0], rays8, samples, mainloop="tma")
    with pytest.raises(ValueError):
        FN.nerf_dense_wgrad(x, dy, y, rays8, samples, mainloop="tma", **kw)
    with pytest.raises(ValueError):
        FN.nerf_dense_dgrad(dy, y, w, mainloop="WGMMA")


@pytest.mark.parametrize("enc", [None, "xyz", "dir"])
@pytest.mark.parametrize("mainloop,runs", [("wgmma", False), ("wmma", True),
                                           ("simt", True)])
def test_nerf_bias_grad_runs(mainloop, runs, enc):
    """db is summed once a launch: by the wgmma epilogue, else by
    nerf_bias_grad, whether or not the layer has an encoding (its dC is
    part of the GEMM launch on every mainloop)."""
    from satnerf_tpu_torch.ops import fused_nerf as FN

    assert FN.nerf_bias_grad_runs(mainloop) is runs


def _recorded_nerf_chain(dtype):
    """Every nerf_dense_dgrad and nerf_dense_wgrad call of _chain_backward at
    the nerf variant's widths (8 x 256, skip 4, n_freq (10, 4)) on a few CPU
    rays: (kernel, K, N, e_rows, the mainloop the card would take). The
    plain versions run; nothing is launched."""
    from satnerf_tpu_torch.models.nerf import build_model
    from satnerf_tpu_torch.ops import fused_nerf as FN

    plan = []

    class Recorder(FN.NerfOps):
        @staticmethod
        def dgrad(dy, y, weight, out=None):
            dx = FN.nerf_dense_dgrad(dy, y, weight, out=out)
            plan.append(("dgrad", weight.shape[0], dy.shape[1], 0, FM.dense_mainloop(
                "nerf_dense_dgrad", weight.dtype, weight.shape[0], dy.shape[1],
                inputs_aligned=FM._aligned(dy, y, weight),
                outputs_aligned=FM._aligned(dx))))
            return dx

        @staticmethod
        def wgrad(x, dy, y, rays8, samples, **kw):
            k = 0 if x is None else x.shape[1]
            e_rows = kw["enc_rows"] if kw.get("enc") else 0
            plan.append(("wgrad", k, dy.shape[1], e_rows, FM.dense_mainloop(
                "nerf_dense_wgrad", kw["dtype"], k, dy.shape[1], e_rows=e_rows,
                inputs_aligned=FM._aligned(x, dy, y))))
            return FN.nerf_dense_wgrad(x, dy, y, rays8, samples, **kw)

    field = build_model("nerf", 8, 256, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    n_rays, n_s = 2, 4
    o = torch.from_numpy(rng.normal(0, 0.3, (n_rays, 3))).float()
    d = torch.from_numpy(rng.normal(0, 1, (n_rays, 3))).float()
    z = torch.from_numpy(np.sort(rng.uniform(0, 1, (n_rays, n_s)), 1)).float()
    gt = torch.from_numpy(rng.uniform(0, 1, (n_rays, 3))).float()
    packed = FN.pack_params(field, skip=4, dtype=dtype)
    with torch.no_grad():
        FN._train_staged(packed, FN.pack_rays(o, d), z, None, gt, skip=4,
                         n_freq=(10, 4), rgb_padding=0.001, ops=Recorder)
    return plan


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "simt")])
def test_nerf_chain_forward_takes_wgmma(dtype, want):
    """The ten nerf_dense calls of the 8 x 256 forward: layer 0 on the
    position's encoding alone, six trunk layers, the skip layer with it,
    feats, rgb_0 with the direction's; all on wgmma in bf16, on SIMT in
    fp32. The plain versions run; nothing is launched."""
    from satnerf_tpu_torch.models.nerf import build_model
    from satnerf_tpu_torch.ops import fused_nerf as FN

    plan = []

    class Recorder(FN.NerfOps):
        @staticmethod
        def dense(x, weight, bias, rays8, samples, **kw):
            y = FN.nerf_dense(x, weight, bias, rays8, samples, **kw)
            ew = kw.get("enc_weight")
            k, e_rows = (0 if x is None else x.shape[1],
                         0 if ew is None else ew.shape[0])
            plan.append((k, bias.shape[0], e_rows, FM.dense_mainloop(
                "nerf_dense", y.dtype, k, bias.shape[0], e_rows=e_rows,
                inputs_aligned=FM._aligned(x, weight, ew),
                outputs_aligned=FM._aligned(y))))
            return y

    field = build_model("nerf", 8, 256, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    o = torch.from_numpy(rng.normal(0, 0.3, (2, 3))).float()
    d = torch.from_numpy(rng.normal(0, 1, (2, 3))).float()
    z = torch.from_numpy(np.sort(rng.uniform(0, 1, (2, 4)), 1)).float()
    with torch.no_grad():
        FN._chain_forward(FN.pack_params(field, skip=4, dtype=dtype),
                          FN.pack_rays(o, d), z, skip=4, n_freq=(10, 4),
                          keep=False, ops=Recorder)
    assert [c[:3] for c in plan] == ([(0, 256, 64)] + [(256, 256, 0)] * 3
                                     + [(256, 256, 64)] + [(256, 256, 0)] * 4
                                     + [(256, 128, 32)])
    assert all(c[3] == want for c in plan)


def test_nerf_chain_backward_takes_wgmma_and_no_bias_kernel():
    """bf16 at 8 x 256: the 9 dgrad and 10 wgrad calls of a step all take
    wgmma (the encoding-only wgrad of layer 0 too), so nerf_bias_grad runs
    for none of the 10 wgrad calls."""
    plan = _recorded_nerf_chain(torch.bfloat16)
    assert [c[0] for c in plan].count("dgrad") == 9
    assert [c[0] for c in plan].count("wgrad") == 10
    assert all(loop == "wgmma" for *_, loop in plan)
    from satnerf_tpu_torch.ops import fused_nerf as FN

    assert not any(FN.nerf_bias_grad_runs(loop) for kind, *_, loop in plan
                   if kind == "wgrad")
    wgrads = [(k, n, e) for kind, k, n, e, _ in plan if kind == "wgrad"]
    # rgb_0 with the direction's 32 rows first, layer 0's 64 rows last
    assert wgrads[0] == (256, 128, 32) and wgrads[-1] == (0, 256, 64)
    assert wgrads.count((256, 256, 64)) == 1  # the skip layer
    assert wgrads.count((256, 256, 0)) == 7   # feats and six trunk layers
    dgrads = [(k, n) for kind, k, n, *_ in plan if kind == "dgrad"]
    assert dgrads == [(256, 128)] + [(256, 256)] * 8


def test_nerf_chain_backward_in_fp32_sums_db_by_the_bias_kernel():
    plan = _recorded_nerf_chain(torch.float32)
    assert len(plan) == 19 and all(loop == "simt" for *_, loop in plan)
    from satnerf_tpu_torch.ops import fused_nerf as FN

    assert all(FN.nerf_bias_grad_runs(loop) for kind, *_, loop in plan
               if kind == "wgrad")
