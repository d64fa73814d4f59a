"""Which mainloop siren_dense, siren_dense_dgrad and siren_dense_wgrad take
on the card, when the wgrad launches small_grads, and the `mainloop=`
keyword on the CPU.

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
    ("wgmma", None, "none"), ("wgmma", "xyz", "no_db"), ("wgmma", "t", "no_db"),
    ("wmma", None, "db"), ("wmma", "sun", "db"), ("simt", None, "db"),
    ("k0", "xyz", "db"), ("k0", None, "db")])
def test_small_grads_mode(mainloop, extra, want):
    assert FM.small_grads_mode(mainloop, extra) == want


@pytest.mark.parametrize("p,k,n,want", [
    (65536, 512, 512, 4096),  # 8 tiles, 16 ranges: 128 blocks on 132 SMs
    (65536, 512, 256, 2016),  # 4 tiles, 33 ranges
    (65536, 256, 256, 1024),  # 2 tiles, 64 ranges
    (1037 * 72, 512, 512, 4672),
    (48, 512, 512, 32),       # fewer points than one range: one stage
    (65536, 4096, 4096, 65536)])  # more tiles than SMs: one range
def test_wgrad_split(p, k, n, want):
    split = FM.wgrad_split(p, k, n, 132)
    assert split == want and split % FM.WGRAD_STAGE_POINTS == 0
    tiles = -(-n // 128) * -(-k // 256)
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
            calls.append((x, dy, slope, kw.get("extra"), kw.get("extra_weight")))
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
    for x, dy, slope, extra, c in calls:
        k = 0 if x is None else x.shape[1]
        loop = FM.dense_mainloop("siren_dense_wgrad",
                                 FM._wgrad_dtype(x, c, dy), k, dy.shape[1],
                                 inputs_aligned=FM._aligned(x, dy, slope))
        plan.append((k, dy.shape[1], extra, loop, FM.small_grads_mode(loop, extra)))
    return plan


@pytest.mark.parametrize("chain,calls,asking", [("train", 15, 5), ("sc", 12, 3)])
def test_small_grads_launches_of_the_main_path(chain, calls, asking):
    """bf16 at 8 x 512: every wgrad call with K > 0 takes wgmma, which sums db
    itself; small_grads runs for the layers with an E operand (sun_v_0,
    beta_0, the skip layer: dC, and dE on request, without db) and the two
    without X (layer 0, sky_0: db and dC). K1 (and K4, K5, whose backward is
    the same chain): 5 of 15; K3: 3 of 12."""
    plan = _recorded_chain(torch.bfloat16, sc=chain == "sc")
    assert len(plan) == calls
    assert all(loop == ("wgmma" if k else "k0") for k, _, _, loop, _ in plan)
    ask = [(k, n, extra, mode) for k, n, extra, _, mode in plan if mode != "none"]
    assert len(ask) == asking
    # db is summed once: never by small_grads where the GEMM took wgmma
    assert all(mode == ("db" if k == 0 else "no_db") for k, _, _, mode in ask)
    assert all(extra is not None for _, _, extra, _ in ask)
    want = {(512, 256, "sun"), (0, 512, "xyz"), (512, 512, "xyz")}
    if chain == "train":
        want |= {(0, 256, "sun"), (512, 256, "t")}
    assert {(k, n, extra) for k, n, extra, _ in ask} == want


def test_small_grads_sums_db_of_every_fp32_launch():
    plan = _recorded_chain(torch.float32, sc=False)
    assert [mode for *_, mode in plan] == ["db"] * 15


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
