"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
no jax, so it runs on the machine with the card:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes cover both siren_dense mainloops (tensor-core bf16 for K, N
multiples of 8; SIMT otherwise and for fp32), its K = 0 elementwise kernel
(vector and scalar stores), ragged row and column tiles,
every E operand, and heads_composite with and without the beta head (its
block scan at 1 to 4,096 samples a ray, 1 to 1,024 rays, F 96 to 512 and
Fh 44, noise and weights on and off, a faint sigma, and widths past its
shared memory refused); for
the training step, siren_dense's saved slope, both mainloops of
siren_dense_dgrad and siren_dense_wgrad (with accumulation, the split over
the points, every E operand and the per-ray gradient of t),
composite_loss_bwd with and without the beta head, noise and a saturated
ray, and fused_train_loss_grads as a whole against autograd; for the full
recipe, heads_composite with sigma noise, composite_bwd from a random
cotangent on all seven products (with clipped channels), sc_loss_bwd with a
saturated ray and, a block a ray, at 64, 128, 320 and the most samples its
shared memory holds (one more refused), 1 to 1,024 rays, Fh 48, 96 and
256, fused_sc_loss_grads and fused_train_render_rays (forward and
backward) as a whole against autograd, and a train step with SC, DS,
grad_accum and shuffle; for the per-sample field, field_heads and
field_heads_bwd at 1, 72 and 128 samples a ray with a ragged ray count and a
faint sigma, the streaming field_heads and field_heads_bwd at F 96, 256 and
512 with and without the beta head (the backward up to 131,072 points), fused_field_apply_rays and fused_field_apply (forward, backward
and the input gradients) as a whole against autograd, and a hierarchical
train step and render in each --fused mode; for the classic NeRF variant,
nerf_dense with both encodings, with and without X, on both mainloops,
nerf_dense_dgrad and nerf_dense_wgrad masked on the stored activation (with
accumulation, more than one split, the encoding's gradient), a relu unit
exactly at the kink, nerf_heads_composite and nerf_composite_loss_bwd (block
scans) with noise, weights, a saturated ray and a faint last sample, past one
and two chunks of 256 samples, with more rays than the persistent grid and
(nerf_heads_composite) at a 65,536-ray serving chunk, nerf_field_heads and
its backward (streaming; up to 131,072 points, F 40 to 512, fewer points
than a warp's share, and two backward launches within the order of their
atomics), fused_nerf_train_loss_grads, fused_nerf_render_rays and
fused_nerf_apply as wholes against autograd, and nerf train steps and renders
through the system; fused_field_apply and fused_nerf_apply under
inference_mode and no_grad keeping no layer's activations; for the Hopper mainloops of siren_dense,
siren_dense_dgrad and siren_dense_wgrad, `mainloop="wgmma"` against the plain
version and against `mainloop="wmma"` on the same inputs at every (K, N) of
the main path, every E operand (the wgrad's with its input gradient), with
and without the saved slope, accumulation and a slope, at 65,536, 1,037 x 72
and 1,024 x 128 points (the wgrad also at fewer points than one block's
range and at shapes that fill part of its tile), the wgrad's narrow
gradients (dC folded into the wgmma epilogue, narrow_grads for the layers
without X, for dE and beside wmma, one launch of several layers' jobs)
against the plain version and the column walk small_grads it replaced, and
operands whose pointers are
not 16-byte aligned, which the rule keeps off the wgmma path; and for the
nerf variant's nerf_dense_dgrad and nerf_dense_wgrad on the same mainloops,
every bf16 launch of its 8 x 256 chain (the dgrad masked and linear, with
accumulation; the wgrad with both encodings, and layer 0's encoding alone)
at 65,536 points and at 65,573 points that are their own rays, against the
plain version and the same launch on wmma, nerf_bias_grad launched only
beside a wmma wgrad, and the launches a forced wgmma cannot take; for
nerf_dense on the wgmma mainloop every launch of the 8 x 256 chain (and K
= 512, an encoding of 32 rows, partial column slices) at 65,536 points, at
65,573 points that are their own rays and at small ragged counts against the
plain version and wmma, and the launches a forced wgmma cannot take; and the
two bodies of composite_loss_bwd and composite_bwd (a block a ray, a warp a
ray) against each other and the plain version at up to the largest number
of samples a ray their shared memory holds (288, 320, 1,452; the block body
alone at 4,129), nerf_composite_loss_bwd (a block a ray) at up to 5,172,
the most its shared memory holds at any width, and one sample
more refused on either with the limit named; and siren_dense's K = 0 kernel
(layer 0, sky_0) equal to the bit to the first one it replaced; and the
training draws' kernel (csrc/jax_draws.cu: bits, uniform, randint, normal
and the permutation's rounds) equal to the bit to utils/jax_prng.py at
ragged counts, a span of 1, a 2-D shape and two sort rounds; and the
pipelined SIMT GEMM (csrc/simt_gemm.cuh) of siren_dense and nerf_dense_wgrad,
the simt mainloop of every fp32 launch, against the plain version at 10,
1,037 and 65,573 points, K 16 / 100 / 512 and N 100 / 256 / 512, the skip
layer with its E operand or encoding, N not a multiple of 4, inputs one
element off 16 bytes, and bf16 at width 100; and of siren_dense_dgrad and
nerf_dense_dgrad at 1,037 points, K 3 / 100 / 512, N 1 / 3 / 100 / 256 /
512, with the slope or mask and without, onto out= and not, every operand 4
bytes off 16, in fp32 and in bf16 where no tensor-core mainloop takes it.
"""

import numpy as np
import pytest
import torch

from satnerf_tpu_torch.models.nerf import build_model
from satnerf_tpu_torch.ops import fused_mlp as FM
from satnerf_tpu_torch.ops import fused_nerf as FN
from satnerf_tpu_torch.utils import jax_prng

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _rays16(n_rays, n_s, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    rays16 = torch.zeros(n_rays, 16)
    rays16[:, :13] = torch.rand(n_rays, 13, generator=g) - 0.5
    z = torch.sort(torch.rand(n_rays, n_s, generator=g), dim=1).values
    return rays16.to(dev), z.to(dev)


def _close(got, ref, bf16):
    """fp32: summation order only. bf16: at most one bf16 rounding step."""
    got, ref = got.float(), ref.float()
    tol = (2.0 ** -7 * ref.abs() + 1e-4) if bf16 else (1e-4 * ref.abs() + 1e-4)
    assert bool(((got - ref).abs() <= tol).all()), float((got - ref).abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,extra,n_extra,samples", [
    (0, 512, "xyz", 3, 16),      # trunk layer 0
    (512, 512, None, 0, 16),     # trunk layer
    (512, 512, "xyz", 3, 16),    # skip layer
    (512, 256, "sun", 3, 16),    # sun_v_0
    (512, 256, "t", 4, 16),      # beta_0
    (0, 256, "sun", 3, 1),       # sky_0, once a ray
    (0, 100, "t", 4, 5),         # K = 0 with N not a multiple of 8
    (40, 200, "xyz", 3, 7),      # ragged column tile, short K
    (36, 100, None, 0, 5),       # K and N not multiples of 8
])
def test_siren_dense(dev, dtype, k, n, extra, n_extra, samples):
    n_rays = 37
    rays16, z = _rays16(n_rays, samples, dev)
    g = torch.Generator().manual_seed(1)
    p = n_rays * samples
    x = (torch.rand(p, k, generator=g) * 2 - 1).to(dev, dtype) if k else None
    w = (torch.randn(k, n, generator=g) * 0.1).to(dev, dtype) if k else None
    b = torch.randn(n, generator=g).to(dev)
    c = (torch.randn(n_extra, n, generator=g) * 0.3).to(dev, dtype) if extra else None
    kw = dict(extra=extra, extra_weight=c, z=z, w0=30.0 if k == 0 else 1.0,
              act="relu" if samples == 1 else "sin")
    before = FM.LAUNCHES["siren_dense"]
    got = FM.siren_dense(x, w, b, rays16, samples, **kw)
    assert FM.LAUNCHES["siren_dense"] == before + 1
    ref = FM.siren_dense_reference(x, w, b, rays16, samples, **kw)
    assert got.dtype == dtype and got.shape == (p, n)
    _close(got, ref, dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta", [True, False])
@pytest.mark.parametrize("return_weights", [True, False])
def test_heads_composite(dev, dtype, beta, return_weights):
    n_rays, n_s, feat = 37, 16, 64
    g = torch.Generator().manual_seed(2)
    p, fh = n_rays * n_s, feat // 2

    def t(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    h, r, s2 = t(p, feat), t(p, fh), t(p, fh)
    bh = t(p, fh) if beta else None
    skyh = t(n_rays, fh).abs()
    wn, bn = t(9, feat, scale=0.5), torch.randn(9, generator=g).to(dev)
    _, z = _rays16(n_rays, n_s, dev)
    args = (h, r, s2, bh, skyh, wn, bn, z)
    kw = dict(rgb_padding=0.001, return_weights=return_weights)
    out, w = FM.heads_composite(*args, **kw)
    ref, ref_w = FM.heads_composite_reference(*args, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    if return_weights:
        np.testing.assert_allclose(w.cpu().numpy(), ref_w.cpu().numpy(),
                                   atol=1e-5)
    else:
        assert w is None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta", [True, False])
def test_heads_composite_with_noise(dev, dtype, beta):
    n_rays, n_s, feat = 37, 16, 64
    g = torch.Generator().manual_seed(12)
    p, fh = n_rays * n_s, feat // 2

    def t(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    h, r, s2 = t(p, feat), t(p, fh), t(p, fh)
    bh = t(p, fh) if beta else None
    skyh = t(n_rays, fh).abs()
    wn, bn = t(9, feat, scale=0.5), torch.randn(9, generator=g).to(dev)
    _, z = _rays16(n_rays, n_s, dev)
    noise = (torch.randn(n_rays, n_s, generator=g) * 2).to(dev)
    args = (h, r, s2, bh, skyh, wn, bn, z)
    kw = dict(noise=noise, rgb_padding=0.001, return_weights=True)
    before = FM.LAUNCHES["heads_composite"]
    out, w = FM.heads_composite(*args, **kw)
    assert FM.LAUNCHES["heads_composite"] == before + 1
    ref, ref_w = FM.heads_composite_reference(*args, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(w.cpu().numpy(), ref_w.cpu().numpy(), atol=1e-5)
    plain, _ = FM.heads_composite(*args, rgb_padding=0.001)
    assert float((plain - out).abs().max()) > 1e-3  # the noise is read


def _composite_inputs(dev, dtype, beta, n_rays, n_s, feat, fh, seed, span=1.0,
                      with_noise=False):
    """heads_composite's operands: sigma of order 1 (w0 scaled by 3 /
    sqrt(F)), depths over [0, span], noise of order 2 when asked for."""
    g = torch.Generator().manual_seed(seed)
    p = n_rays * n_s

    def t(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    h, r, s2 = t(p, feat), t(p, fh), t(p, fh)
    bh = t(p, fh) if beta else None
    skyh = t(n_rays, fh).relu()
    wn = t(9, feat, scale=0.5)
    wn[0] = t(feat, scale=3.0 / feat ** 0.5)
    bn = torch.randn(9, generator=g).to(dev)
    z = torch.sort(torch.rand(n_rays, n_s, generator=g), 1).values * span
    noise = (torch.randn(n_rays, n_s, generator=g) * 2).to(dev) if with_noise else None
    return (h, r, s2, bh, skyh, wn, bn, z.to(dev)), noise


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_rays,n_s,feat,fh,beta,with_noise,weights", [
    (1, 1, 96, 48, True, False, True), (37, 64, 256, 128, False, True, True),
    (1000, 128, 512, 256, True, True, False), (1024, 64, 512, 256, True, True, True),
    (37, 320, 96, 44, True, False, True), (37, 640, 256, 128, False, True, True),
    (1, 4096, 512, 256, True, False, True), (1024, 1, 512, 256, False, False, False)])
def test_heads_composite_block_scan(dev, dtype, n_rays, n_s, feat, fh, beta,
                                    with_noise, weights):
    """The block scan against its plain version at 1 to 4,096 samples a ray
    (past one chunk of 256 at 320, 640 and 4,096: T and the integrals
    carried over chunks), 1 to 1,024 rays (fewer than the persistent grid
    and more), F 96, 256 and 512 (Fh 44: rows of a length that is not a
    multiple of 8, read without 16-byte loads), the beta head, the noise and
    the weights each on and off: 1e-5, as test_heads_composite. At 4,096
    samples the depths span [0, 4096 / 320], the spacing of 320 samples over
    [0, 1]: over [0, 1] each factor 1 - alpha lies within 3e-4 of 1, and
    the plain version's fp32 cumprod (a scan on the card) drops the product
    of each two such terms, a drift of T that grows with S (PERF.md section
    7); the kernel's T is a product in double."""
    span = n_s / 320 if n_s > 640 else 1.0
    args, noise = _composite_inputs(dev, dtype, beta, n_rays, n_s, feat, fh, 25,
                                    span, with_noise)
    kw = dict(noise=noise, rgb_padding=0.001, return_weights=weights)
    before = dict(FM.LAUNCHES)
    out, w = FM.heads_composite(*args, **kw)
    assert _grown(before) == {"heads_composite": 1}
    ref, ref_w = FM.heads_composite_reference(*args, **kw)
    assert out.shape == (n_rays, 16) and float(out[:, 13:].abs().max()) == 0.0
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    if weights:
        np.testing.assert_allclose(w.cpu().numpy(), ref_w.cpu().numpy(), atol=1e-5)
    else:
        assert w is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_heads_composite_at_a_faint_sigma(dev, dtype):
    """A sigma of 1e-10 (softplus of -23) on every sample: every alpha but
    the last rounds to 0 in fp32, and the last, over the 1e10 that stands
    for the last interval, is 1 - exp(-1.03): an opacity near 0.64 that a
    softplus formed as log(1 + exp(x)) would lose. The products are the
    plain version's to 1e-5."""
    args, _ = _composite_inputs(dev, dtype, True, 37, 300, 96, 48, 26)
    args[5][0] = 0.0
    args[6][0] = -23.0
    out, w = FM.heads_composite(*args, return_weights=True)
    ref, ref_w = FM.heads_composite_reference(*args, return_weights=True)
    assert float(ref[:, 12].min()) > 0.5
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(w.cpu().numpy(), ref_w.cpu().numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype,feat,beta,with_noise", [
    (torch.float32, 11281, True, True), (torch.float32, 11282, True, False),
    (torch.float32, 12288, False, True), (torch.bfloat16, 22578, True, True),
    (torch.bfloat16, 24576, True, False)])
def test_heads_composite_at_widths_past_shared_memory(dev, dtype, feat, beta,
                                                      with_noise):
    """Widths on either side of the shared memory a block may hold (Fh = F
    // 2): F = 11,281 in fp32 keeps the narrow rows in shared memory, 11,282
    in fp32 and 22,578 in bf16 read them from Wn in global memory a value at
    a time (Fh not a multiple of 16 bytes' values), 12,288 in fp32 and
    24,576 in bf16 with 16-byte loads: one launch each, against the plain
    version to 1e-5, as test_heads_composite."""
    args, noise = _composite_inputs(dev, dtype, beta, 3, 37, feat, feat // 2, 27,
                                    with_noise=with_noise)
    kw = dict(noise=noise, rgb_padding=0.001, return_weights=True)
    before = dict(FM.LAUNCHES)
    out, w = FM.heads_composite(*args, **kw)
    assert _grown(before) == {"heads_composite": 1}
    ref, ref_w = FM.heads_composite_reference(*args, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(w.cpu().numpy(), ref_w.cpu().numpy(), atol=1e-5)


@pytest.mark.parametrize("variant", ["sat-nerf", "s-nerf"])
def test_fused_render_rays_fp32(dev, variant):
    """The whole chain in fp32 at a narrow, non-tile width against the
    plain field + compositor."""
    use_beta = variant == "sat-nerf"
    field = build_model(variant, 8, 96,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    g = torch.Generator().manual_seed(4)
    n_rays, n_s = 53, 24
    o = (torch.rand(n_rays, 3, generator=g) - 0.5).to(dev)
    d = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=g)).to(dev)
    sun = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=g)).to(dev)
    t = torch.randn(n_rays, 4, generator=g).to(dev)
    z = torch.sort(torch.rand(n_rays, n_s, generator=g), 1).values.to(dev)
    kw = dict(layers=8, feat=96, use_beta=use_beta, dtype=torch.float32,
              return_weights=True)
    out = FM.fused_render_rays(field, o, d, sun, t, z, **kw)
    with torch.inference_mode():
        ref = FM.fused_render_rays_reference(field, o, d, sun, t, z, **kw)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].grad_fn is None
        np.testing.assert_allclose(out[k].cpu().numpy(), ref[k].cpu().numpy(),
                                   atol=1e-4, err_msg=k)


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,extra,n_extra", [
    (0, 512, "xyz", 3), (512, 512, "xyz", 3), (512, 256, "t", 4),
    (40, 200, "sun", 3), (36, 100, None, 0)])
def test_siren_dense_saves_the_slope(dev, dtype, k, n, extra, n_extra):
    n_rays, samples = 37, 16
    rays16, z = _rays16(n_rays, samples, dev)
    g = torch.Generator().manual_seed(1)
    p = n_rays * samples
    x = (torch.rand(p, k, generator=g) * 2 - 1).to(dev, dtype) if k else None
    w = (torch.randn(k, n, generator=g) * 0.1).to(dev, dtype) if k else None
    b = torch.randn(n, generator=g).to(dev)
    c = (torch.randn(n_extra, n, generator=g) * 0.3).to(dev, dtype) if extra else None
    w0 = 30.0 if k == 0 else 1.0
    kw = dict(extra=extra, extra_weight=c, z=z, w0=w0, act="sin", save=True)
    y, slope = FM.siren_dense(x, w, b, rays16, samples, **kw)
    y_ref, slope_ref = FM.siren_dense_reference(x, w, b, rays16, samples, **kw)
    _close(y, y_ref, dtype == torch.bfloat16)
    assert slope.dtype == torch.float32 and slope.shape == (p, n)
    assert float((slope - slope_ref).abs().max()) <= 1e-5 * w0 * w0 + 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,with_slope,accumulate", [
    (512, 512, True, False), (512, 256, True, True), (512, 512, False, True),
    (40, 200, True, False), (36, 100, True, True)])
def test_siren_dense_dgrad(dev, dtype, k, n, with_slope, accumulate):
    p = 37 * 16 + 5
    g = torch.Generator().manual_seed(5)
    dy = torch.randn(p, n, generator=g).to(dev)
    slope = torch.randn(p, n, generator=g).to(dev) if with_slope else None
    w = (torch.randn(k, n, generator=g) * 0.1).to(dev, dtype)
    base = torch.randn(p, k, generator=g).to(dev) if accumulate else None
    ref = FM.siren_dense_dgrad_reference(
        dy, slope, w, out=None if base is None else base.clone())
    before = FM.LAUNCHES["siren_dense_dgrad"]
    got = FM.siren_dense_dgrad(dy, slope, w, out=base)
    assert FM.LAUNCHES["siren_dense_dgrad"] == before + 1
    assert got.shape == (p, k) and _rel(got, ref) <= 1e-4
    if accumulate:
        assert got.data_ptr() == base.data_ptr()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,extra,n_extra,samples,n_rays", [
    (512, 512, "xyz", 3, 16, 37),    # the skip layer
    (512, 256, "t", 4, 16, 300),     # beta_0: t_grad, more than one split
    (512, 256, "sun", 3, 64, 37),    # sun_v_0
    (0, 512, "xyz", 3, 16, 37),      # layer 0: dA and db only
    (0, 256, "sun", 3, 1, 37),       # sky_0, once a ray, no slope
    (40, 200, None, 0, 7, 37),       # SIMT shapes
    (36, 100, "t", 4, 5, 37)])
def test_siren_dense_wgrad(dev, dtype, k, n, extra, n_extra, samples, n_rays):
    rays16, z = _rays16(n_rays, samples, dev)
    g = torch.Generator().manual_seed(6)
    p = n_rays * samples
    x = (torch.rand(p, k, generator=g) * 2 - 1).to(dev, dtype) if k else None
    dy = torch.randn(p, n, generator=g).to(dev)
    slope = torch.randn(p, n, generator=g).to(dev) if samples > 1 else None
    c = (torch.randn(n_extra, n, generator=g) * 0.3).to(dev, dtype) if extra else None
    kw = dict(extra=extra, extra_weight=c, z=z, extra_grad=extra == "t")
    got = FM.siren_dense_wgrad(x, dy, slope, rays16, samples, **kw)
    ref = FM.siren_dense_wgrad_reference(x, dy, slope, rays16, samples, **kw)
    for name, a, b in zip(("dW", "db", "dC", "dE"), got, ref):
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.shape == b.shape and a.dtype == torch.float32, name
            assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta,wmix,with_noise", [
    (True, 1.0, False), (True, 0.3, True), (True, 0.0, False),
    (False, 0.0, True)])
def test_composite_loss_bwd(dev, dtype, beta, wmix, with_noise):
    """1e-4 of each tensor's largest entry; in bf16 a cotangent entry may
    also differ by one bf16 step of itself (the two sides round a value that
    differs in its last float32 bits)."""
    n_rays, n_s, feat = 37, 16, 64
    g = torch.Generator().manual_seed(7)
    p, fh = n_rays * n_s, feat // 2

    def t(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    h, r, s2 = t(p, feat), t(p, fh), t(p, fh)
    bh = t(p, fh) if beta else None
    skyh = torch.relu(t(n_rays, fh))
    wn = t(9, feat, scale=0.5)
    wn[0] *= 40  # some rays saturate early
    bn = torch.randn(9, generator=g).to(dev)
    _, z = _rays16(n_rays, n_s, dev)
    gt = torch.rand(n_rays, 3, generator=g).to(dev)
    noise = (torch.randn(n_rays, n_s, generator=g) * 2).to(dev) if with_noise else None
    args = (h, r, s2, bh, skyh, wn, bn, z, noise, gt, wmix)
    got = FM.composite_loss_bwd(*args, return_weights=True)
    ref = FM.composite_loss_bwd_reference(*args, return_weights=True)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if v is None:
            assert got[k] is None
            continue
        assert bool(torch.isfinite(got[k]).all()), k
        lim = 1e-4 * v.abs().max()
        if k.startswith("d_") and dtype == torch.bfloat16:
            lim = lim + 2.0 ** -7 * v.abs()
        assert bool(((got[k] - v).abs() <= lim).all()), (k, _rel(got[k], v))


def _narrow_inputs(dev, dtype, beta, with_noise, seed, n_rays=37):
    n_s, feat = 16, 64
    g = torch.Generator().manual_seed(seed)
    p, fh = n_rays * n_s, feat // 2

    def t(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    h, r, s2 = t(p, feat), t(p, fh), t(p, fh)
    bh = t(p, fh) if beta else None
    skyh = torch.relu(t(n_rays, fh))
    wn = t(9, feat, scale=0.5)
    wn[0] *= 40  # some rays saturate early
    bn = torch.randn(9, generator=g).to(dev)
    _, z = _rays16(n_rays, n_s, dev)
    noise = (torch.randn(n_rays, n_s, generator=g) * 2).to(dev) if with_noise else None
    return g, (h, r, s2, bh, skyh, wn, bn, z, noise)


def _hold_cotangents(got, ref, dtype, summed=()):
    """1e-4 of each tensor's largest entry; in bf16 a cotangent entry may
    also differ by one bf16 step of itself, and an entry of `summed` (a sum
    of products of several rounded cotangents) by one step of one of its
    terms, which may be larger than the entry: 2^-8 of the tensor's largest
    entry."""
    assert set(got) == set(ref)
    for k, v in ref.items():
        if v is None:
            assert got[k] is None
            continue
        assert bool(torch.isfinite(got[k]).all()), k
        lim = 1e-4 * v.abs().max()
        if k.startswith("d_") and dtype == torch.bfloat16:
            lim = lim + 2.0 ** -7 * v.abs()
            if k in summed:
                lim = lim + 2.0 ** -8 * v.abs().max()
        assert bool(((got[k] - v).abs() <= lim).all()), (k, _rel(got[k], v))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta,with_noise,pad", [
    (True, False, 0.001), (True, True, 0.3), (False, True, 0.001)])
def test_composite_bwd(dev, dtype, beta, with_noise, pad):
    """A random cotangent on all 16 columns; pad 0.3 widens the albedo range
    so that some unclipped rgb integrals leave [0, 1] and are masked."""
    g, args = _narrow_inputs(dev, dtype, beta, with_noise, 8)
    cot = torch.randn(37, 16, generator=g).to(dev)
    before = FM.LAUNCHES["composite_bwd"]
    got = FM.composite_bwd(*args, cot, rgb_padding=pad)
    assert FM.LAUNCHES["composite_bwd"] == before + 1
    ref = FM.composite_bwd_reference(*args, cot, rgb_padding=pad)
    _hold_cotangents(got, ref, dtype)


@pytest.mark.parametrize("given", [False, True], ids=["loss", "given"])
def test_composite_adjoint_at_a_faint_last_sample(dev, given):
    """sigma = 1e-10 everywhere: the inner samples are transparent and the
    last one, whose delta is 1e10, has alpha = 1 - exp(-1). Its sigma
    cotangent is d_alpha * exp(-1) * 1e10 * softplus'(pre) with softplus' =
    1e-10, which 1 - exp(-sigma) rounds to 0 in float32."""
    _, args = _narrow_inputs(dev, torch.float32, True, False, 10)
    h, r, s2, bh, skyh, wn, bn, z, noise = args
    wn[0] = 0.0
    bn[0] = -23.0
    args = (h, r, s2, bh, skyh, wn, bn, z, None)
    g = torch.Generator().manual_seed(11)
    if given:
        cot = torch.randn(37, 16, generator=g).to(dev)
        got = FM.composite_bwd(*args, cot)
        ref = FM.composite_bwd_reference(*args, cot)
    else:
        gt = torch.rand(37, 3, generator=g).to(dev)
        got = FM.composite_loss_bwd(*args, gt, 1.0)
        ref = FM.composite_loss_bwd_reference(*args, gt, 1.0)
    assert float(ref["dbn"][0].abs()) > 1e-3  # the last samples do pull on sigma
    _hold_cotangents(got, ref, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_noise,n_rays", [(False, 37), (True, 37), (True, 4)])
def test_sc_loss_bwd(dev, dtype, with_noise, n_rays):
    _, (h, _, s2, _, _, wn, bn, z, noise) = _narrow_inputs(
        dev, dtype, False, with_noise, 9, n_rays)
    before = FM.LAUNCHES["sc_loss_bwd"]
    got = FM.sc_loss_bwd(h, s2, wn, bn, z, noise, 0.1 / 3)
    assert FM.LAUNCHES["sc_loss_bwd"] == before + 1
    ref = FM.sc_loss_bwd_reference(h, s2, wn, bn, z, noise, 0.1 / 3)
    _hold_cotangents(got, ref, dtype)
    rows = [0, 1, 2, 3, 5, 6, 7, 8]
    assert float(got["dwn"][rows].abs().max()) == 0.0
    assert float(got["dbn"][rows].abs().max()) == 0.0


def _sc_inputs(dev, dtype, n_rays, n_s, fh, with_noise, seed, span=1.0):
    """A trunk of 2 fh features; sigma of order 1, so that the transmittance
    still moves past one chunk of 256 samples (z spans [0, span]), except ray
    0 of several, whose h is scaled to saturate within a few samples."""
    feat = 2 * fh
    g = torch.Generator().manual_seed(seed)
    p = n_rays * n_s

    def t(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    h, s2 = t(p, feat), t(p, fh)
    if n_rays > 1:
        h[:n_s] *= 30
    wn = t(9, feat, scale=0.5)
    wn[0] = t(feat, scale=3.0 / feat ** 0.5)
    bn = torch.randn(9, generator=g).to(dev)
    _, z = _rays16(n_rays, n_s, dev, seed)
    noise = (torch.randn(n_rays, n_s, generator=g) * 0.5).to(dev) if with_noise else None
    return h, s2, wn, bn, z * span, noise


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("n_s,n_rays,fh", [
    (64, 1024, 256), (128, 1024, 256), (128, 1000, 96), (64, 1, 96),
    # past one chunk of 256 samples: the product carried from chunk to chunk
    (320, 1024, 48), (320, 1000, 256), (320, 1, 256),
    # the most samples shared memory holds (sc_max_samples)
    (None, 1, 256), (None, 1, 48)])
def test_sc_loss_bwd_block(dev, dtype, with_noise, n_s, n_rays, fh):
    """sc_loss_bwd, a block a ray, against its plain version: 1e-4 of each
    tensor's largest entry, in bf16 a d_s2 entry also one step of itself
    (the scan multiplies T in another order than the plain cumprod and may
    round a cotangent to the other side of a bf16 boundary). In bf16, dWn
    row 4 sums those rounded cotangents times s2: over a ray of thousands of
    samples the flips the d_s2 check allows add up past 1e-4 of the row, so
    the row is held to 1e-4 of its largest entry against the sum of the
    kernel's own rounded cotangents (d_s2 / w_sun, exact: a product of two
    bf16 values) times s2, in float64. At the most samples a ray the depths
    keep the 320-sample cases' spacing (z spans [0, S / 320]): over [0, 1]
    the 18,000 factors 1 - alpha lie within 1e-4 of 1, where fp32's
    1 - exp(-x) keeps three digits, and two fp32 evaluations of the plain
    version (on the card, on the CPU) differ past 1e-4 in dbn[4]
    (tools/outputs_torch.py faint; PERF.md section 7). Fh 48 and 96 are not
    multiples of 32 lanes' chunks."""
    span = 1.0
    if n_s is None:
        n_s = FM.sc_max_samples(2 * fh, fh)
        span = n_s / 320
    h, s2, wn, bn, z, noise = _sc_inputs(dev, dtype, n_rays, n_s, fh, with_noise, 30, span)
    before = dict(FM.LAUNCHES)
    got = FM.sc_loss_bwd(h, s2, wn, bn, z, noise, 0.1 / 3)
    assert _grown(before) == {"sc_loss_bwd": 1}
    ref = FM.sc_loss_bwd_reference(h, s2, wn, bn, z, noise, 0.1 / 3)
    if dtype == torch.bfloat16:
        col = int(wn[4, :fh].float().abs().argmax())
        gb = got["d_s2"][:, col].double() / wn[4, col].double()
        own = gb @ s2.double()
        err = (got["dwn"][4, :fh].double() - own).abs().max()
        assert float(err) <= 1e-4 * float(ref["dwn"][4].abs().max()), float(err)
        ref = dict(ref, dwn=got["dwn"])
    _hold_cotangents(got, ref, dtype)
    rows = [0, 1, 2, 3, 5, 6, 7, 8]
    assert float(got["dwn"][rows].abs().max()) == 0.0
    assert float(got["dwn"][4, fh:].abs().max()) == 0.0
    assert float(got["dbn"][rows].abs().max()) == 0.0


def test_sc_loss_bwd_refuses_past_its_sample_limit(dev):
    """One sample a ray past what shared memory holds (18,417 at F = 512) is
    refused before any launch, with the 227 KB limit and the largest S
    named."""
    n_s = FM.sc_max_samples(512, 256)
    h, s2, wn, bn, z, _ = _sc_inputs(dev, torch.bfloat16, 1, n_s + 1, 256, False, 31)
    before = dict(FM.LAUNCHES)
    with pytest.raises(ValueError, match=rf"227 KB.*at most {n_s} at F=512, Fh=256"):
        FM.sc_loss_bwd(h, s2, wn, bn, z, None, 0.1 / 3)
    assert FM.LAUNCHES == before


def _grown(before: dict) -> dict:
    """The kernels launched since `before` = dict(FM.LAUNCHES), with counts."""
    return {k: FM.LAUNCHES[k] - before[k] for k in before
            if FM.LAUNCHES[k] != before[k]}


def _field_inputs(dev, variant, layers=8, feat=96, n_rays=53, n_s=24):
    field = build_model(variant, layers, feat,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    g = torch.Generator().manual_seed(4)
    o = (torch.rand(n_rays, 3, generator=g) - 0.5).to(dev)
    d = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=g)).to(dev)
    sun = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=g)).to(dev)
    t = torch.randn(n_rays, 4, generator=g).to(dev)
    z = torch.sort(torch.rand(n_rays, n_s, generator=g), 1).values.to(dev)
    noise = (torch.randn(n_rays, n_s, generator=g) * 0.5).to(dev)
    return field, g, o, d, sun, t, z, noise


@pytest.mark.parametrize("variant,with_noise", [
    ("sat-nerf", True), ("sat-nerf", False), ("s-nerf", True)])
def test_fused_sc_loss_grads_fp32(dev, variant, with_noise):
    """The whole K3 chain in fp32 at a narrow, non-tile width against
    autograd through the field module: 1e-3 of each gradient's largest entry
    (summation order and atomics only), zeros where autograd has zeros."""
    use_beta = variant == "sat-nerf"
    field, _, o, _, sun, t, z, noise = _field_inputs(dev, variant)
    kw = dict(layers=8, feat=96, use_beta=use_beta, dtype=torch.float32)
    args = (field, o, sun, t if use_beta else None, z,
            noise if with_noise else None, 0.1)
    before = dict(FM.LAUNCHES)
    parts, grads = FM.fused_sc_loss_grads(*args, **kw)
    # fp32: every wgrad GEMM is SIMT (11 of them: layer 0 has none), so
    # narrow_grads sums db of each layer, sun_v_0's job in a launch of its own
    assert _grown(before) == {"siren_dense": 12, "sc_loss_bwd": 1,
                              "siren_dense_dgrad": 11, "siren_dense_wgrad": 11,
                              "narrow_grads": 12}
    r_parts, r_grads = FM.fused_sc_loss_grads_reference(*args, **kw)
    for k in r_parts:
        assert abs(float(parts[k]) - float(r_parts[k])) <= 1e-5, k
    assert set(grads) == set(r_grads) == {n for n, _ in field.named_parameters()}
    for name, ref in r_grads.items():
        assert grads[name].shape == ref.shape, name
        if float(ref.abs().max()) == 0.0:
            assert float(grads[name].abs().max()) == 0.0, name
        else:
            assert _rel(grads[name], ref) <= 1e-3, (name, _rel(grads[name], ref))
    assert all(p.grad is None for p in field.parameters())


@pytest.mark.parametrize("variant,with_noise", [
    ("sat-nerf", True), ("sat-nerf", False), ("s-nerf", True)])
def test_fused_train_render_rays_fp32(dev, variant, with_noise):
    """K4 forward and backward in fp32 against plain autograd through the
    field module, a random cotangent on every product: products 1e-4,
    gradients 1e-3 of each tensor's largest entry."""
    use_beta = variant == "sat-nerf"
    field, g, o, d, sun, t, z, noise = _field_inputs(dev, variant)
    kw = dict(layers=8, feat=96, use_beta=use_beta, dtype=torch.float32)
    nz = noise if with_noise else None
    cots = None

    def run(fn):
        nonlocal cots
        t_leaf = t.clone().requires_grad_(True) if use_beta else None
        out = fn(field, o, d, sun, t_leaf, z, nz, **kw)
        if cots is None:
            cots = {k: torch.randn(v.shape, generator=g).to(dev)
                    for k, v in out.items()}
        total = sum((out[k] * cots[k]).sum() for k in out)
        leaves = list(field.parameters()) + ([t_leaf] if use_beta else [])
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        return out, grads

    before = dict(FM.LAUNCHES)
    out, grads = run(FM.fused_train_render_rays)
    assert _grown(before) == {
        "siren_dense": 15 if use_beta else 14, "heads_composite": 1,
        "composite_bwd": 1, "siren_dense_dgrad": 13 if use_beta else 12,
        "siren_dense_wgrad": 13 if use_beta else 12, "narrow_grads": 13}
    r_out, r_grads = run(FM.fused_train_render_rays_reference)
    assert set(out) == set(r_out)
    for k in r_out:
        np.testing.assert_allclose(out[k].detach().cpu().numpy(),
                                   r_out[k].detach().cpu().numpy(), atol=1e-4,
                                   err_msg=k)
    names = [n for n, _ in field.named_parameters()] + (["t_embed"] if use_beta else [])
    for name, got, ref in zip(names, grads, r_grads):
        assert got is not None and got.shape == ref.shape, name
        assert _rel(got, ref) <= 1e-3, (name, _rel(got, ref))


@pytest.mark.parametrize("variant,layers,wmix", [
    ("sat-nerf", 8, 1.0), ("sat-nerf", 8, 0.0), ("s-nerf", 8, 0.0),
    ("sat-nerf", 4, 1.0)])
def test_fused_train_loss_grads_fp32(dev, variant, layers, wmix):
    """The whole chain in fp32 at a narrow, non-tile width against autograd
    through the field module: every gradient by name, 1e-3 of its largest
    entry (summation order and atomics only)."""
    use_beta = variant == "sat-nerf"
    field = build_model(variant, layers, 96,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    g = torch.Generator().manual_seed(4)
    n_rays, n_s = 53, 24
    o = (torch.rand(n_rays, 3, generator=g) - 0.5).to(dev)
    d = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=g)).to(dev)
    sun = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=g)).to(dev)
    t = torch.randn(n_rays, 4, generator=g).to(dev)
    z = torch.sort(torch.rand(n_rays, n_s, generator=g), 1).values.to(dev)
    gt = torch.rand(n_rays, 3, generator=g).to(dev)
    noise = (torch.randn(n_rays, n_s, generator=g) * 0.5).to(dev)
    kw = dict(layers=layers, feat=96, use_beta=use_beta, dtype=torch.float32,
              return_weights=True)
    args = (field, o, d, sun, t if use_beta else None, z, noise, gt, wmix)
    before = dict(FM.LAUNCHES)
    parts, grads, t_grad, w = FM.fused_train_loss_grads(*args, **kw)
    for name in ("siren_dense", "composite_loss_bwd", "siren_dense_dgrad",
                 "siren_dense_wgrad"):
        assert FM.LAUNCHES[name] > before[name], name
    r_parts, r_grads, r_t, r_w = FM.fused_train_loss_grads_reference(*args, **kw)
    for k in r_parts:
        assert abs(float(parts[k]) - float(r_parts[k])) <= 1e-5, k
    assert set(grads) == set(r_grads) == {n for n, _ in field.named_parameters()}
    for name, ref in r_grads.items():
        assert grads[name].shape == ref.shape, name
        assert _rel(grads[name], ref) <= 1e-3, (name, _rel(grads[name], ref))
    if use_beta:
        assert _rel(t_grad, r_t) <= 1e-3
    assert float((w - r_w).abs().max()) <= 1e-5
    assert all(p.grad is None for p in field.parameters())


def test_train_step_on_the_card_goes_through_the_kernels(dev):
    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.train.system import NeRFSystem

    cfg = Config(model="sat-nerf", fc_layers=8, fc_units=64, n_samples=16,
                 batch_size=128, first_beta_epoch=0, lr=1e-3)
    system = NeRFSystem(cfg, dataset_len=1024)
    assert system.device.type == "cuda"
    state = system.init_state(0)
    g = torch.Generator().manual_seed(1)
    rays = torch.rand(1024, 11, generator=g)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    data = {"rays": rays.to(dev), "rgbs": torch.rand(1024, 3, generator=g).to(dev),
            "ts": torch.randint(0, 5, (1024,), generator=g).to(dev)}
    gen = jax_prng.prng_key(2)
    before = dict(FM.LAUNCHES)
    w0 = state.params["nerf_coarse"].fc_net[0].weight.detach().clone()
    losses = [float(system.train_step(state, data, gen)["loss"])
              for _ in range(20)]
    assert state.step == 20 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert not torch.equal(w0, state.params["nerf_coarse"].fc_net[0].weight)
    assert FM.LAUNCHES["composite_loss_bwd"] == before["composite_loss_bwd"] + 20


@pytest.mark.parametrize("options", [
    dict(), dict(grad_accum=2), dict(sampling="shuffle")], ids=str)
def test_full_recipe_step_on_the_card(dev, options):
    """SC + DS on: every step launches sc_loss_bwd once a micro-batch,
    heads_composite once a micro-batch and composite_bwd while the depth term
    is active (steps whose 1-based count is below ds_drop_step)."""
    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.train.system import NeRFSystem

    steps, accum = 12, options.get("grad_accum", 1)
    cfg = Config(model="sat-nerf", fc_layers=8, fc_units=64, n_samples=16,
                 batch_size=128, first_beta_epoch=1, lr=1e-3, sc_lambda=0.1,
                 ds_lambda=10.0, ds_drop=0.5, max_train_steps=steps, **options)
    system = NeRFSystem(cfg, dataset_len=1024)
    assert system.ds_drop_step == 6
    state = system.init_state(0)
    g = torch.Generator().manual_seed(1)
    rays = torch.rand(1024, 11, generator=g)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    d_rays = rays[:200].clone()
    data = {"rays": rays.to(dev), "rgbs": torch.rand(1024, 3, generator=g).to(dev),
            "ts": torch.randint(0, 5, (1024,), generator=g).to(dev),
            "d_rays": d_rays.to(dev),
            "d_depths": torch.rand(200, 2, generator=g).to(dev),
            "d_ts": torch.randint(0, 5, (200,), generator=g).to(dev)}
    if cfg.sampling == "shuffle":
        data["perm"] = system.epoch_perm(1024, 0)
    gen = jax_prng.prng_key(2)
    before = dict(FM.LAUNCHES)
    emb0 = state.params["embedding_t"].weight.detach().clone()
    ms = [system.train_step(state, data, gen) for _ in range(steps)]
    assert state.step == steps
    assert all(np.isfinite(float(m["loss"])) and np.isfinite(float(m["loss_depth"]))
               for m in ms)
    grown = {k: FM.LAUNCHES[k] - before[k] for k in before}
    assert grown["sc_loss_bwd"] == steps * accum
    assert grown["composite_loss_bwd"] == steps * accum
    assert grown["heads_composite"] == steps * accum
    assert grown["composite_bwd"] == 5 * accum  # steps 0..4: step + 1 < 6
    assert not torch.equal(emb0, state.params["embedding_t"].weight)


def test_kernel_refuses_bad_inputs(dev):
    rays16, z = _rays16(4, 8, dev)
    w = torch.zeros(16, 32, device=dev)
    b = torch.zeros(32, device=dev)
    x = torch.zeros(32, 16, device=dev, dtype=torch.bfloat16)  # dtype mismatch
    with pytest.raises(ValueError):
        FM.siren_dense(x, w, b, rays16, 8)
    with pytest.raises(ValueError):  # not contiguous
        FM.siren_dense(torch.zeros(16, 32, device=dev).T, w, b, rays16, 8)
    dy = torch.zeros(32, 32, device=dev)
    with pytest.raises(ValueError):  # a relu layer has no slope to save
        FM.siren_dense(None, None, b, rays16, 8, extra="sun",
                       extra_weight=torch.zeros(3, 32, device=dev), act="relu",
                       save=True)
    with pytest.raises(ValueError):  # slope of another shape
        FM.siren_dense_dgrad(dy, torch.zeros(32, 16, device=dev), w)
    with pytest.raises(TypeError):  # an operand type the kernels do not take
        FM.siren_dense_dgrad(dy, None, w.half())
    z16 = torch.zeros(4, 8, device=dev)
    h = torch.zeros(32, 64, device=dev)
    half = torch.zeros(32, 32, device=dev)
    wn, bn = torch.zeros(9, 64, device=dev), torch.zeros(9, device=dev)
    with pytest.raises(ValueError):  # a cotangent of another shape
        FM.composite_bwd(h, half, half, None, torch.zeros(4, 32, device=dev),
                         wn, bn, z16, None, torch.zeros(4, 3, device=dev))
    with pytest.raises(ValueError):  # noise of another shape
        FM.sc_loss_bwd(h, half, wn, bn, z16, torch.zeros(4, 7, device=dev), 0.1)
    with pytest.raises(ValueError):
        FM.heads_composite(h, half, half, None, torch.zeros(4, 32, device=dev),
                           wn, bn, z16, noise=torch.zeros(8, 4, device=dev))


# --------------------------------------------------- the per-sample field


def _heads_inputs(dev, dtype, beta, n_rays, n_s, seed, feat=64):
    g = torch.Generator().manual_seed(seed)
    p, fh = n_rays * n_s, feat // 2

    def t(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    h, r, s2 = t(p, feat), t(p, fh), t(p, fh)
    bh = t(p, fh) if beta else None
    skyh = torch.relu(t(n_rays, fh))
    wn, bn = t(9, feat, scale=0.5), torch.randn(9, generator=g).to(dev)
    cot = torch.randn(p, 16, generator=g).to(dev)
    return (h, r, s2, bh, skyh, wn, bn, n_s), cot


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta,n_rays,n_s,feat", [
    (True, 37, 1, 64), (True, 37, 72, 64), (False, 37, 128, 64),
    (True, 5, 128, 512), (True, 1037, 1, 100)])
def test_field_heads(dev, dtype, beta, n_rays, n_s, feat):
    """Every point count here leaves the last block and the last warp
    ragged; feat 100 leaves the last lane's columns ragged too."""
    args, _ = _heads_inputs(dev, dtype, beta, n_rays, n_s, 20, feat)
    before = dict(FM.LAUNCHES)
    out = FM.field_heads(*args)
    assert _grown(before) == {"field_heads": 1}
    ref = FM.field_heads_reference(*args)
    assert out.shape == ref.shape == (n_rays * n_s, 16)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    assert float(out[:, 9:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta,n_rays,n_s,feat", [
    (True, 37, 1, 64), (True, 37, 72, 64), (False, 37, 128, 64),
    (True, 5, 128, 512), (True, 1037, 1, 100)])
def test_field_heads_bwd(dev, dtype, beta, n_rays, n_s, feat):
    args, cot = _heads_inputs(dev, dtype, beta, n_rays, n_s, 21, feat)
    before = dict(FM.LAUNCHES)
    got = FM.field_heads_bwd(*args, cot)
    assert _grown(before) == {"field_heads_bwd": 1}
    ref = FM.field_heads_bwd_reference(*args, cot)
    _hold_cotangents(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta,n_rays,n_s,feat", [
    (True, 37, 1, 96), (False, 1037, 1, 512), (True, 131, 1, 256),
    (True, 37, 64, 256), (False, 1000, 64, 512), (True, 3, 64, 96),
    (True, 1024, 128, 512), (False, 37, 128, 96), (True, 131072, 1, 512)])
def test_field_heads_bwd_stream(dev, dtype, beta, n_rays, n_s, feat):
    """The streaming field_heads_bwd (the sky head folded in) against its
    plain version at the widths of the presets (F 96, 256, 512), S = 1
    (every point its own ray, K6), 64 and 128, with and without the beta
    head, point counts that leave the persistent grid's last round of warps
    ragged, and 131,072 points (1,024 x 128 and K6's), where every block
    walks many points: _hold_cotangents, with d_r and d_skyh (each a sum
    over the three color channels of a rounded cotangent times a weight)
    held as sums of terms. Read on the card (H100 80GB HBM3): at F = 512 in
    bf16 d_r came out 3.4e-4 of its largest entry off the plain version,
    past one step of the entry: where a color channel's cotangent rounds to
    the other bf16 neighbour (the two forwards sum r . w in another order),
    d_r moves by one step of that term, larger than the entry where the
    terms cancel. d_skyh held to one step of the entry failed at 131,072
    points of one sample each (seed 28, F = 512, bf16, beta on): 1.2e-3 of
    its largest entry off, past the 1e-4 of the largest entry the check
    allows beside a step of the entry, within the step of a term (2^-8 of
    the largest entry, 3.9e-3): there 393,216 sky cotangents of random rows
    are rounded, each a chance to round to the other neighbour
    (chip_smoke.py's K6 launch, 65,573 points of the field's own rows, holds
    d_skyh to a step of the entry and passed in the same call)."""
    args, cot = _heads_inputs(dev, dtype, beta, n_rays, n_s, 28, feat)
    before = dict(FM.LAUNCHES)
    got = FM.field_heads_bwd(*args, cot)
    assert _grown(before) == {"field_heads_bwd": 1}
    ref = FM.field_heads_bwd_reference(*args, cot)
    _hold_cotangents(got, ref, dtype, summed=("d_r", "d_skyh"))
    if not beta:
        assert float(got["dwn"][8].abs().max()) == 0.0 and float(got["dbn"][8]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta,n_rays,n_s,feat", [
    (True, 1037, 1, 512), (False, 1037, 1, 96), (True, 131, 1, 256),
    (True, 1000, 64, 256), (False, 1000, 64, 512), (True, 3, 64, 96),
    (True, 1024, 128, 512), (False, 37, 128, 96)])
def test_field_heads_stream(dev, dtype, beta, n_rays, n_s, feat):
    """The streaming field_heads against its plain version at the widths of
    the presets (F 96, 256, 512), S = 1 (every point its own ray, K6), 64
    and 128, with and without the beta head: 1e-5 (the same products summed
    in another order). Every point count but 1,024 x 128 leaves the last
    block of 128 points ragged; 1,000 x 64 puts a ray across blocks."""
    args, _ = _heads_inputs(dev, dtype, beta, n_rays, n_s, 23, feat)
    before = dict(FM.LAUNCHES)
    out = FM.field_heads(*args)
    assert _grown(before) == {"field_heads": 1}
    ref = FM.field_heads_reference(*args)
    assert out.shape == ref.shape == (n_rays * n_s, 16)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    assert float(out[:, 9:].abs().max()) == 0.0
    if not beta:
        assert float(out[:, 8].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_field_heads_at_a_faint_sigma(dev, dtype):
    """A sigma of 1e-10 (softplus of -23) comes out as the plain version's to
    1e-4 of itself: no cancellation in the kernel's softplus."""
    (h, r, s2, bh, skyh, wn, bn, n_s), _ = _heads_inputs(dev, dtype, True, 37, 16, 24)
    wn[0] = 0.0
    bn[0] = -23.0
    args = (h, r, s2, bh, skyh, wn, bn, n_s)
    out, ref = FM.field_heads(*args), FM.field_heads_reference(*args)
    assert 0.0 < float(ref[:, 3].min()) < 1e-9
    assert float(((out[:, 3] - ref[:, 3]).abs() / ref[:, 3]).max()) <= 1e-4
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)


def test_field_heads_bwd_at_a_faint_sigma(dev):
    """A sigma of 1e-10: softplus' is 1e-10 too, which 1 - exp(-sigma)
    rounds to 0 in float32 and -expm1(-sigma) keeps."""
    (h, r, s2, bh, skyh, wn, bn, n_s), cot = _heads_inputs(
        dev, torch.float32, True, 37, 16, 22)
    wn[0] = 0.0
    bn[0] = -23.0
    cot[:, 3] = cot[:, 3].abs() + 1.0
    args = (h, r, s2, bh, skyh, wn, bn, n_s)
    got = FM.field_heads_bwd(*args, cot)
    ref = FM.field_heads_bwd_reference(*args, cot)
    assert float(ref["dbn"][0]) > 1e-9
    assert abs(float(got["dbn"][0]) / float(ref["dbn"][0]) - 1.0) <= 1e-4
    _hold_cotangents(got, ref, torch.float32)


def _field_contract(out, cots):
    return sum((out[k] * cots[k]).sum() for k in out)


@pytest.mark.parametrize("variant,n_s", [("sat-nerf", 24), ("s-nerf", 24),
                                         ("sat-nerf", 72)])
def test_fused_field_apply_rays_fp32(dev, variant, n_s):
    """K5 forward and backward in fp32 at a narrow, non-tile width against
    plain autograd through the field module, a random cotangent on every
    per-sample output: outputs 1e-4, gradients 1e-3 of each tensor's largest
    entry."""
    use_beta = variant == "sat-nerf"
    field, g, o, d, sun, t, z, _ = _field_inputs(dev, variant, n_s=n_s)
    kw = dict(layers=8, feat=96, use_beta=use_beta, dtype=torch.float32)
    cots = None

    def run(fn):
        nonlocal cots
        t_leaf = t.clone().requires_grad_(True) if use_beta else None
        out = fn(field, o, d, sun, t_leaf, z, **kw)
        if cots is None:
            cots = {k: torch.randn(v.shape, generator=g).to(dev)
                    for k, v in out.items()}
        leaves = list(field.parameters()) + ([t_leaf] if use_beta else [])
        return out, torch.autograd.grad(_field_contract(out, cots), leaves,
                                        allow_unused=True)

    before = dict(FM.LAUNCHES)
    out, grads = run(FM.fused_field_apply_rays)
    assert _grown(before) == {
        "siren_dense": 15 if use_beta else 14, "field_heads": 1,
        "field_heads_bwd": 1, "siren_dense_dgrad": 13 if use_beta else 12,
        "siren_dense_wgrad": 13 if use_beta else 12, "narrow_grads": 13}
    r_out, r_grads = run(FM.fused_field_apply_rays_reference)
    assert set(out) == set(r_out)
    for k in r_out:
        assert out[k].shape == r_out[k].shape, k
        np.testing.assert_allclose(out[k].detach().cpu().numpy(),
                                   r_out[k].detach().cpu().numpy(), atol=1e-4,
                                   err_msg=k)
    names = [n for n, _ in field.named_parameters()] + (["t_embed"] if use_beta else [])
    for name, got, ref in zip(names, grads, r_grads):
        assert got is not None and got.shape == ref.shape, name
        assert _rel(got, ref) <= 1e-3, (name, _rel(got, ref))
    # without a graph the forward saves nothing and launches the serving chain
    before = dict(FM.LAUNCHES)
    with torch.no_grad():
        quiet = FM.fused_field_apply_rays(field, o, d, sun, t, z, **kw)
    assert _grown(before) == {"siren_dense": 15 if use_beta else 14,
                              "field_heads": 1}
    for k in out:
        assert quiet[k].grad_fn is None
        assert float((quiet[k] - out[k].detach()).abs().max()) <= 1e-6, k


@pytest.mark.parametrize("variant", ["sat-nerf", "s-nerf"])
def test_fused_field_apply_fp32(dev, variant):
    """K6 on points of leading shape (53, 7), every point with its own sun
    direction and embedding: outputs 1e-4; parameter gradients and the
    gradients of xyz, sun_dir and t_embed 1e-3 of each tensor's largest
    entry."""
    use_beta = variant == "sat-nerf"
    field, g, *_ = _field_inputs(dev, variant)
    lead = (53, 7)
    xyz = (torch.rand(*lead, 3, generator=g) - 0.5).to(dev)
    sun = torch.nn.functional.normalize(
        torch.randn(*lead, 3, generator=g), dim=-1).to(dev)
    t = torch.randn(*lead, 4, generator=g).to(dev)
    kw = dict(layers=8, feat=96, use_beta=use_beta, dtype=torch.float32)
    cots = None

    def run(fn):
        nonlocal cots
        ins = [xyz.clone().requires_grad_(True), sun.clone().requires_grad_(True)]
        if use_beta:
            ins.append(t.clone().requires_grad_(True))
        out = fn(field, *ins, **kw)
        if cots is None:
            cots = {k: torch.randn(v.shape, generator=g).to(dev)
                    for k, v in out.items()}
        return out, torch.autograd.grad(_field_contract(out, cots),
                                        list(field.parameters()) + ins,
                                        allow_unused=True)

    before = dict(FM.LAUNCHES)
    out, grads = run(FM.fused_field_apply)
    assert _grown(before)["field_heads_bwd"] == 1
    r_out, r_grads = run(FM.fused_field_apply_reference)
    for k in r_out:
        assert out[k].shape == r_out[k].shape, k
        np.testing.assert_allclose(out[k].detach().cpu().numpy(),
                                   r_out[k].detach().cpu().numpy(), atol=1e-4,
                                   err_msg=k)
    names = [n for n, _ in field.named_parameters()] + ["xyz", "sun_dir", "t_embed"]
    for name, got, ref in zip(names, grads, r_grads):
        assert got is not None and got.shape == ref.shape, name
        assert _rel(got, ref) <= 1e-3, (name, _rel(got, ref))


@pytest.mark.parametrize("fused,n_imp", [("rays", 8), ("on", 8), ("off", 8),
                                         ("rays", 64)])
def test_hierarchical_step_and_render_on_the_card(dev, fused, n_imp):
    """A hierarchical full-recipe step and a render in each --fused mode:
    rays goes through the per-ray kernels twice and K5 in the depth pass,
    on through K6, off launches nothing."""
    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.train.system import NeRFSystem

    n = 512
    cfg = Config(model="sat-nerf", fc_layers=8, fc_units=64, n_samples=16,
                 n_importance=n_imp, batch_size=128, max_train_steps=20,
                 sc_lambda=0.1, ds_lambda=10.0, ds_drop=0.3, fused=fused,
                 first_beta_epoch=1, chunk=256)
    system = NeRFSystem(cfg, device=dev, dataset_len=n)
    g = torch.Generator().manual_seed(6)
    rays = torch.rand(n, 11, generator=g)
    rays[:, 3:6] = torch.nn.functional.normalize(rays[:, 3:6], dim=1)
    rays[:, 8:11] = torch.nn.functional.normalize(rays[:, 8:11], dim=1)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    data = {"rays": rays.to(dev), "rgbs": torch.rand(n, 3, generator=g).to(dev),
            "ts": torch.randint(0, 5, (n,), generator=g).to(dev)}
    data.update(d_rays=data["rays"][:64].clone(),
                d_depths=torch.rand(64, 2, generator=g).to(dev),
                d_ts=data["ts"][:64].clone())
    state = system.init_state(0)
    gen = jax_prng.prng_key(1)
    steps = 8
    before = dict(FM.LAUNCHES)
    for _ in range(steps):
        m = system.train_step(state, data, gen)
        assert all(bool(torch.isfinite(torch.as_tensor(v)).all())
                   for v in m.values())
    grown = _grown(before)
    active = 5  # steps 0..4: step + 1 < 6
    if fused == "rays":
        assert grown["composite_loss_bwd"] == 2 * steps
        assert grown["sc_loss_bwd"] == 2 * steps
        assert grown["field_heads"] == 2 * steps
        assert grown["field_heads_bwd"] == 2 * active
        assert "composite_bwd" not in grown and "heads_composite" not in grown
    elif fused == "on":
        # per model: the color render, its sun-ray pass and the depth render
        assert grown["field_heads"] == 6 * steps
        assert grown["field_heads_bwd"] == 4 * steps + 2 * active
        assert "composite_loss_bwd" not in grown and "sc_loss_bwd" not in grown
    else:
        assert grown == {}
    before = dict(FM.LAUNCHES)
    out = system.render_image(state.params, rays.numpy(), data["ts"].cpu().numpy())
    grown = _grown(before)
    assert out["rgb_fine"].shape == (n, 3) and np.isfinite(out["depth_fine"]).all()
    if fused == "rays":
        assert grown["heads_composite"] == 4 and "field_heads" not in grown
    elif fused == "on":
        assert grown["field_heads"] == 4 and "field_heads_bwd" not in grown
    else:
        assert grown == {}


# ------------------------------------------------- the classic NeRF variant


def _rays8(n_rays, n_s, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand(n_rays, 3, generator=g) - 0.5
    d = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=g))
    z = torch.sort(torch.rand(n_rays, n_s, generator=g), dim=1).values
    return FN.pack_rays(o, d).to(dev), z.to(dev)


def _enc_weight(n_freq, n, g, dev, dtype):
    c = torch.randn(FN._enc_rows(n_freq), n, generator=g) * 0.3
    c[6 * n_freq:] = 0
    return c.to(dev, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,enc,n_freq,samples,act", [
    (0, 256, "xyz", 10, 16, "relu"),     # trunk layer 0: no X
    (256, 256, None, 0, 16, "relu"),     # trunk layer
    (256, 256, "xyz", 10, 16, "relu"),   # skip layer
    (256, 256, None, 0, 16, "none"),     # feats
    (256, 128, "dir", 4, 16, "relu"),    # rgb_0
    (256, 128, "dir", 4, 1, "relu"),     # rgb_0 on points that are their own rays
    (40, 200, "xyz", 10, 7, "relu"),     # ragged column tile, short K
    (36, 100, "dir", 4, 5, "relu"),      # K and N not multiples of 8: SIMT
    (0, 100, "xyz", 3, 5, "relu"),       # 18 encoding columns in 32 rows
])
def test_nerf_dense(dev, dtype, k, n, enc, n_freq, samples, act):
    n_rays = 37
    rays8, z = _rays8(n_rays, samples, dev)
    g = torch.Generator().manual_seed(1)
    p = n_rays * samples
    x = (torch.rand(p, k, generator=g) * 2 - 1).to(dev, dtype) if k else None
    w = (torch.randn(k, n, generator=g) * 0.1).to(dev, dtype) if k else None
    b = torch.randn(n, generator=g).to(dev)
    c = _enc_weight(n_freq, n, g, dev, dtype) if enc else None
    kw = dict(enc=enc, enc_weight=c, z=z, n_freq=n_freq, act=act)
    before = FM.LAUNCHES["nerf_dense"]
    got = FN.nerf_dense(x, w, b, rays8, samples, **kw)
    assert FM.LAUNCHES["nerf_dense"] == before + 1
    ref = FN.nerf_dense_reference(x, w, b, rays8, samples, **kw)
    assert got.dtype == dtype and got.shape == (p, n)
    if act == "relu":
        assert float(got.float().min()) >= 0
    _close(got, ref, dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,masked,accumulate", [
    (256, 256, True, False), (256, 128, True, True), (256, 256, False, True),
    (40, 200, True, False), (36, 100, True, True)])
def test_nerf_dense_dgrad(dev, dtype, k, n, masked, accumulate):
    p = 37 * 16 + 5
    g = torch.Generator().manual_seed(5)
    dy = torch.randn(p, n, generator=g).to(dev)
    y = torch.relu(torch.randn(p, n, generator=g)).to(dev, dtype) if masked else None
    w = (torch.randn(k, n, generator=g) * 0.1).to(dev, dtype)
    base = torch.randn(p, k, generator=g).to(dev) if accumulate else None
    ref = FN.nerf_dense_dgrad_reference(
        dy, y, w, out=None if base is None else base.clone())
    before = FM.LAUNCHES["nerf_dense_dgrad"]
    got = FN.nerf_dense_dgrad(dy, y, w, out=base)
    assert FM.LAUNCHES["nerf_dense_dgrad"] == before + 1
    assert got.shape == (p, k) and _rel(got, ref) <= 1e-4
    if accumulate:
        assert got.data_ptr() == base.data_ptr()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,enc,n_freq,samples,n_rays,masked", [
    (256, 256, "xyz", 10, 16, 37, True),    # the skip layer: dW, db, dC
    (256, 128, "dir", 4, 16, 300, True),    # rgb_0: several splits of both kinds
    (0, 256, "xyz", 10, 16, 37, True),      # layer 0: dA and db only
    (256, 256, None, 0, 16, 37, False),     # feats: linear, no mask
    (256, 128, "dir", 4, 1, 700, True),     # points that are their own rays
    (40, 200, None, 0, 7, 37, True),        # SIMT shapes
    (36, 100, "xyz", 3, 5, 37, True)])
def test_nerf_dense_wgrad(dev, dtype, k, n, enc, n_freq, samples, n_rays, masked):
    rays8, z = _rays8(n_rays, samples, dev)
    g = torch.Generator().manual_seed(6)
    p = n_rays * samples
    x = (torch.rand(p, k, generator=g) * 2 - 1).to(dev, dtype) if k else None
    dy = torch.randn(p, n, generator=g).to(dev)
    y = torch.relu(torch.randn(p, n, generator=g)).to(dev, dtype) if masked else None
    kw = dict(enc=enc, z=z, n_freq=n_freq,
              enc_rows=FN._enc_rows(n_freq) if enc else 0, dtype=dtype)
    before = FM.LAUNCHES["nerf_dense_wgrad"]
    got = FN.nerf_dense_wgrad(x, dy, y, rays8, samples, **kw)
    assert FM.LAUNCHES["nerf_dense_wgrad"] == before + 1
    ref = FN.nerf_dense_wgrad_reference(x, dy, y, rays8, samples, **kw)
    for name, a, b in zip(("dW", "db", "dC"), got, ref):
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.shape == b.shape and a.dtype == torch.float32, name
            assert _rel(a, b) <= 1e-4, (name, _rel(a, b))
    if enc:  # the padded rows of the encoding's gradient stay 0
        assert float(got[2][6 * n_freq:].abs().max()) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_nerf_relu_kink(dev, dtype):
    """Units exactly at the kink: a bias of 0, no X and a zero encoding
    weight give a pre-activation of exactly 0 on one column and exactly its
    bias on the others. The forward stores 0 there, and the backward, which
    masks on the stored activation (y > 0), passes no cotangent: kernel and
    plain version agree entry by entry, whatever the sign of an ulp."""
    n_rays, samples, n = 37, 4, 64
    rays8, z = _rays8(n_rays, samples, dev)
    g = torch.Generator().manual_seed(8)
    c = torch.zeros(64, n).to(dev, dtype)
    b = torch.rand(n, generator=g).to(dev) - 0.5
    b[0] = 0.0
    kw = dict(enc="xyz", enc_weight=c, z=z, n_freq=10)
    y = FN.nerf_dense(None, None, b, rays8, samples, **kw)
    ref = FN.nerf_dense_reference(None, None, b, rays8, samples, **kw)
    assert torch.equal(y.float(), ref.float())
    assert float(y[:, 0].abs().max()) == 0
    p = n_rays * samples
    dy = torch.randn(p, n, generator=g).to(dev)
    w = (torch.randn(32, n, generator=g) * 0.1).to(dev, dtype)
    dx = FN.nerf_dense_dgrad(dy, y, w)
    dead = (b <= 0)
    want = FN.nerf_dense_dgrad_reference(dy * (~dead), None, w)
    assert _rel(dx, want) <= 1e-4
    _, db, dc = FN.nerf_dense_wgrad(None, dy, y, rays8, samples, enc="xyz",
                                    z=z, n_freq=10, enc_rows=64, dtype=dtype)
    assert float(db[dead].abs().max()) == 0 and float(dc[:, dead].abs().max()) == 0
    assert float(db[~dead].abs().min()) > 0


def _nerf_narrow(dev, dtype, with_noise, seed, n_rays=37, n_s=16, feat=64):
    g = torch.Generator().manual_seed(seed)
    p, fh = n_rays * n_s, feat // 2

    def t(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    h, r = t(p, feat), torch.relu(t(p, fh))
    wn = t(4, feat, scale=0.5)
    wn[0] *= 40  # some rays saturate early
    wn[1:, fh:] = 0
    bn = torch.randn(4, generator=g).to(dev)
    _, z = _rays8(n_rays, n_s, dev)
    noise = (torch.randn(n_rays, n_s, generator=g) * 2).to(dev) if with_noise else None
    return g, (h, r, wn, bn, z, noise)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_noise,return_weights,n_rays,n_s,feat", [
    (False, True, 37, 16, 64), (True, False, 37, 16, 64),
    (True, True, 5, 72, 256), (False, False, 3, 128, 40),
    # past one chunk of the block scan (T and the integrals carried)
    (False, True, 3, 257, 64), (True, True, 3, 257, 64),
    (False, True, 2, 640, 256), (True, False, 2, 640, 40),
    # more rays than the persistent grid holds, not a multiple of it
    (True, True, 1037, 16, 64),
    # the serving chunk at the nerf field's width
    (False, True, 65536, 64, 256)])
def test_nerf_heads_composite(dev, dtype, with_noise, return_weights, n_rays,
                              n_s, feat):
    _, (h, r, wn, bn, z, noise) = _nerf_narrow(dev, dtype, with_noise, 2,
                                               n_rays, n_s, feat)
    kw = dict(noise=noise, return_weights=return_weights)
    before = FM.LAUNCHES["nerf_heads_composite"]
    out, w = FN.nerf_heads_composite(h, r, wn, bn, z, **kw)
    assert FM.LAUNCHES["nerf_heads_composite"] == before + 1
    ref, ref_w = FN.nerf_heads_composite_reference(h, r, wn, bn, z, **kw)
    assert out.shape == (n_rays, 8) and float(out[:, 5:].abs().max()) == 0
    assert float((out - ref).abs().max()) <= 1e-4
    assert (w is None) == (not return_weights)
    if return_weights:
        assert float((w - ref_w).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_noise,n_rays,n_s,feat", [
    (False, 37, 16, 64), (True, 37, 16, 64), (True, 5, 72, 256),
    (True, 3, 128, 40),
    # one whole chunk of the block, one sample past it, past two chunks
    (True, 3, 256, 64), (False, 3, 257, 64), (True, 2, 640, 256)])
def test_nerf_composite_loss_bwd(dev, dtype, with_noise, n_rays, n_s, feat):
    g, (h, r, wn, bn, z, noise) = _nerf_narrow(dev, dtype, with_noise, 7,
                                               n_rays, n_s, feat)
    gt = torch.rand(n_rays, 3, generator=g).to(dev)
    before = FM.LAUNCHES["nerf_composite_loss_bwd"]
    got = FN.nerf_composite_loss_bwd(h, r, wn, bn, z, noise, gt)
    assert FM.LAUNCHES["nerf_composite_loss_bwd"] == before + 1
    ref = FN.nerf_composite_loss_bwd_reference(h, r, wn, bn, z, noise, gt)
    assert got["d_h"].shape == (n_rays * n_s, feat)
    _hold_cotangents(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_noise,n_rays,n_s", [
    (True, 5, 288), (False, 5, 320), (True, 2, FN.nerf_composite_max_samples())])
def test_nerf_composite_loss_bwd_past_256_samples(dev, dtype, with_noise, n_rays,
                                                  n_s):
    """Rays past 256 samples (past one chunk of the block: T kept a sample
    in shared memory, the scans carried from chunk to chunk), up to the most
    it holds at any width, against the plain version: 1e-4 of each tensor's
    largest entry, in bf16 a cotangent entry also one step of itself or, for
    d_r, which sums three products of
    rounded cotangents, of one of its terms (over more samples more entries
    have a term on the other side of a rounding boundary), as the SIREN
    composite kernels are held; in bf16 dWn and dbn, sums over every sample
    of such rounded products, within 5e-4 (the warp walk this body replaced
    read 1.7e-4 at 1,816 samples; the fp32 case, without rounded cotangents,
    holds 1e-4)."""
    g, (h, r, wn, bn, z, noise) = _nerf_narrow(dev, dtype, with_noise, 7,
                                               n_rays, n_s, 256)
    gt = torch.rand(n_rays, 3, generator=g).to(dev)
    got = FN.nerf_composite_loss_bwd(h, r, wn, bn, z, noise, gt)
    ref = FN.nerf_composite_loss_bwd_reference(h, r, wn, bn, z, noise, gt)
    for k, v in ref.items():
        assert bool(torch.isfinite(got[k]).all()), k
        lim = 1e-4 * v.abs().max()
        if k.startswith("d_") and dtype == torch.bfloat16:
            lim = lim + 2.0 ** -7 * v.abs() + (2.0 ** -8 * v.abs().max()
                                               if k == "d_r" else 0)
        elif k in ("dwn", "dbn") and dtype == torch.bfloat16:
            lim = 5e-4 * v.abs().max()
        assert bool(((got[k] - v).abs() <= lim).all()), (k, _rel(got[k], v))


def test_nerf_composite_adjoint_at_a_faint_last_sample(dev):
    """sigma = 1e-10 everywhere: the inner samples are transparent and the
    last one, whose delta is 1e10, has alpha = 1 - exp(-1). Its sigma
    cotangent is d_alpha * exp(-1) * 1e10 * softplus'(pre) with softplus' =
    1e-10, which 1 - exp(-sigma) rounds to 0 in float32."""
    g, (h, r, wn, bn, z, _) = _nerf_narrow(dev, torch.float32, False, 10)
    wn[0] = 0.0
    bn[0] = -23.0
    gt = torch.rand(37, 3, generator=g).to(dev)
    got = FN.nerf_composite_loss_bwd(h, r, wn, bn, z, None, gt)
    ref = FN.nerf_composite_loss_bwd_reference(h, r, wn, bn, z, None, gt)
    assert float(ref["dbn"][0].abs()) > 1e-4  # the last samples do pull on sigma
    _hold_cotangents(got, ref, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_points,feat", [
    (37 * 16, 64), (1037, 256), (130, 40),
    # the fine pass of a hierarchical batch and the coarse one (8 x 256),
    # the widest width, fewer points than one warp's share
    (131072, 256), (65536, 256), (1037, 512), (5, 256)])
def test_nerf_field_heads_and_backward(dev, dtype, n_points, feat):
    """Against the plain versions: the outputs to 1e-4 of their largest
    entry, the backward as _hold_cotangents holds it; at 65,536 points and
    more, in bf16, d_r (three products of rounded cotangents) also by one
    step of a term, as the per-ray adjoint is held past 256 samples: over
    more points more entries have a term on the other side of a rounding
    boundary."""
    g, (h, r, wn, bn, _, _) = _nerf_narrow(dev, dtype, False, 12, n_points, 1,
                                           feat)
    before = dict(FM.LAUNCHES)
    out = FN.nerf_field_heads(h, r, wn, bn)
    ref = FN.nerf_field_heads_reference(h, r, wn, bn)
    assert out.shape == (n_points, 8) and float(out[:, 4:].abs().max()) == 0
    assert _rel(out, ref) <= 1e-4
    cot = torch.randn(n_points, 8, generator=g).to(dev)
    got = FN.nerf_field_heads_bwd(h, r, wn, bn, cot)
    assert _grown(before) == {"nerf_field_heads": 1, "nerf_field_heads_bwd": 1}
    _hold_cotangents(got, FN.nerf_field_heads_bwd_reference(h, r, wn, bn, cot),
                     dtype, summed=("d_r",) if n_points >= 65536 else ())


@pytest.mark.parametrize("dtype", DTYPES)
def test_nerf_field_heads_bwd_twice(dev, dtype):
    """Two launches on the same inputs: d_h and d_r (no atomics) equal to
    the bit; dWn and dbn, the blocks' sums added by fp32 atomics in an order
    that changes from run to run, within 1e-5 of each tensor's largest
    entry."""
    g, (h, r, wn, bn, _, _) = _nerf_narrow(dev, dtype, False, 16, 131072, 1, 256)
    cot = torch.randn(131072, 8, generator=g).to(dev)
    a = FN.nerf_field_heads_bwd(h, r, wn, bn, cot)
    b = FN.nerf_field_heads_bwd(h, r, wn, bn, cot)
    assert torch.equal(a["d_h"], b["d_h"]) and torch.equal(a["d_r"], b["d_r"])
    for k in ("dwn", "dbn"):
        assert float((a[k] - b[k]).abs().max()) <= 1e-5 * float(a[k].abs().max()), k


def test_nerf_field_heads_bwd_at_a_faint_sigma(dev):
    g, (h, r, wn, bn, _, _) = _nerf_narrow(dev, torch.float32, False, 13, 200, 1)
    wn[0] = 0.0
    bn[0] = -23.0  # sigma = 1e-10 at every point
    cot = torch.randn(200, 8, generator=g).to(dev)
    got = FN.nerf_field_heads_bwd(h, r, wn, bn, cot)
    ref = FN.nerf_field_heads_bwd_reference(h, r, wn, bn, cot)
    assert float(ref["dbn"][0].abs()) > 0
    _hold_cotangents(got, ref, torch.float32)


def _nerf_field_inputs(dev, layers=8, feat=96, n_rays=53, n_s=24):
    field = build_model("nerf", layers, feat,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    g = torch.Generator().manual_seed(4)
    o = (torch.rand(n_rays, 3, generator=g) - 0.5).to(dev)
    d = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=g)).to(dev)
    z = torch.sort(torch.rand(n_rays, n_s, generator=g), 1).values.to(dev)
    noise = (torch.randn(n_rays, n_s, generator=g) * 0.5).to(dev)
    gt = torch.rand(n_rays, 3, generator=g).to(dev)
    return field, g, o, d, z, noise, gt


# The chains against autograd through the field module, fp32: the two
# forwards sum in another order, so a relu unit within an ulp of 0 may land on
# either side of the kink; at these sizes (53 x 24 points, 96 wide) that moves
# a gradient by less than 1e-3 of its tensor's largest entry.
@pytest.mark.parametrize("with_noise,n_s", [(True, 24), (False, 24), (True, 72)])
def test_fused_nerf_train_loss_grads_fp32(dev, with_noise, n_s):
    field, _, o, d, z, noise, gt = _nerf_field_inputs(dev, n_s=n_s)
    kw = dict(layers=8, feat=96, dtype=torch.float32)
    noise = noise if with_noise else None
    before = dict(FM.LAUNCHES)
    mse, grads = FN.fused_nerf_train_loss_grads(field, o, d, z, noise, gt, **kw)
    # fp32: every wgrad's db by nerf_bias_grad
    assert _grown(before) == {"nerf_dense": 10, "nerf_composite_loss_bwd": 1,
                              "nerf_dense_dgrad": 9, "nerf_dense_wgrad": 10,
                              "nerf_bias_grad": 10}
    r_mse, r_grads = FN.fused_nerf_train_loss_grads_reference(
        field, o, d, z, noise, gt, **kw)
    assert abs(float(mse) - float(r_mse)) <= 1e-5
    assert set(grads) == set(r_grads)
    for name, ref in r_grads.items():
        assert grads[name].shape == ref.shape, name
        assert _rel(grads[name], ref) <= 1e-3, (name, _rel(grads[name], ref))


@pytest.mark.parametrize("return_weights", [True, False])
def test_fused_nerf_render_rays_fp32(dev, return_weights):
    field, _, o, d, z, _, _ = _nerf_field_inputs(dev)
    kw = dict(layers=8, feat=96, dtype=torch.float32,
              return_weights=return_weights)
    before = dict(FM.LAUNCHES)
    out = FN.fused_nerf_render_rays(field, o, d, z, **kw)
    assert _grown(before) == {"nerf_dense": 10, "nerf_heads_composite": 1}
    with torch.no_grad():
        ref = FN.fused_nerf_render_rays_reference(field, o, d, z, **kw)
    assert set(out) == set(ref) and ("weights" in out) == return_weights
    for k, v in ref.items():
        assert out[k].shape == v.shape and out[k].grad_fn is None, k
        assert float((out[k] - v).abs().max()) <= 1e-4, k


@pytest.mark.parametrize("with_dir", [True, False])
def test_fused_nerf_apply_fp32(dev, with_dir):
    field, g, o, d, z, _, _ = _nerf_field_inputs(dev)
    xyz = (o[:, None, :] + d[:, None, :] * z[:, :, None])  # (53, 24, 3)
    vd = d[:, None, :].expand_as(xyz).contiguous() if with_dir else None
    cot = torch.randn(53, 24, 4, generator=g).to(dev)
    kw = dict(layers=8, feat=96, dtype=torch.float32)

    def run(fn):
        out = fn(field, xyz, vd, **kw)
        total = ((out["rgb"] * cot[..., 0:3]).sum()
                 + (out["sigma"] * cot[..., 3]).sum())
        grads = torch.autograd.grad(total, list(field.parameters()),
                                    allow_unused=True)
        return out, dict(zip([n for n, _ in field.named_parameters()], grads))

    before = dict(FM.LAUNCHES)
    out, grads = run(FN.fused_nerf_apply)
    assert _grown(before) == {"nerf_dense": 10, "nerf_field_heads": 1,
                              "nerf_field_heads_bwd": 1, "nerf_dense_dgrad": 9,
                              "nerf_dense_wgrad": 10, "nerf_bias_grad": 10}
    ref, r_grads = run(FN.fused_nerf_apply_reference)
    assert out["rgb"].shape == (53, 24, 3) and out["sigma"].shape == (53, 24)
    for k, v in ref.items():
        assert _rel(out[k], v) <= 1e-4, k
    for name, r in r_grads.items():
        assert grads[name] is not None and _rel(grads[name], r) <= 1e-3, name
    with torch.no_grad():
        quiet = FN.fused_nerf_apply(field, xyz, vd, **kw)
    assert quiet["rgb"].grad_fn is None



@pytest.mark.parametrize("which", ["k6", "k9"])
@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_point_fields_keep_no_activations_without_a_graph(dev, which, mode):
    """fused_field_apply (K6) and fused_nerf_apply (K9) with no graph to
    record (the serving renderer under inference_mode) run the chain that
    keeps no layer's activations or slopes: the call's peak memory stays
    under eight fp32 layers of its points, where the recording chain keeps
    all of them (30 such layers for K6, the slopes among them: the bench's
    131,072-ray serve_points row ran out of an 80 GB card that way). The
    outputs are the recording call's within 1e-6."""
    p, feat = 1 << 18, 96
    g = torch.Generator().manual_seed(5)
    xyz = (torch.rand(p, 3, generator=g) - 0.5).to(dev)
    kw = dict(layers=8, feat=feat, dtype=torch.float32)
    if which == "k6":
        field = build_model("sat-nerf", 8, feat,
                            generator=torch.Generator().manual_seed(3)).to(dev)
        sun = torch.nn.functional.normalize(torch.randn(p, 3, generator=g),
                                            dim=-1).to(dev)
        t = torch.randn(p, 4, generator=g).to(dev)
        call = lambda: FM.fused_field_apply(field, xyz, sun, t, **kw)  # noqa: E731
    else:
        field = build_model("nerf", 8, feat,
                            generator=torch.Generator().manual_seed(3)).to(dev)
        vd = torch.nn.functional.normalize(torch.randn(p, 3, generator=g),
                                           dim=-1).to(dev)
        call = lambda: FN.fused_nerf_apply(field, xyz, vd, **kw)  # noqa: E731
    recorded = {k: v.detach() for k, v in call().items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with getattr(torch, mode)():
        quiet = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert peak < 8 * p * feat * 4, peak / (p * feat * 4)
    for k, v in recorded.items():
        assert quiet[k].grad_fn is None
        assert float((quiet[k] - v).abs().max()) <= 1e-6, k

def test_nerf_kernels_refuse_bad_inputs(dev):
    rays8, z = _rays8(8, 4, dev)
    b = torch.zeros(16, device=dev)
    x = torch.zeros(32, 8, device=dev)
    w = torch.zeros(8, 16, device=dev)
    with pytest.raises(ValueError):  # neither X nor an encoding
        FN.nerf_dense(None, None, b, rays8, 4)
    with pytest.raises(ValueError):  # the encoding of the position needs z
        FN.nerf_dense(x, w, b, rays8, 4, enc="xyz",
                      enc_weight=torch.zeros(64, 16, device=dev), n_freq=10)
    with pytest.raises(ValueError):  # too few rows for the frequencies
        FN.nerf_dense(x, w, b, rays8, 4, enc="dir",
                      enc_weight=torch.zeros(16, 16, device=dev), n_freq=4)
    with pytest.raises(ValueError):  # a CPU operand among CUDA ones
        FN.nerf_dense(x.cpu(), w, b, rays8, 4)
    with pytest.raises(ValueError):  # the mask in another type than the weights
        FN.nerf_dense_dgrad(torch.zeros(32, 16, device=dev),
                            torch.zeros(32, 16, device=dev, dtype=torch.bfloat16),
                            w)
    with pytest.raises(ValueError):  # a field that is not the nerf variant
        FN.fused_nerf_render_rays(build_model("s-nerf", 8, 64).to(dev),
                                  rays8[:, 0:3], rays8[:, 3:6], z, feat=64)


@pytest.mark.parametrize("options,kernels", [
    (dict(), {"nerf_composite_loss_bwd": 1, "nerf_dense": 10}),
    (dict(n_importance=8), {"nerf_field_heads": 2, "nerf_field_heads_bwd": 2,
                            "nerf_dense": 20}),
    (dict(ds_lambda=10.0, sc_lambda=0.1),
     {"nerf_field_heads": 2, "nerf_field_heads_bwd": 2, "nerf_dense": 20}),
    (dict(fused="off"), {})], ids=str)
def test_nerf_step_and_render_on_the_card(dev, options, kernels):
    """The nerf variant through the system: the plain step through K7, the
    hierarchical and the depth-supervised step through K9 under the plain
    renderer (sc_lambda changes nothing: no sun head), serving through K8
    once a model, and no SIREN kernel; --fused off launches nothing."""
    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.train.system import NeRFSystem

    n = 512
    cfg = Config(**{**dict(model="nerf", fc_layers=8, fc_units=64, n_samples=16,
                           batch_size=128, max_train_steps=20, ds_drop=1.0,
                           chunk=256, lr=1e-3), **options})
    system = NeRFSystem(cfg, device=dev, dataset_len=n)
    assert system.fused_mode == ("off" if options.get("fused") else "points")
    g = torch.Generator().manual_seed(6)
    rays = torch.rand(n, 11, generator=g)
    rays[:, 3:6] = torch.nn.functional.normalize(rays[:, 3:6], dim=1)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    data = {"rays": rays.to(dev), "rgbs": torch.rand(n, 3, generator=g).to(dev),
            "ts": torch.zeros(n, dtype=torch.long, device=dev)}
    if cfg.ds_lambda > 0:
        data.update(d_rays=data["rays"][:64].clone(),
                    d_depths=torch.rand(64, 2, generator=g).to(dev),
                    d_ts=data["ts"][:64].clone())
    state = system.init_state(0)
    gen = jax_prng.prng_key(1)
    steps = 6
    before = dict(FM.LAUNCHES)
    losses = [float(system.train_step(state, data, gen)["loss"])
              for _ in range(steps)]
    assert all(np.isfinite(losses)) and state.step == steps
    grown = _grown(before)
    assert not any(k in grown for k in (
        "siren_dense", "composite_loss_bwd", "sc_loss_bwd", "heads_composite",
        "field_heads", "composite_bwd"))
    for k, per_step in kernels.items():
        assert grown.get(k) == per_step * steps, (k, grown)
    if not kernels:
        assert grown == {}
    before = dict(FM.LAUNCHES)
    # blender rays carry no sun direction: (n, 8)
    out = system.render_image(state.params, rays[:, :8].numpy(), None)
    grown = _grown(before)
    models = 2 if cfg.n_importance else 1
    typ = "fine" if cfg.n_importance else "coarse"
    assert out[f"rgb_{typ}"].shape == (n, 3)
    assert np.isfinite(out[f"depth_{typ}"]).all()
    assert not any(k.startswith(("sun_", "albedo_", "sky_", "beta_")) for k in out)
    if kernels:
        assert grown == {"nerf_dense": 10 * models * 2,
                         "nerf_heads_composite": models * 2}
    else:
        assert grown == {}


# ------------------------------------------------ the wgmma mainloops

# (K, N, E operand, its width, activation): every siren_dense launch with
# K > 0 on the main path
MAIN_DENSE = [(512, 512, None, 0, "sin"),    # trunk layer
              (512, 512, "xyz", 3, "sin"),   # skip layer
              (512, 512, None, 0, "none"),   # feats
              (512, 256, None, 0, "sin"),    # rgb_0
              (512, 256, "sun", 3, "sin"),   # sun_v_0
              (512, 256, "t", 4, "sin"),     # beta_0
              (256, 256, None, 0, "sin")]    # sun_v_1, sun_v_2
# (rays, samples): a training batch, a ragged one, a hierarchical fine pass
MAIN_POINTS = [(1024, 64), (1037, 72), (1024, 128)]


def _dense_operands(dev, k, n, extra, n_extra, n_rays, samples, seed=7):
    rays16, z = _rays16(n_rays, samples, dev, seed=seed)
    g = torch.Generator().manual_seed(seed)
    p = n_rays * samples
    x = (torch.rand(p, k, generator=g) * 2 - 1).to(dev, torch.bfloat16)
    w = (torch.randn(k, n, generator=g) / k ** 0.5).to(dev, torch.bfloat16)
    b = torch.randn(n, generator=g).to(dev)
    c = ((torch.randn(n_extra, n, generator=g) * 0.3).to(dev, torch.bfloat16)
         if extra else None)
    return (x, w, b, rays16, samples), dict(extra=extra, extra_weight=c, z=z)


def _count(name, mainloop):
    return FM.MAINLOOP_LAUNCHES.get((name, mainloop), 0)


@pytest.mark.parametrize("k,n,extra,n_extra,act,save", [
    (*shape, save) for shape in MAIN_DENSE for save in (False, True)
    if not (save and shape[-1] != "sin")])  # only a sine layer saves a slope
@pytest.mark.parametrize("n_rays,samples", MAIN_POINTS)
def test_siren_dense_wgmma(dev, k, n, extra, n_extra, act, save, n_rays,
                           samples):
    args, kw = _dense_operands(dev, k, n, extra, n_extra, n_rays, samples)
    kw.update(act=act, save=save)
    assert FM.dense_mainloop("siren_dense", torch.bfloat16, k, n) == "wgmma"
    before = {m: _count("siren_dense", m) for m in ("wgmma", "wmma")}
    got = FM.siren_dense(*args, mainloop="wgmma", **kw)
    wmma = FM.siren_dense(*args, mainloop="wmma", **kw)
    rule = FM.siren_dense(*args, **kw)
    assert _count("siren_dense", "wgmma") == before["wgmma"] + 2
    assert _count("siren_dense", "wmma") == before["wmma"] + 1
    ref = FM.siren_dense_reference(*args, **kw)
    if not save:
        got, wmma, rule, ref = [(t, None) for t in (got, wmma, rule, ref)]
    assert got[0].dtype == torch.bfloat16 and got[0].shape == ref[0].shape
    _close(got[0], ref[0], True)
    _close(got[0], wmma[0], True)
    assert torch.equal(got[0], rule[0])  # the rule took the same mainloop
    if save:
        assert float((got[1] - ref[1]).abs().max()) <= 1e-5 + 1e-4
        assert float((got[1] - wmma[1]).abs().max()) <= 1e-5 + 1e-4


# (rays, samples): where siren_dense on wgmma hung at K = 64 (262,144 points,
# a 64-wide field's 8,192-ray training batch of 32 samples), and 1,048,576
K64_HANG_POINTS = [(8192, 32), (16384, 64)]
# launches a case: the kernel stopped at some launches only, and before its
# repair within this many in most of the K = 64 cases
K64_REPS = 200


@pytest.mark.parametrize("extra,n_extra,save", [
    ("xyz", 3, False), ("sun", 3, False), ("t", 4, False), (None, 0, True)])
def test_siren_dense_k64_takes_wmma(dev, extra, n_extra, save):
    """At K = 64 with an E operand or a saved slope the wgmma kernel hung
    from 262,144 points on (a 64-wide field's 16,384-ray chunk of 32
    samples, its 8,192-ray training batch) until its turn barrier was
    repaired (Q6): the rule sends K = 64 to wgmma again. Launched
    K64_REPS times at that shape (the hang came with warps drifting apart,
    not at every launch), the last held against the plain version and the
    wmma mainloop."""
    args, kw = _dense_operands(dev, 64, 64, extra, n_extra, 16384, 32)
    kw.update(save=save)
    assert FM.dense_mainloop("siren_dense", torch.bfloat16, 64, 64) == "wgmma"
    before = _count("siren_dense", "wgmma")
    for _ in range(K64_REPS):
        got = FM.siren_dense(*args, **kw)
    torch.cuda.synchronize()
    assert _count("siren_dense", "wgmma") == before + K64_REPS
    wmma = FM.siren_dense(*args, mainloop="wmma", **kw)
    ref = FM.siren_dense_reference(*args, **kw)
    if save:
        assert float((got[1] - ref[1]).abs().max()) <= 1e-5 + 1e-4
        assert float((got[1] - wmma[1]).abs().max()) <= 1e-5 + 1e-4
        got, wmma, ref = got[0], wmma[0], ref[0]
    _close(got, ref, True)
    _close(got, wmma, True)


@pytest.mark.parametrize("extra,n_extra,save", [
    (extra, n_extra, save)
    for extra, n_extra in (("xyz", 3), ("sun", 3), ("t", 4), (None, 0))
    for save in (False, True) if extra or save])
@pytest.mark.parametrize("k,n", [(64, 64), (128, 64), (256, 64), (128, 256),
                                 (256, 256)])
@pytest.mark.parametrize("n_rays,samples", K64_HANG_POINTS)
def test_siren_dense_wgmma_past_the_k64_edge(dev, k, n, extra, n_extra, save,
                                             n_rays, samples):
    """wgmma by hand where K = 64 hung before its turn barrier was repaired
    (Q6: K = 64, N = 64) and past it, with each E operand and a saved
    slope, at the point count where K = 64 hung and at four times it:
    K64_REPS launches, the last against the plain version."""
    args, kw = _dense_operands(dev, k, n, extra, n_extra, n_rays, samples)
    kw.update(act="sin", save=save)
    assert FM.dense_mainloop("siren_dense", torch.bfloat16, k, n) == "wgmma"
    before = _count("siren_dense", "wgmma")
    for _ in range(K64_REPS):
        got = FM.siren_dense(*args, mainloop="wgmma", **kw)
    torch.cuda.synchronize()
    assert _count("siren_dense", "wgmma") == before + K64_REPS
    ref = FM.siren_dense_reference(*args, **kw)
    if save:
        assert float((got[1] - ref[1]).abs().max()) <= 1e-5 + 1e-4
        got, ref = got[0], ref[0]
    _close(got, ref, True)


# (N, K, slope, accumulate): every siren_dense_dgrad launch of the main path
MAIN_DGRAD = [(256, 512, True, False),    # rgb_0
              (256, 512, True, True),     # sun_v_0, beta_0 onto d_feats
              (256, 256, True, False),    # sun_v_2, sun_v_1
              (512, 512, False, False),   # feats, no slope
              (512, 512, False, True),    # feats onto d_h
              (512, 512, True, False)]    # trunk layers


@pytest.mark.parametrize("n,k,with_slope,accumulate", MAIN_DGRAD)
@pytest.mark.parametrize("n_rays,samples", MAIN_POINTS)
def test_siren_dense_dgrad_wgmma(dev, n, k, with_slope, accumulate, n_rays,
                                 samples):
    p = n_rays * samples
    g = torch.Generator().manual_seed(9)
    dy = torch.randn(p, n, generator=g).to(dev)
    slope = torch.randn(p, n, generator=g).to(dev) if with_slope else None
    w = (torch.randn(k, n, generator=g) * 0.1).to(dev, torch.bfloat16)
    base = torch.randn(p, k, generator=g).to(dev) if accumulate else None
    assert FM.dense_mainloop("siren_dense_dgrad", torch.bfloat16, k, n) == "wgmma"

    def run(mainloop):
        out = None if base is None else base.clone()
        got = FM.siren_dense_dgrad(dy, slope, w, out=out, mainloop=mainloop)
        if out is not None:
            assert got.data_ptr() == out.data_ptr()
        return got

    before = _count("siren_dense_dgrad", "wgmma")
    got, wmma, rule = run("wgmma"), run("wmma"), run(None)
    assert _count("siren_dense_dgrad", "wgmma") == before + 2
    ref = FM.siren_dense_dgrad_reference(
        dy, slope, w, out=None if base is None else base.clone())
    assert got.shape == (p, k) and _rel(got, ref) <= 1e-4
    assert _rel(got, wmma) <= 1e-4
    assert torch.equal(got, rule)


@pytest.mark.parametrize("save", [False, True])
def test_wgmma_sine_is_sinf_bit_for_bit(dev, save):
    """The wgmma epilogue writes sinf and sincosf out (csrc/fused_render.cu
    sinf_fast, sincosf_fast) and calls the library only past |x| = 105615;
    the wmma epilogue calls the library. With products of small integers,
    which sum exactly in any order, both mainloops see the same
    pre-activations, so Y and the slope agree bit for bit, over arguments
    of up to 2e5 (groups of columns on both sides of that limit), at
    K = 128."""
    n_rays, samples, k, n = 64, 16, 128, 512
    rays16, z = _rays16(n_rays, samples, dev)
    g = torch.Generator().manual_seed(11)
    p = n_rays * samples
    x = torch.randint(-4, 5, (p, k), generator=g).to(dev, torch.bfloat16)
    w = torch.randint(-4, 5, (k, n), generator=g).to(dev, torch.bfloat16)
    b = torch.cat([(torch.rand(384, generator=g) * 2 - 1) * 1e5,
                   (torch.rand(128, generator=g) * 2 - 1) * 2e5]).to(dev)
    args = (x, w, b, rays16, samples)
    got = FM.siren_dense(*args, save=save, mainloop="wgmma")
    ref = FM.siren_dense(*args, save=save, mainloop="wmma")
    if not save:
        got, ref = (got,), (ref,)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def _odd(t, by=2):
    """The same values in a contiguous view `by` elements into its storage:
    its pointer is not a multiple of 16 bytes."""
    store = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    view = store[by:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def test_unaligned_weight_stays_off_the_wgmma_path(dev):
    args, kw = _dense_operands(dev, 512, 256, "sun", 3, 37, 16)
    x, w, *rest = args
    w_odd = _odd(w)
    before = _count("siren_dense", "simt")
    got = FM.siren_dense(x, w_odd, *rest, **kw)
    assert _count("siren_dense", "simt") == before + 1
    _close(got, FM.siren_dense_reference(x, w, *rest, **kw), True)
    with pytest.raises(ValueError):
        FM.siren_dense(x, w_odd, *rest, mainloop="wgmma", **kw)
    g = torch.Generator().manual_seed(3)
    dy = torch.randn(x.shape[0], 256, generator=g).to(dev)
    wd = (torch.randn(512, 256, generator=g) * 0.1).to(dev, torch.bfloat16)
    before = _count("siren_dense_dgrad", "simt")
    got = FM.siren_dense_dgrad(dy, None, _odd(wd))
    assert _count("siren_dense_dgrad", "simt") == before + 1
    assert _rel(got, FM.siren_dense_dgrad_reference(dy, None, wd)) <= 1e-4


def test_unaligned_out_stays_off_the_wgmma_path(dev):
    g = torch.Generator().manual_seed(4)
    p, n, k = 37 * 16, 256, 512
    dy, slope = (torch.randn(p, n, generator=g).to(dev) for _ in range(2))
    w = (torch.randn(k, n, generator=g) * 0.1).to(dev, torch.bfloat16)
    base = torch.randn(p, k, generator=g).to(dev)
    out = _odd(base)
    assert FM.dense_mainloop("siren_dense_dgrad", torch.bfloat16, k, n,
                             outputs_aligned=False) == "wmma"
    before = _count("siren_dense_dgrad", "wmma")
    got = FM.siren_dense_dgrad(dy, slope, w, out=out)
    assert _count("siren_dense_dgrad", "wmma") == before + 1
    ref = FM.siren_dense_dgrad_reference(dy, slope, w, out=base.clone())
    assert got.data_ptr() == out.data_ptr() and _rel(got, ref) <= 1e-4
    with pytest.raises(ValueError):
        FM.siren_dense_dgrad(dy, slope, w, out=_odd(base), mainloop="wgmma")


# (K, N, E operand, its width): every siren_dense_wgrad launch with K > 0 on
# the main path; each with and without a slope
MAIN_WGRAD = [(512, 512, None, 0),    # trunk layers, feats (no slope)
              (512, 512, "xyz", 3),   # skip layer
              (512, 256, None, 0),    # rgb_0
              (512, 256, "sun", 3),   # sun_v_0
              (512, 256, "t", 4),     # beta_0
              (256, 256, None, 0)]    # sun_v_1, sun_v_2


def _wgrad_operands(dev, k, n, extra, n_extra, with_slope, n_rays, samples,
                    seed=12):
    rays16, z = _rays16(n_rays, samples, dev, seed=seed)
    g = torch.Generator().manual_seed(seed)
    p = n_rays * samples
    x = (torch.rand(p, k, generator=g) * 2 - 1).to(dev, torch.bfloat16)
    dy = torch.randn(p, n, generator=g).to(dev)
    slope = torch.randn(p, n, generator=g).to(dev) if with_slope else None
    c = ((torch.randn(n_extra, n, generator=g) * 0.3).to(dev, torch.bfloat16)
         if extra else None)
    return (x, dy, slope, rays16, samples), dict(
        extra=extra, extra_weight=c, z=z, extra_grad=extra is not None)


def _hold_wgrad(got, ref):
    """dW within 1e-3 of its largest entry (the same rounded operands summed
    in another order, across blocks by atomics); db, dC and dE as
    test_siren_dense_wgrad holds them, 1e-4."""
    for name, a, b in zip(("dW", "db", "dC", "dE"), got, ref):
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.shape == b.shape and a.dtype == torch.float32, name
            tol = 1e-3 if name == "dW" else 1e-4
            assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("k,n,extra,n_extra", MAIN_WGRAD)
@pytest.mark.parametrize("with_slope", [True, False])
@pytest.mark.parametrize("n_rays,samples", MAIN_POINTS + [(3, 16)])
def test_siren_dense_wgrad_wgmma(dev, k, n, extra, n_extra, with_slope, n_rays,
                                 samples):
    """The wgmma wgrad (db summed in its epilogue, dC of an E operand folded
    into it, narrow_grads only for dE) against the plain version, against
    the same launch on wmma (GEMM + narrow_grads with db, dC and dE) and
    against the column walk small_grads it replaced (narrow="walk"); 3 x 16
    points are fewer than one block's range."""
    args, kw = _wgrad_operands(dev, k, n, extra, n_extra, with_slope, n_rays,
                               samples)
    assert FM.dense_mainloop("siren_dense_wgrad", torch.bfloat16, k, n) == "wgmma"
    before = {m: _count("siren_dense_wgrad", m) for m in ("wgmma", "wmma")}
    narrow, walk = FM.LAUNCHES["narrow_grads"], FM.LAUNCHES["small_grads"]
    got = FM.siren_dense_wgrad(*args, mainloop="wgmma", **kw)
    wmma = FM.siren_dense_wgrad(*args, mainloop="wmma", **kw)
    rule = FM.siren_dense_wgrad(*args, **kw)
    assert _count("siren_dense_wgrad", "wgmma") == before["wgmma"] + 2
    assert _count("siren_dense_wgrad", "wmma") == before["wmma"] + 1
    assert FM.LAUNCHES["narrow_grads"] == narrow + 1 + 2 * (extra is not None)
    assert FM.LAUNCHES["small_grads"] == walk
    walked = FM.siren_dense_wgrad(*args, mainloop="wgmma", narrow="walk", **kw)
    assert FM.LAUNCHES["small_grads"] == walk + (extra is not None)
    ref = FM.siren_dense_wgrad_reference(*args, **kw)
    _hold_wgrad(got, ref)
    _hold_wgrad(got, wmma)
    _hold_wgrad(rule, ref)
    _hold_wgrad(got, walked)


@pytest.mark.parametrize("k,n", [(320, 192), (64, 64), (768, 320)])
def test_siren_dense_wgrad_wgmma_partial_tiles(dev, k, n):
    """K and N multiples of 64 but not of the 256 x 128 tile: the boxes past
    the matrix are not loaded, and the rows and columns they would feed are
    not stored (a half-empty warpgroup, a k tile with one box of four)."""
    args, kw = _wgrad_operands(dev, k, n, "xyz", 3, True, 37, 16)
    assert FM.dense_mainloop("siren_dense_wgrad", torch.bfloat16, k, n) == "wgmma"
    got = FM.siren_dense_wgrad(*args, mainloop="wgmma", **kw)
    _hold_wgrad(got, FM.siren_dense_wgrad_reference(*args, **kw))
    _hold_wgrad(got, FM.siren_dense_wgrad(*args, mainloop="wmma", **kw))


def test_wgrad_split_does_not_change_the_sums(dev):
    """The points cut into 1, 5 and 128 ranges give the same gradients."""
    args, kw = _wgrad_operands(dev, 512, 512, "xyz", 3, True, 256, 64)
    ref = FM.siren_dense_wgrad_reference(*args, **kw)
    for split in (256 * 64, 3296, 128):
        _hold_wgrad(FM.siren_dense_wgrad(*args, mainloop="wgmma", split=split,
                                         **kw), ref)
    with pytest.raises(ValueError):
        FM.siren_dense_wgrad(*args, mainloop="wgmma", split=100, **kw)


def test_bias_only_wgrad_is_small_grads_alone(dev):
    """A layer with neither X nor E: narrow_grads sums db, nothing else runs
    (no GEMM: the wgrad's C entry is not called); the column walk, asked
    for, is the C entry's small_grads alone."""
    g = torch.Generator().manual_seed(13)
    rays16, _ = _rays16(1024, 64, dev)
    dy, slope = (torch.randn(1024 * 64, 512, generator=g).to(dev)
                 for _ in range(2))
    before = dict(FM.LAUNCHES)
    walked = FM.siren_dense_wgrad(None, dy, slope, rays16, 64, narrow="walk")
    assert _grown(before) == {"siren_dense_wgrad": 1, "small_grads": 1}
    before = dict(FM.LAUNCHES)
    got = FM.siren_dense_wgrad(None, dy, slope, rays16, 64)
    assert _grown(before) == {"narrow_grads": 1}
    assert _rel(got[1], walked[1]) <= 1e-4
    ref = FM.siren_dense_wgrad_reference(None, dy, slope, rays16, 64)
    assert got[0] is None and got[2] is None and got[3] is None
    assert _rel(got[1], ref[1]) <= 1e-4
    assert _rel(got[1], torch.einsum("pn,pn->n", dy, slope)) <= 1e-4


@pytest.mark.parametrize("operand", ["x", "dy", "slope"])
def test_unaligned_wgrad_input_stays_off_the_wgmma_path(dev, operand):
    args, kw = _wgrad_operands(dev, 512, 256, "sun", 3, True, 37, 16)
    odd = dict(zip(("x", "dy", "slope"), args[:3]))
    odd[operand] = _odd(odd[operand])
    moved = (odd["x"], odd["dy"], odd["slope"], *args[3:])
    assert FM.dense_mainloop("siren_dense_wgrad", torch.bfloat16, 512, 256,
                             inputs_aligned=False) == "simt"
    before = _count("siren_dense_wgrad", "simt")
    got = FM.siren_dense_wgrad(*moved, **kw)
    assert _count("siren_dense_wgrad", "simt") == before + 1
    _hold_wgrad(got, FM.siren_dense_wgrad_reference(*args, **kw))
    for loop in ("wgmma", "wmma"):
        with pytest.raises(ValueError):
            FM.siren_dense_wgrad(*moved, mainloop=loop, **kw)


# ------------------------------------ the nerf variant's wgmma mainloops

# (rays, samples): a training batch, and 65,573 points that are their own
# rays (K9's backward), a ragged edge of 37 past 512 row tiles
NERF_POINTS = [(1024, 64), (65536 + 37, 1)]
# (N, K, masked, accumulate): every nerf_dense_dgrad launch of the 8 x 256
# chain
NERF_DGRAD = [(128, 256, True, False),   # rgb_0 -> d_feats, mask r
              (256, 256, False, True),   # feats -> d_h, linear, onto d_h
              (256, 256, True, False)]   # trunk layers, mask h_l


@pytest.mark.parametrize("n,k,masked,accumulate", NERF_DGRAD)
@pytest.mark.parametrize("n_rays,samples", NERF_POINTS)
def test_nerf_dense_dgrad_wgmma(dev, n, k, masked, accumulate, n_rays, samples):
    p = n_rays * samples
    g = torch.Generator().manual_seed(15)
    dy = torch.randn(p, n, generator=g).to(dev)
    y = (torch.relu(torch.randn(p, n, generator=g)).to(dev, torch.bfloat16)
         if masked else None)
    w = (torch.randn(k, n, generator=g) * 0.1).to(dev, torch.bfloat16)
    base = torch.randn(p, k, generator=g).to(dev) if accumulate else None
    assert FM.dense_mainloop("nerf_dense_dgrad", torch.bfloat16, k, n) == "wgmma"

    def run(mainloop):
        out = None if base is None else base.clone()
        got = FN.nerf_dense_dgrad(dy, y, w, out=out, mainloop=mainloop)
        if out is not None:
            assert got.data_ptr() == out.data_ptr()
        return got

    before = {m: _count("nerf_dense_dgrad", m) for m in ("wgmma", "wmma")}
    got, wmma, rule = run("wgmma"), run("wmma"), run(None)
    assert _count("nerf_dense_dgrad", "wgmma") == before["wgmma"] + 2
    assert _count("nerf_dense_dgrad", "wmma") == before["wmma"] + 1
    ref = FN.nerf_dense_dgrad_reference(
        dy, y, w, out=None if base is None else base.clone())
    assert got.shape == (p, k) and _rel(got, ref) <= 1e-3
    assert _rel(got, wmma) <= 1e-3
    assert torch.equal(got, rule)  # no atomics: the same bits every run


# (K, N, encoding, n_freq, masked): every nerf_dense_wgrad launch of the
# 8 x 256 chain
NERF_WGRAD = [(256, 128, "dir", 4, True),    # rgb_0: dW, dC (32 rows), db
              (256, 256, None, 0, False),    # feats: linear
              (256, 256, None, 0, True),     # trunk layers
              (256, 256, "xyz", 10, True),   # the skip layer: dW, dC (64 rows)
              (0, 256, "xyz", 10, True)]     # layer 0: dC and db alone


def _nerf_wgrad_operands(dev, k, n, enc, n_freq, masked, n_rays, samples,
                         seed=16):
    rays8, z = _rays8(n_rays, samples, dev, seed=seed)
    g = torch.Generator().manual_seed(seed)
    p = n_rays * samples
    x = (torch.rand(p, k, generator=g)).to(dev, torch.bfloat16) if k else None
    dy = torch.randn(p, n, generator=g).to(dev)
    y = (torch.relu(torch.randn(p, n, generator=g)).to(dev, torch.bfloat16)
         if masked else None)
    kw = dict(enc=enc, z=z, n_freq=n_freq,
              enc_rows=FN._enc_rows(n_freq) if enc else 0, dtype=torch.bfloat16)
    return (x, dy, y, rays8, samples), kw


def _hold_nerf_wgrad(got, ref):
    """dW, db and dC within 1e-3 of each tensor's largest entry: the same
    rounded operands summed in another order, across blocks by atomics."""
    for name, a, b in zip(("dW", "db", "dC"), got, ref):
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.shape == b.shape and a.dtype == torch.float32, name
            assert _rel(a, b) <= 1e-3, (name, _rel(a, b))


@pytest.mark.parametrize("k,n,enc,n_freq,masked", NERF_WGRAD + [
    (512, 192, "xyz", 10, True)])  # two X tiles and a partial column tile
@pytest.mark.parametrize("n_rays,samples", NERF_POINTS + [(3, 16)])
def test_nerf_dense_wgrad_wgmma(dev, k, n, enc, n_freq, masked, n_rays, samples):
    """One launch on wgmma (dW, dC and db) against the plain version and the
    same call on wmma (its GEMMs, then nerf_bias_grad for db); 3 x 16 points
    are fewer than one block's range."""
    args, kw = _nerf_wgrad_operands(dev, k, n, enc, n_freq, masked, n_rays,
                                    samples)
    assert FM.dense_mainloop("nerf_dense_wgrad", torch.bfloat16, k, n,
                             e_rows=kw["enc_rows"]) == "wgmma"
    before = dict(FM.LAUNCHES)
    got = FN.nerf_dense_wgrad(*args, mainloop="wgmma", **kw)
    assert _grown(before) == {"nerf_dense_wgrad": 1}
    before = dict(FM.LAUNCHES)
    wmma = FN.nerf_dense_wgrad(*args, mainloop="wmma", **kw)
    assert _grown(before) == {"nerf_dense_wgrad": 1, "nerf_bias_grad": 1}
    rule = FN.nerf_dense_wgrad(*args, **kw)
    ref = FN.nerf_dense_wgrad_reference(*args, **kw)
    _hold_nerf_wgrad(got, ref)
    _hold_nerf_wgrad(got, wmma)
    _hold_nerf_wgrad(rule, ref)
    if enc:  # the padded rows of the encoding's gradient stay 0
        assert float(got[2][6 * n_freq:].abs().max()) == 0


def test_nerf_wgrad_split_does_not_change_the_sums(dev):
    """The points cut into 1, 5 and 128 ranges give the same gradients."""
    args, kw = _nerf_wgrad_operands(dev, 256, 256, "xyz", 10, True, 256, 64)
    ref = FN.nerf_dense_wgrad_reference(*args, **kw)
    for split in (256 * 64, 3296, 128):
        _hold_nerf_wgrad(FN.nerf_dense_wgrad(*args, mainloop="wgmma",
                                             split=split, **kw), ref)
    with pytest.raises(ValueError):
        FN.nerf_dense_wgrad(*args, mainloop="wgmma", split=100, **kw)


def test_a_forced_nerf_wgmma_that_cannot_run_raises(dev):
    """Widths that are not multiples of 64, an encoding wider than the wgmma
    tile and operands whose pointers are not 16-byte aligned: the rule keeps
    them off wgmma, and asking for it raises."""
    g = torch.Generator().manual_seed(17)
    p = 37 * 16
    dy = torch.randn(p, 96, generator=g).to(dev)
    w = (torch.randn(96, 96, generator=g) * 0.1).to(dev, torch.bfloat16)
    with pytest.raises(ValueError):
        FN.nerf_dense_dgrad(dy, None, w, mainloop="wgmma")
    dy = torch.randn(p, 256, generator=g).to(dev)
    w = (torch.randn(256, 256, generator=g) * 0.1).to(dev, torch.bfloat16)
    base = torch.randn(p, 256, generator=g).to(dev)
    with pytest.raises(ValueError):  # an unaligned dX
        FN.nerf_dense_dgrad(dy, None, w, out=_odd(base), mainloop="wgmma")
    with pytest.raises(ValueError):  # an unaligned dY
        FN.nerf_dense_dgrad(_odd(dy), None, w, mainloop="wgmma")
    before = _count("nerf_dense_dgrad", "wmma")
    got = FN.nerf_dense_dgrad(dy, None, w, out=_odd(base))  # the rule: wmma
    assert _count("nerf_dense_dgrad", "wmma") == before + 1
    assert _rel(got, FN.nerf_dense_dgrad_reference(dy, None, w, out=base.clone())) <= 1e-3
    for k, n, enc, n_freq, rows in ((96, 96, "xyz", 10, 64), (256, 256, "xyz", 16, 96)):
        args, kw = _nerf_wgrad_operands(dev, k, n, enc, n_freq, True, 37, 16)
        kw["enc_rows"] = rows
        with pytest.raises(ValueError):
            FN.nerf_dense_wgrad(*args, mainloop="wgmma", **kw)
        before = dict(FM.LAUNCHES)
        got = FN.nerf_dense_wgrad(*args, **kw)  # the rule: wmma and the bias kernel
        assert _grown(before) == {"nerf_dense_wgrad": 1, "nerf_bias_grad": 1}
        _hold_nerf_wgrad(got, FN.nerf_dense_wgrad_reference(*args, **kw))
    args, kw = _nerf_wgrad_operands(dev, 256, 256, "xyz", 10, True, 37, 16)
    x, dy, y, *rest = args
    for moved in ((_odd(x), dy, y), (x, _odd(dy), y), (x, dy, _odd(y))):
        with pytest.raises(ValueError):
            FN.nerf_dense_wgrad(*moved, *rest, mainloop="wgmma", **kw)


# (K, N, encoding, n_freq, act): every nerf_dense launch of the 8 x 256 chain
NERF_DENSE = [(0, 256, "xyz", 10, "relu"),     # layer 0: the encoding alone
              (256, 256, None, 0, "relu"),     # trunk layers
              (256, 256, "xyz", 10, "relu"),   # the skip layer
              (256, 256, None, 0, "none"),     # feats
              (256, 128, "dir", 4, "relu")]    # rgb_0


@pytest.mark.parametrize("k,n,enc,n_freq,act", NERF_DENSE + [
    (512, 192, "dir", 10, "relu"),   # K at the W slice's limit, a partial slice
    (128, 64, "xyz", 5, "relu")])    # an encoding of 32 rows, half a slice
@pytest.mark.parametrize("n_rays,samples", NERF_POINTS + [(37, 16), (3, 72)])
def test_nerf_dense_wgmma(dev, k, n, enc, n_freq, act, n_rays, samples):
    """nerf_dense on wgmma against the plain version and the same launch on
    wmma: one bf16 rounding step of each entry (the two mainloops compute the
    same rounded encoding and sum in fp32 in another order)."""
    rays8, z = _rays8(n_rays, samples, dev, seed=18)
    g = torch.Generator().manual_seed(18)
    p = n_rays * samples
    x = torch.rand(p, k, generator=g).to(dev, torch.bfloat16) if k else None
    w = (torch.randn(k, n, generator=g) * 0.1).to(dev, torch.bfloat16) if k else None
    b = torch.randn(n, generator=g).to(dev) * 0.1
    c = _enc_weight(n_freq, n, g, dev, torch.bfloat16) if enc else None
    kw = dict(enc=enc, enc_weight=c, z=z, n_freq=n_freq, act=act)
    rows = 0 if c is None else c.shape[0]
    assert FM.dense_mainloop("nerf_dense", torch.bfloat16, k, n, e_rows=rows) == "wgmma"
    before = {m: _count("nerf_dense", m) for m in ("wgmma", "wmma")}
    got = FN.nerf_dense(x, w, b, rays8, samples, mainloop="wgmma", **kw)
    rule = FN.nerf_dense(x, w, b, rays8, samples, **kw)
    wmma = FN.nerf_dense(x, w, b, rays8, samples, mainloop="wmma", **kw)
    assert _count("nerf_dense", "wgmma") == before["wgmma"] + 2
    assert _count("nerf_dense", "wmma") == before["wmma"] + 1
    ref = FN.nerf_dense_reference(x, w, b, rays8, samples, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (p, n)
    for other in (ref, wmma):
        d = (got.float() - other.float()).abs()
        assert bool((d <= 2.0 ** -7 * other.float().abs() + 1e-4).all()), d.max()
    assert torch.equal(got, rule)  # no atomics: the same bits every run


def test_a_forced_nerf_dense_wgmma_that_cannot_run_raises(dev):
    """fp32, widths that are not multiples of 64, K past the W slice, an
    encoding of 96 rows, operands whose pointers are not 16-byte aligned:
    the rule keeps them off wgmma, and asking for it raises."""
    rays8, z = _rays8(37, 16, dev, seed=19)
    g = torch.Generator().manual_seed(19)
    p = 37 * 16

    def operands(k, n, n_freq, rows, dtype=torch.bfloat16):
        x = torch.rand(p, k, generator=g).to(dev, dtype)
        w = (torch.randn(k, n, generator=g) * 0.1).to(dev, dtype)
        c = torch.randn(rows, n, generator=g) * 0.3
        c[6 * n_freq:] = 0
        return x, w, torch.randn(n, generator=g).to(dev), c.to(dev, dtype)

    for k, n, n_freq, rows, dtype in ((256, 256, 10, 64, torch.float32),
                                      (96, 96, 10, 64, torch.bfloat16),
                                      (576, 256, 10, 64, torch.bfloat16),
                                      (256, 256, 16, 96, torch.bfloat16)):
        x, w, b, c = operands(k, n, n_freq, rows, dtype)
        kw = dict(enc="xyz", enc_weight=c, z=z, n_freq=n_freq)
        with pytest.raises(ValueError):
            FN.nerf_dense(x, w, b, rays8, 16, mainloop="wgmma", **kw)
        got = FN.nerf_dense(x, w, b, rays8, 16, **kw)  # the rule: not wgmma
        _close(got, FN.nerf_dense_reference(x, w, b, rays8, 16, **kw),
               dtype == torch.bfloat16)
    x, w, b, c = operands(256, 256, 10, 64)
    kw = dict(enc="xyz", z=z, n_freq=10)
    for moved in ((_odd(x), w, c), (x, _odd(w), c), (x, w, _odd(c))):
        with pytest.raises(ValueError):
            FN.nerf_dense(moved[0], moved[1], b, rays8, 16, enc_weight=moved[2],
                          mainloop="wgmma", **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta,with_noise,n_rays,n_s,feat", [
    (True, True, 1024, 64, 512), (True, False, 53, 128, 512),
    (False, True, 11, 256, 512), (True, True, 9, 5, 36),
    # past one chunk of 256 a thread takes two samples: a 320-sample fine
    # pass, 288, and the most the warp body holds (the block body holds more)
    (True, True, 7, 288, 512), (True, False, 5, 320, 512),
    (True, True, 3, 1452, 512)])
def test_composite_bodies_agree(dev, dtype, beta, with_noise, n_rays, n_s, feat):
    """composite_loss_bwd and composite_bwd a block a ray (the default)
    against the warp a ray and the plain version: 1e-4 of each tensor's
    largest entry, a cotangent entry in bf16 also one step of itself or, for
    d_r and d_skyh, which sum three products of rounded cotangents, of one of
    its terms (the bodies sum in other orders and may round a cotangent to
    either side of a bf16 boundary); 256 samples fill the block, F = 36 takes
    element loads."""
    g = torch.Generator().manual_seed(20)
    p, fh = n_rays * n_s, feat // 2

    def t(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    h, r, s2 = t(p, feat), t(p, fh), t(p, fh)
    bh = t(p, fh) if beta else None
    skyh = torch.relu(t(n_rays, fh))
    wn = t(9, feat, scale=0.5)
    wn[0] *= 40
    bn = torch.randn(9, generator=g).to(dev)
    _, z = _rays16(n_rays, n_s, dev)
    noise = (torch.randn(n_rays, n_s, generator=g) * 2).to(dev) if with_noise else None
    gt = torch.rand(n_rays, 3, generator=g).to(dev)
    cot = torch.randn(n_rays, 16, generator=g).to(dev)
    args = (h, r, s2, bh, skyh, wn, bn, z, noise)
    before = dict(FM.BODY_LAUNCHES)
    runs = {b: (FM.composite_loss_bwd(*args, gt, 0.3, return_weights=True, body=b),
                FM.composite_bwd(*args, cot, body=b)) for b in FM.COMPOSITE_BODIES}
    default = (FM.composite_loss_bwd(*args, gt, 0.3, return_weights=True),
               FM.composite_bwd(*args, cot))
    assert {k: v - before.get(k, 0) for k, v in FM.BODY_LAUNCHES.items()} == {
        ("composite_loss_bwd", "block"): 2, ("composite_loss_bwd", "warp"): 1,
        ("composite_bwd", "block"): 2, ("composite_bwd", "warp"): 1}
    refs = (FM.composite_loss_bwd_reference(*args, gt, 0.3, return_weights=True),
            FM.composite_bwd_reference(*args, cot))
    for got, warp, dflt, ref in zip(runs["block"], runs["warp"], default, refs):
        for other in (ref, warp):
            assert set(got) == set(other)
            for k, v in other.items():
                if v is None:
                    assert got[k] is None
                    continue
                assert bool(torch.isfinite(got[k]).all()), k
                lim = 1e-4 * v.abs().max()
                if k.startswith("d_") and dtype == torch.bfloat16:
                    lim = lim + 2.0 ** -7 * v.abs() + (
                        2.0 ** -8 * v.abs().max() if k in ("d_r", "d_skyh") else 0)
                assert bool(((got[k] - v).abs() <= lim).all()), (k, _rel(got[k], v))
        for k, v in got.items():  # the default is the block body
            assert (v is None and dflt[k] is None) or _rel(dflt[k], v) <= 1e-4, k
    with pytest.raises(ValueError):
        FM.composite_bwd(*args, cot, body="lane")


@pytest.mark.parametrize("body", ["block", "warp"])
def test_composite_refuses_past_its_sample_limit(dev, body):
    """One sample a ray past what the body's shared memory holds (4,130 on
    the block body, 1,453 on the warp a ray at F = 512) is refused by both
    wrappers, before any launch, with the 227 KB limit and the largest S
    named; the largest S itself runs (the block body: here, against the
    plain version; the warp body: in test_composite_bodies_agree)."""
    feat, fh = 512, 256
    n_s = FM.composite_max_samples(feat, fh, body)
    g = torch.Generator().manual_seed(21)

    def operands(n_rays, n_s):
        p = n_rays * n_s

        def t(*shape):
            return (torch.rand(*shape, generator=g) * 2 - 1).to(dev, torch.bfloat16)

        h, r, s2, bh = t(p, feat), t(p, fh), t(p, fh), t(p, fh)
        skyh = torch.relu(t(n_rays, fh))
        wn, bn = t(9, feat) * 0.1, torch.randn(9, generator=g).to(dev)
        _, z = _rays16(n_rays, n_s, dev)
        return (h, r, s2, bh, skyh, wn, bn, z, None)

    args = operands(2, n_s + 1)
    gt = torch.rand(2, 3, generator=g).to(dev)
    cot = torch.randn(2, 16, generator=g).to(dev)
    launches, bodies = dict(FM.LAUNCHES), dict(FM.BODY_LAUNCHES)
    for call in (lambda: FM.composite_loss_bwd(*args, gt, 0.3, body=body),
                 lambda: FM.composite_bwd(*args, cot, body=body)):
        with pytest.raises(ValueError, match=rf"227 KB.*at most {n_s} at F=512"):
            call()
    assert FM.LAUNCHES == launches and FM.BODY_LAUNCHES == bodies
    if body == "block":
        args = operands(2, n_s)
        got = (FM.composite_loss_bwd(*args, gt, 0.3, body=body),
               FM.composite_bwd(*args, cot, body=body))
        refs = (FM.composite_loss_bwd_reference(*args, gt, 0.3),
                FM.composite_bwd_reference(*args, cot))
        for a, b in zip(got, refs):
            for k, v in b.items():
                if v is not None:
                    lim = 1e-4 * v.abs().max()
                    if k.startswith("d_"):
                        lim = lim + 2.0 ** -7 * v.abs() + (
                            2.0 ** -8 * v.abs().max() if k in ("d_r", "d_skyh") else 0)
                    assert bool(((a[k] - v).abs() <= lim).all()), (k, _rel(a[k], v))


def test_nerf_composite_refuses_past_its_sample_limit(dev):
    limit = FN.nerf_composite_max_samples(256, 128, torch.bfloat16)
    g, (h, r, wn, bn, z, _) = _nerf_narrow(dev, torch.bfloat16, False, 7, 2,
                                           limit + 1, 256)
    gt = torch.rand(2, 3, generator=g).to(dev)
    before = dict(FM.LAUNCHES)
    with pytest.raises(ValueError, match=f"227 KB.*at most {limit} at F=256, Fh=128"):
        FN.nerf_composite_loss_bwd(h, r, wn, bn, z, None, gt)
    assert FM.LAUNCHES == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_rays,samples,n,extra,act,w0,save", [
    (1024, 64, 512, "xyz", "sin", 30.0, True),   # layer 0 in training
    (1024, 64, 512, "xyz", "sin", 30.0, False),  # layer 0 serving
    (1037, 72, 512, "xyz", "sin", 30.0, True),   # ragged
    (1024, 1, 256, "sun", "relu", 1.0, False),   # sky_0
    (37, 3, 200, "t", "sin", 1.0, True),         # a partial column group
    (5, 3, 36, "xyz", "none", 2.0, False),       # element stores
    (3, 700, 1100, "sun", "sin", 30.0, True)])   # three column ranges
def test_siren_dense_k0_equals_its_first_kernel(dev, dtype, n_rays, samples, n,
                                                extra, act, w0, save):
    """The K = 0 kernel (a warp a point, the lanes' neighbouring vectors, one
    sincos for the sine and the slope) against the first one, k0_v1: Y and
    the slope equal to the bit; both against the plain version."""
    rays16, z = _rays16(n_rays, samples, dev, seed=14)
    g = torch.Generator().manual_seed(15)
    n_extra = 4 if extra == "t" else 3
    c = (torch.randn(n_extra, n, generator=g) * 0.5).to(dev, dtype)
    b = torch.randn(n, generator=g).to(dev)
    kw = dict(extra=extra, extra_weight=c, z=z, w0=w0, act=act, save=save)
    before = {m: _count("siren_dense", m) for m in ("k0", "k0_v1")}
    new = FM.siren_dense(None, None, b, rays16, samples, **kw)
    old = FM.siren_dense(None, None, b, rays16, samples, mainloop="k0_v1", **kw)
    assert _count("siren_dense", "k0") == before["k0"] + 1
    assert _count("siren_dense", "k0_v1") == before["k0_v1"] + 1
    for a, o in zip(new if save else (new,), old if save else (old,)):
        assert torch.equal(a, o)
    ref = FM.siren_dense_reference(None, None, b, rays16, samples, **kw)
    y, y_ref = (new[0], ref[0]) if save else (new, ref)
    assert _rel(y.float(), y_ref.float()) <= (1e-2 if dtype == torch.bfloat16 else 1e-4)
    if save:
        assert _rel(new[1], ref[1]) <= 1e-4


@pytest.mark.parametrize("n_rays,samples", MAIN_POINTS)
@pytest.mark.parametrize("n,extra,slope_on,samples_of_ray", [
    (512, "xyz", True, None),   # layer 0
    (256, "sun", False, 1)])    # sky_0, once a ray
@pytest.mark.parametrize("extra_grad", [False, True])
def test_narrow_grads_of_the_layers_without_x(dev, n_rays, samples, n, extra,
                                              slope_on, samples_of_ray,
                                              extra_grad):
    """Layer 0 and sky_0 (K = 0): narrow_grads (db, dC, and dE on request)
    against the plain version and the column walk, 1e-4; one launch, no
    GEMM."""
    s = samples_of_ray or samples
    rays16, z = _rays16(n_rays, samples, dev, seed=16)
    g = torch.Generator().manual_seed(17)
    p = n_rays * s
    dy = torch.randn(p, n, generator=g).to(dev)
    slope = torch.randn(p, n, generator=g).to(dev) * 30 if slope_on else None
    c = (torch.randn(3, n, generator=g) * 0.3).to(dev, torch.bfloat16)
    kw = dict(extra=extra, extra_weight=c, z=z[:, :s] if extra == "xyz" else None,
              extra_grad=extra_grad)
    before = dict(FM.LAUNCHES)
    got = FM.siren_dense_wgrad(None, dy, slope, rays16, s, **kw)
    assert _grown(before) == {"narrow_grads": 1}
    walked = FM.siren_dense_wgrad(None, dy, slope, rays16, s, narrow="walk", **kw)
    ref = FM.siren_dense_wgrad_reference(None, dy, slope, rays16, s, **kw)
    _hold_wgrad(got, ref)
    _hold_wgrad(got, walked)


def test_narrow_grads_joins_layers_in_one_launch(dev):
    """The chain's joined launch: sky_0's job (db, dC) and beta_0's t_grad
    (dE) at the main path's shapes, and a third layer's, in one launch of
    narrow_grads, each equal within 1e-4 to its plain version and to the
    same job launched alone."""
    g = torch.Generator().manual_seed(18)
    rays16, z = _rays16(1024, 64, dev, seed=18)
    p = 1024 * 64

    def jobs():
        return [
            FM.NarrowJob(sky_dy, None, rays16, 1, extra="sun", extra_weight=c3,
                         dtype=torch.bfloat16, db=True, dc=True, de=False),
            FM.NarrowJob(b_dy, b_slope, rays16, 64, extra="t", extra_weight=c4,
                         z=z, dtype=torch.bfloat16, db=False, dc=False, de=True),
            FM.NarrowJob(l_dy, l_slope, rays16, 64, extra="xyz", extra_weight=c3x,
                         z=z, dtype=torch.bfloat16, db=True, dc=True, de=True)]

    sky_dy = torch.relu(torch.randn(1024, 256, generator=g)).to(dev)
    b_dy, b_slope = (torch.randn(p, 256, generator=g).to(dev) for _ in range(2))
    l_dy, l_slope = (torch.randn(p, 512, generator=g).to(dev) for _ in range(2))
    c3 = (torch.randn(3, 256, generator=g) * 0.3).to(dev, torch.bfloat16)
    c4 = (torch.randn(4, 256, generator=g) * 0.3).to(dev, torch.bfloat16)
    c3x = (torch.randn(3, 512, generator=g) * 0.3).to(dev, torch.bfloat16)
    together = jobs()
    before = FM.LAUNCHES["narrow_grads"]
    FM.narrow_grads(together)
    assert FM.LAUNCHES["narrow_grads"] == before + 1
    alone = jobs()
    for job in alone:
        FM.narrow_grads([job])
    assert FM.LAUNCHES["narrow_grads"] == before + 4
    for a, b in zip(together, alone):
        ref = FM.narrow_grads_reference(a)
        for x, y, r in zip((a.db, a.dc, a.de), (b.db, b.dc, b.de), ref):
            assert (x is None) == (r is None)
            if r is not None:
                assert _rel(x, r) <= 1e-4 and _rel(x, y) <= 1e-4


@pytest.mark.parametrize("k,n,extra,n_extra", [
    (k, n, extra, n_extra) for k, n, extra, n_extra in MAIN_WGRAD if extra])
def test_folded_dw_equals_the_unfolded_to_the_bit(dev, k, n, extra, n_extra):
    """The fold adds FMAs beside the wgmma mainloop and leaves its products
    alone: with every point in one block's range (no atomics across ranges),
    dW and db equal the launch without the fold (narrow="walk") to the bit;
    dC agrees with the walk's within 1e-4. A split past the points a folding
    block holds (FOLD_SPLIT) leaves dC to narrow_grads."""
    args, kw = _wgrad_operands(dev, k, n, extra, n_extra, True, 64, 64)
    kw["extra_grad"] = False
    got = FM.siren_dense_wgrad(*args, split=64 * 64, **kw)
    walked = FM.siren_dense_wgrad(*args, split=64 * 64, narrow="walk", **kw)
    assert torch.equal(got[0], walked[0]) and torch.equal(got[1], walked[1])
    assert _rel(got[2], walked[2]) <= 1e-4
    args, kw = _wgrad_operands(dev, k, n, extra, n_extra, True, 80, 64)
    kw["extra_grad"] = False
    narrow = FM.LAUNCHES["narrow_grads"]
    wide = FM.siren_dense_wgrad(*args, split=80 * 64, **kw)
    assert FM.LAUNCHES["narrow_grads"] == narrow + 1
    _hold_wgrad(wide, FM.siren_dense_wgrad_reference(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
@pytest.mark.parametrize("shape", [(1,), (1037,), (1024, 64), (70001,)])
def test_jax_draws_bit_for_bit(dev, seed, shape):
    from satnerf_tpu_torch.ops import jax_draws as JD

    key = jax_prng.prng_key(seed)
    before = JD.LAUNCHES["jax_draws"]
    for draw in (lambda d: JD.bits(key, shape, d),
                 lambda d: JD.uniform(key, shape, d, -2.5, 7.0),
                 lambda d: JD.randint(key, shape, 0, 40961, d),
                 lambda d: JD.randint(key, shape, 5, 6, d),
                 lambda d: JD.normal(key, shape, d)):
        got, want = draw(dev).cpu(), draw("cpu")
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int32) if got.is_floating_point()
                           else got,
                           want.view(torch.int32) if want.is_floating_point()
                           else want)
    assert JD.LAUNCHES["jax_draws"] == before + 5
    n = 1626 if shape == (1,) else int(np.prod(shape))  # 1626: two rounds
    assert torch.equal(JD.permutation(key, n, dev).cpu(),
                       JD.permutation(key, n))


# ---- the pipelined SIMT mainloop (csrc/simt_gemm.cuh) of siren_dense and
# nerf_dense_wgrad: the rule's for every fp32 launch and for bf16 of widths
# no tensor-core mainloop takes. (rays, samples): 65,573 and 1,037 points;
# the wgrad also at 10 points, fewer than one range of its split.
SIMT_POINTS = [(2851, 23), (61, 17)]
SIMT_WIDTHS = [(k, n) for k in (16, 100, 512) for n in (100, 256, 512)]


def _simt_dense_operands(dev, dtype, k, n, extra, n_extra, n_rays, samples,
                         offset):
    rays16, z = _rays16(n_rays, samples, dev, seed=11)
    g = torch.Generator().manual_seed(11)
    p = n_rays * samples
    x = (torch.rand(p, k, generator=g) * 2 - 1).to(dev, dtype)
    w = (torch.randn(k, n, generator=g) / k ** 0.5).to(dev, dtype)
    b = torch.randn(n, generator=g).to(dev)
    c = ((torch.randn(n_extra, n, generator=g) * 0.3).to(dev, dtype)
         if extra else None)
    if offset:  # one element into their storage
        x, w = _odd(x, 1), _odd(w, 1)
    return (x, w, b, rays16, samples), dict(extra=extra, extra_weight=c, z=z,
                                            save=True)


def _hold_simt_dense(dev, dtype, k, n, extra, n_extra, n_rays, samples, offset):
    args, kw = _simt_dense_operands(dev, dtype, k, n, extra, n_extra, n_rays,
                                    samples, offset)
    assert FM.dense_mainloop("siren_dense", dtype, k, n,
                             inputs_aligned=not offset) == "simt"
    before = _count("siren_dense", "simt")
    y, slope = FM.siren_dense(*args, **kw)
    assert _count("siren_dense", "simt") == before + 1
    ref_y, ref_slope = FM.siren_dense_reference(*args, **kw)
    assert y.dtype == dtype and y.shape == ref_y.shape
    _close(y, ref_y, dtype == torch.bfloat16)
    _close(slope, ref_slope, False)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n_rays,samples", SIMT_POINTS)
@pytest.mark.parametrize("k,n,extra,n_extra", [
    (k, n, None, 0) for k, n in SIMT_WIDTHS]
    + [(512, 512, "xyz", 3),   # the skip layer with its E operand
       (100, 99, "t", 4)])     # N not a multiple of 4: scalar stores
def test_siren_dense_simt(dev, k, n, extra, n_extra, n_rays, samples, offset):
    """fp32 on the simt mainloop against the plain version (Y and the saved
    slope); inputs 16-byte aligned and one element off."""
    _hold_simt_dense(dev, torch.float32, k, n, extra, n_extra, n_rays,
                     samples, offset)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n_rays,samples", SIMT_POINTS)
@pytest.mark.parametrize("extra,n_extra", [(None, 0), ("xyz", 3)])
def test_siren_dense_simt_bf16(dev, extra, n_extra, n_rays, samples, offset):
    """bf16 at width 100, which no tensor-core mainloop takes."""
    _hold_simt_dense(dev, torch.bfloat16, 100, 100, extra, n_extra, n_rays,
                     samples, offset)


def _hold_simt_wgrad(dev, dtype, k, n, enc, n_freq, masked, n_rays, samples,
                     offset):
    rays8, z = _rays8(n_rays, samples, dev, seed=12)
    g = torch.Generator().manual_seed(12)
    p = n_rays * samples
    x = (torch.rand(p, k, generator=g) * 2 - 1).to(dev, dtype) if k else None
    dy = torch.randn(p, n, generator=g).to(dev)
    y = (torch.relu(torch.randn(p, n, generator=g)).to(dev, dtype)
         if masked else None)
    if offset:  # one element into their storage
        x, dy, y = (None if t is None else _odd(t, 1) for t in (x, dy, y))
    args = (x, dy, y, rays8, samples)
    kw = dict(enc=enc, z=z, n_freq=n_freq,
              enc_rows=FN._enc_rows(n_freq) if enc else 0, dtype=dtype)
    assert FM.dense_mainloop("nerf_dense_wgrad", dtype, k, n,
                             e_rows=kw["enc_rows"],
                             inputs_aligned=not offset) == "simt"
    before = dict(FM.LAUNCHES)
    got = FN.nerf_dense_wgrad(*args, **kw)
    assert _grown(before) == {"nerf_dense_wgrad": 1, "nerf_bias_grad": 1}
    assert _count("nerf_dense_wgrad", "simt") >= 1
    ref = FN.nerf_dense_wgrad_reference(*args, **kw)
    for name, a, b in zip(("dW", "db", "dC"), got, ref):
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.shape == b.shape and a.dtype == torch.float32, name
            assert _rel(a, b) <= 1e-4, (name, _rel(a, b))
    if enc:  # the padded rows of the encoding's gradient stay 0
        assert float(got[2][6 * n_freq:].abs().max()) == 0


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n_rays,samples", SIMT_POINTS + [(1, 10)])
@pytest.mark.parametrize("k,n,enc,n_freq,masked", [
    (k, n, None, 0, True) for k, n in SIMT_WIDTHS]
    + [(256, 256, "xyz", 10, True),   # the skip layer: dW, dC (64 rows)
       (0, 256, "xyz", 10, True),     # layer 0: the encoding alone
       (256, 128, "dir", 4, True),    # rgb_0: an encoding of 32 rows
       (256, 256, None, 0, False),    # feats: linear, no mask
       (100, 99, None, 0, True)])     # N not a multiple of 4: scalar atomics
def test_nerf_dense_wgrad_simt(dev, k, n, enc, n_freq, masked, n_rays, samples,
                               offset):
    """fp32 on the simt mainloop (dW, dC against the encoding, and
    nerf_bias_grad's db) against the plain version, within 1e-4 of each
    tensor's largest entry: the same products summed over ranges of points,
    which meet by fp32 atomics."""
    _hold_simt_wgrad(dev, torch.float32, k, n, enc, n_freq, masked, n_rays,
                     samples, offset)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n_rays,samples", SIMT_POINTS)
@pytest.mark.parametrize("enc,n_freq", [(None, 0), ("xyz", 10)])
def test_nerf_dense_wgrad_simt_bf16(dev, enc, n_freq, n_rays, samples, offset):
    """bf16 at width 100, which no tensor-core mainloop takes."""
    _hold_simt_wgrad(dev, torch.bfloat16, 100, 100, enc, n_freq, True, n_rays,
                     samples, offset)


# ---- the two dgrads on the pipelined SIMT mainloop (csrc/simt_gemm.cuh
# dgrad_sgemm): fp32 on every shape, bf16 where no tensor-core mainloop takes
# the launch (N not a multiple of 8, or operands off 16 bytes). 1,037 points
# (not a multiple of the 128-row tile), K 3 / 100 / 512 (dX's columns), N 1 /
# 3 / 100 / 256 / 512 (the reduction), the slope or relu mask and none, onto
# `out=` and not, every operand 4 bytes off 16.
SIMT_DGRAD_POINTS = 1037
SIMT_DGRAD_CASES = [
    (dtype, k, n, offset) for dtype in DTYPES for k in (3, 100, 512)
    for n in (1, 3, 100, 256, 512) for offset in (0, 1)
    if dtype == torch.float32 or n % 8 or offset]


def _hold_simt_dgrad(dev, name, dtype, k, n, gated, accumulate, offset):
    g = torch.Generator().manual_seed(13)
    p = SIMT_DGRAD_POINTS
    dy = torch.randn(p, n, generator=g).to(dev)
    if name == "siren_dense_dgrad":
        gate = (torch.randn(p, n, generator=g) * 30).to(dev) if gated else None
        kernel, plain = FM.siren_dense_dgrad, FM.siren_dense_dgrad_reference
    else:
        gate = (torch.relu(torch.randn(p, n, generator=g)).to(dev, dtype)
                if gated else None)
        kernel, plain = FN.nerf_dense_dgrad, FN.nerf_dense_dgrad_reference
    w = (torch.randn(k, n, generator=g) / n ** 0.5).to(dev, dtype)
    base = torch.randn(p, k, generator=g).to(dev) if accumulate else None
    ref = plain(dy, gate, w, out=None if base is None else base.clone())
    if offset:  # 4 bytes into their storage
        dy, gate, w, base = (None if t is None else _odd(t, 4 // t.element_size())
                             for t in (dy, gate, w, base))
    assert FM.dense_mainloop(name, dtype, k, n, inputs_aligned=not offset,
                             outputs_aligned=not offset) == "simt"
    before = _count(name, "simt")
    got = kernel(dy, gate, w, out=base)
    assert _count(name, "simt") == before + 1
    assert got.shape == (p, k) and got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-4, _rel(got, ref)
    if accumulate:
        assert got.data_ptr() == base.data_ptr()


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype,k,n,offset", SIMT_DGRAD_CASES)
def test_siren_dense_dgrad_simt(dev, dtype, k, n, offset, gated, accumulate):
    """dX = round(dY * slope) . W^T (slope None: round(dY) . W^T) against the
    plain version, within 1e-4 of its largest entry: the same products
    summed in another order."""
    _hold_simt_dgrad(dev, "siren_dense_dgrad", dtype, k, n, gated, accumulate,
                     offset)


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype,k,n,offset", SIMT_DGRAD_CASES)
def test_nerf_dense_dgrad_simt(dev, dtype, k, n, offset, gated, accumulate):
    """dX = round(dY * [Y > 0]) . W^T (Y None: round(dY) . W^T) against the
    plain version, within 1e-4 of its largest entry."""
    _hold_simt_dgrad(dev, "nerf_dense_dgrad", dtype, k, n, gated, accumulate,
                     offset)
