"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
no jax, so it runs on the machine with the card:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes cover both siren_dense mainloops (tensor-core bf16 for K, N
multiples of 8; SIMT otherwise and for fp32), its K = 0 elementwise kernel
(vector and scalar stores), ragged row and column tiles,
every E operand, and heads_composite with and without the beta head.
"""

import numpy as np
import pytest
import torch

from satnerf_tpu_torch.models.nerf import build_model
from satnerf_tpu_torch.ops import fused_mlp as FM

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


def test_kernel_refuses_bad_inputs(dev):
    rays16, z = _rays16(4, 8, dev)
    w = torch.zeros(16, 32, device=dev)
    b = torch.zeros(32, device=dev)
    x = torch.zeros(32, 16, device=dev, dtype=torch.bfloat16)  # dtype mismatch
    with pytest.raises(ValueError):
        FM.siren_dense(x, w, b, rays16, 8)
    with pytest.raises(ValueError):  # not contiguous
        FM.siren_dense(torch.zeros(16, 32, device=dev).T, w, b, rays16, 8)
