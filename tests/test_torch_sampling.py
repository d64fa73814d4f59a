"""The port's hierarchical resampling against the JAX package's, float32 on
the CPU, the same numpy-seeded inputs on both sides.

`sample_pdf` here is cumsum + searchsorted + gathers, there a prefix-mask
reduction; `merge_sorted_zvals` here a sort of the concatenation, there a rank
merge by scatter. Both select the same values; the two cumsums may differ in
the last bit, and a bin of probability mass p magnifies that bit by 1 / p on
its way to the sample. So the tolerance is 1e-6 * (far - near) on weights
whose bins all hold a fair share of the mass (each within [0.75, 1.25] of a
common level, or all zero), and 1e-4 * (far - near) on peaked weights (the
cube of a uniform draw, where hit bins hold as little as 1e-3 of it). The
injected u are kept 1e-4 away from every cdf entry (a u that ties a cdf entry
to the last bit could fall into either neighbouring bin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.render import sampling as SJ
from satnerf_tpu_torch.render import sampling as ST

torch.set_num_threads(1)

NEAR, FAR = 2.0, 6.0
TOL = 1e-6 * (FAR - NEAR)
TOL_PEAKED = 1e-4 * (FAR - NEAR)
SHAPES = [(37, 6, 4, False), (16, 62, 16, False), (37, 6, 4, True),
          (16, 62, 16, True)]


def _bins_weights(n_rays, m, seed, peaked=False):
    rng = np.random.RandomState(seed)
    z = np.sort(rng.uniform(NEAR, FAR, (n_rays, m + 2)).astype(np.float32), -1)
    bins = 0.5 * (z[:, :-1] + z[:, 1:])  # (N, M+1) midpoints
    weights = rng.rand(n_rays, m).astype(np.float32)
    weights = weights ** 3 if peaked else 0.75 + 0.5 * weights
    weights[0] = 0.0  # a ray the coarse pass saw nothing on
    weights[1, : m // 2] = 0.0  # empty bins: cdf steps of eps only
    return bins, weights


def _cdf(weights, eps=1e-5):
    w = weights.astype(np.float64) + eps
    cdf = np.cumsum(w / w.sum(-1, keepdims=True), -1)
    return np.concatenate([np.zeros_like(cdf[:, :1]), cdf], -1)


def _safe_u(weights, n_imp, seed):
    """Uniforms at least 1e-4 away from every cdf entry of their ray, with
    the edge cases u = 0 and u >= cdf[-1] in the first two columns."""
    rng = np.random.RandomState(seed)
    cdf = _cdf(weights)
    u = rng.rand(weights.shape[0], n_imp)
    for _ in range(50):
        near = (np.abs(u[:, :, None] - cdf[:, None, :]) < 1e-4).any(-1)
        if not near.any():
            break
        u[near] = rng.rand(int(near.sum()))
    assert not near.any()
    u = u.astype(np.float32)
    u[2:, 0] = 0.0
    u[2:, 1] = 1.0  # at or past the last cdf entry: the clamp at the last bin
    return u


@pytest.mark.parametrize("n_rays,m,n_imp,peaked", SHAPES)
def test_sample_pdf_with_injected_u(n_rays, m, n_imp, peaked):
    bins, weights = _bins_weights(n_rays, m, seed=m, peaked=peaked)
    tol = TOL_PEAKED if peaked else TOL
    u = _safe_u(weights, n_imp, seed=n_imp)

    # the JAX function with its draw replaced by u
    import jax

    orig = jax.random.uniform
    try:
        jax.random.uniform = lambda key, shape, dtype=jnp.float32: jnp.asarray(u)
        ref = np.asarray(SJ.sample_pdf(None, jnp.asarray(bins),
                                       jnp.asarray(weights), n_imp, det=False))
    finally:
        jax.random.uniform = orig
    got = ST.sample_pdf(None, torch.from_numpy(bins), torch.from_numpy(weights),
                        n_imp, u=torch.from_numpy(u))
    assert got.shape == (n_rays, n_imp)
    np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=0)
    # every sample lies inside its ray's bins
    assert (got.numpy() >= bins[:, :1] - tol).all()
    assert (got.numpy() <= bins[:, -1:] + tol).all()
    # u >= cdf[-1] lands on the last edge
    np.testing.assert_allclose(got.numpy()[2:, 1], bins[2:, -1], atol=tol)


@pytest.mark.parametrize("n_rays,m,n_imp,peaked", SHAPES)
def test_sample_pdf_det(n_rays, m, n_imp, peaked):
    """det=True: the linspace of u, no generator. Its interior points are
    moved off the cdf entries by construction of the weights (random), its
    end points 0 and 1 are the two edge cases."""
    bins, weights = _bins_weights(n_rays, m, seed=3 + m, peaked=peaked)
    tol = TOL_PEAKED if peaked else TOL
    cdf = _cdf(weights)
    lin = np.linspace(0.0, 1.0, n_imp)[1:-1]
    # rays whose cdf comes within 1e-4 of an interior linspace point could
    # fall into either bin: leave them out of the comparison
    ok = ~(np.abs(lin[None, :, None] - cdf[:, None, :]) < 1e-4).any((1, 2))
    assert ok.sum() >= n_rays - 3
    ref = np.asarray(SJ.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights),
                                   n_imp, det=True))
    got = ST.sample_pdf(None, torch.from_numpy(bins), torch.from_numpy(weights),
                        n_imp, det=True).numpy()
    np.testing.assert_allclose(got[ok], ref[ok], atol=tol, rtol=0)
    # the all-zero ray is uniform over its bins: its end points are the
    # ends of the bins (its interior points may tie a cdf entry k / m)
    np.testing.assert_allclose(got[0, 0], bins[0, 0], atol=tol)
    np.testing.assert_allclose(got[0, -1], bins[0, -1], atol=tol)


def test_sample_pdf_draws_from_the_generator_only_when_asked():
    """The key is read only when the uniforms are neither given nor the
    linspace; then they are jax.random.uniform(key, (N, n_importance)), as
    in the JAX function at the same key."""
    bins, weights = _bins_weights(8, 6, seed=9)
    b, w = torch.from_numpy(bins), torch.from_numpy(weights)
    ST.sample_pdf(None, b, w, 4, det=True)
    ST.sample_pdf(None, b, w, 4, u=torch.rand(8, 4))
    key = jax.random.PRNGKey(0)
    a = ST.sample_pdf(np.asarray(key), b, w, 4)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (8, 4))))
    assert torch.equal(a, ST.sample_pdf(None, b, w, 4, u=u))
    assert torch.equal(a, ST.sample_pdf(np.asarray(key), b, w, 4))
    ref = np.asarray(SJ.sample_pdf(key, jnp.asarray(bins),
                                   jnp.asarray(weights), 4))
    np.testing.assert_allclose(a.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("sa,sb", [(8, 4), (64, 8), (5, 9)])
def test_merge_sorted_zvals(sa, sb):
    rng = np.random.RandomState(sa)
    n = 23
    a = np.sort(rng.uniform(NEAR, FAR, (n, sa)).astype(np.float32), -1)
    b = np.sort(rng.uniform(NEAR, FAR, (n, sb)).astype(np.float32), -1)
    b[0, :2] = a[0, :2]  # equal elements across the two arrays
    b[1, 1] = b[1, 0]    # and within one
    b = np.sort(b, -1)
    ref = np.asarray(SJ.merge_sorted_zvals(jnp.asarray(a), jnp.asarray(b)))
    got = ST.merge_sorted_zvals(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (n, sa + sb)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert (np.diff(got, axis=-1) >= 0).all()
    # an unsorted second array gives the same union
    shuffled = torch.from_numpy(b[:, rng.permutation(sb)].copy())
    again = ST.merge_sorted_zvals(torch.from_numpy(a), shuffled).numpy()
    np.testing.assert_array_equal(again, got)
