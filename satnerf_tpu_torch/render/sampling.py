"""Depth sampling along rays (counterpart of satnerf_tpu/render/sampling.py):
the stratified coarse samples and the hierarchical inverse-CDF resampling of
the fine pass.

The JAX forms of `sample_pdf` and `merge_sorted_zvals` are shaped for the TPU
(prefix-mask reductions over a broadcast compare, a rank merge by scatter).
Here they are PyTorch's idiom (cumsum, searchsorted, gathers, a sort of the
concatenation); both select the same values.
"""

from __future__ import annotations

from typing import Optional

import torch


def stratified_zvals(generator: Optional[torch.Generator], near, far,
                     n_samples: int, perturb: float = 1.0,
                     use_disp: bool = False):
    """Sample depths linearly in [near, far], jittered within each bin.

    Mirrors rendering.py:65-78: midpoint bins, uniform jitter within each
    bin. near/far: (N_rays, 1). Returns z_vals (N_rays, n_samples). With
    perturb == 0 (evaluation) the result is deterministic and `generator`
    is not used.
    """
    z_steps = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype,
                             device=near.device)
    if use_disp:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    else:
        z_vals = near * (1.0 - z_steps) + far * z_steps

    if perturb > 0:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([z_mid, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], z_mid], dim=-1)
        u = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                       device=z_vals.device)
        z_vals = lower + (upper - lower) * (perturb * u)
    return z_vals


def merge_sorted_zvals(z_vals, z_fine):
    """The sorted union of two per-ray depth arrays, (N_rays, Sa) and
    (N_rays, Sb) -> (N_rays, Sa + Sb): the reference's sort of the
    concatenation (rendering.py:129-131)."""
    return torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1)[0]


def sample_pdf(generator: Optional[torch.Generator], bins, weights,
               n_importance: int, det: bool = False, eps: float = 1e-5,
               u=None):
    """Draw `n_importance` samples from the piecewise-constant PDF over `bins`.

    Mirrors rendering.py:10-49 (inverse-transform sampling):
      bins:    (N_rays, M+1) bin edges (the coarse z midpoints)
      weights: (N_rays, M)
    u (N_rays, n_importance) in [0, 1) replaces the draw; det uses the
    linspace instead and no generator. Returns (N_rays, n_importance); the
    caller detaches it (the reference .detach()es the result).
    """
    n_rays, m = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (N, M+1)

    if u is None and det:
        u = torch.linspace(0.0, 1.0, n_importance, dtype=bins.dtype,
                           device=bins.device).expand(n_rays, n_importance)
    elif u is None:
        u = torch.rand((n_rays, n_importance), generator=generator,
                       dtype=bins.dtype, device=bins.device)

    # inds = |{j : cdf[j] <= u}| >= 1 (cdf[0] = 0): the bin is [inds-1, inds],
    # clamped at the last edge when u >= cdf[-1]
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below, above = (inds - 1).clamp(min=0), inds.clamp(max=m)
    cdf_lo, cdf_hi = cdf.gather(1, below), cdf.gather(1, above)
    bin_lo, bin_hi = bins.gather(1, below), bins.gather(1, above)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)
