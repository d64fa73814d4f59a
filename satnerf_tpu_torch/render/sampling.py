"""Depth sampling along rays (counterpart of satnerf_tpu/render/sampling.py).

Only the stratified coarse samples are ported so far; hierarchical
resampling (`sample_pdf`, `merge_sorted_zvals`) comes with the fine pass.
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
