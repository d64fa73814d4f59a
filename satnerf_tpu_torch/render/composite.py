"""Alpha compositing along rays (counterpart of satnerf_tpu/render/composite.py).

  deltas_i = z_{i+1} - z_i (last = 1e10)
  alpha_i  = 1 - exp(-delta_i * relu(sigma_i + noise))
  T_i      = prod_{j<i} (1 - alpha_j + 1e-10)
  w_i      = alpha_i * T_i
  rgb      = sum_i w_i * c_i [* irradiance_i]     (irradiance for shadow variants)
  depth    = sum_i w_i * z_i

The shadow variants modulate albedo by irradiance = sun_v + (1-sun_v)*sky_rgb
and clip the final rgb to [0, 1].
"""

from __future__ import annotations

import torch


def ray_weights(sigmas, z_vals, noise=None):
    """(alphas, transparency, weights) from per-sample densities.

    sigmas, z_vals: (N_rays, S). noise: optional (N_rays, S) sigma noise.
    """
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    # the last interval is 1e10 (of z's shape: one sample a ray has one)
    deltas = torch.cat([deltas, torch.full_like(z_vals[:, :1], 1e10)], dim=-1)
    if noise is not None:
        sigmas = sigmas + noise
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10],
                        dim=-1)
    transparency = torch.cumprod(shifted, dim=-1)[:, :-1]
    return alphas, transparency, alphas * transparency


def composite(out: dict, z_vals, noise=None, shadow: bool = False) -> dict:
    """Composite per-sample field outputs into per-ray quantities.

    out: rgb (N,S,3), sigma (N,S) and optionally sun_v (N,S,1),
    sky_rgb (N,S,3), beta (N,S,1). Returns rgb (N,3), depth (N,),
    weights/transparency (N,S) and the per-sample extras passed through
    (albedo/sun/sky/beta), like the reference result dicts.
    """
    _, transparency, weights = ray_weights(out["sigma"], z_vals, noise)
    depth = torch.sum(weights * z_vals, dim=-1)
    if shadow:
        irradiance = out["sun_v"] + (1.0 - out["sun_v"]) * out["sky_rgb"]
        rgb = torch.sum(weights[..., None] * out["rgb"] * irradiance, dim=-2)
        rgb = torch.clamp(rgb, 0.0, 1.0)
    else:
        rgb = torch.sum(weights[..., None] * out["rgb"], dim=-2)
    result = {"rgb": rgb, "depth": depth, "weights": weights,
              "transparency": transparency}
    if shadow:
        result["albedo"] = out["rgb"]
        result["sun"] = out["sun_v"]
        result["sky"] = out["sky_rgb"]
    if "beta" in out:
        result["beta"] = out["beta"]
    return result
