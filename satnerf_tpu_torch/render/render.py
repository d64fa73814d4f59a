"""The plain ray renderer (counterpart of satnerf_tpu/render/render.py).

The coarse pass and the solar-correction sun-ray pass are ported; the
hierarchical fine pass raises NotImplementedError until it is (ROADMAP
queue 1). This is the eager path: the CPU runs it, and it is the plain
version the kernels (ops/fused_mlp.py) are held against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from satnerf_tpu_torch.render.composite import composite
from satnerf_tpu_torch.render.sampling import stratified_zvals


@dataclass(frozen=True)
class RenderConfig:
    variant: str = "sat-nerf"  # nerf | s-nerf | sat-nerf
    n_samples: int = 64
    n_importance: int = 0
    perturb: float = 1.0
    solar_correction: bool = False
    use_disp: bool = False

    @property
    def shadow(self) -> bool:
        return self.variant in ("s-nerf", "sat-nerf")


def run_field(model, rays_o, march_d, rays_d, sun_d, t_embed, z_vals,
              shadow: bool = False,
              dtype: Optional[torch.dtype] = None, noise=None) -> dict:
    """Evaluate the field at o + d*z along each ray and composite.

    rays_o/march_d (R,3), rays_d (R,3) view directions or None,
    sun_d (R,3) or None, t_embed (R,tau) or None, z_vals (R,S), noise
    (R,S) training-time sigma noise or None.
    """
    xyz = rays_o[:, None, :] + march_d[:, None, :] * z_vals[:, :, None]
    n_rays, n_s, _ = xyz.shape

    def per_sample(v):
        return None if v is None else v[:, None, :].expand(n_rays, n_s, v.shape[-1])

    out = model(xyz, view_dir=per_sample(rays_d), sun_dir=per_sample(sun_d),
                t_embed=per_sample(t_embed), dtype=dtype)
    return composite(out, z_vals, noise=noise, shadow=shadow)


def render_rays(models: dict, rays, t_embed, cfg: RenderConfig,
                generator: Optional[torch.Generator] = None,
                dtype: Optional[torch.dtype] = None, noise=None,
                sc_noise=None) -> dict:
    """Render a batch of rays with the coarse model.

    models: {"coarse": RadianceField}. rays: (N, 11) [o(3), d(3), near, far,
    sun_dir(3)]; (N, 8) without the sun for nerf. t_embed: (N, tau) or None.
    noise, sc_noise: (N, S) training-time sigma noise of the primary pass
    and of the solar-correction pass, or None. Returns the reference-shaped
    dict with keys suffixed _coarse; with cfg.solar_correction the shadow
    variants also march the field along the sun rays (reference
    rendering.py:90-108) and return weights_sc, transparency_sc and sun_sc.
    """
    if cfg.n_importance > 0:
        raise NotImplementedError(
            "hierarchical sampling (n_importance > 0) is not ported yet "
            "(ROADMAP: hierarchical serve)")
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    sun_d = rays[:, 8:11] if (cfg.shadow and rays.shape[1] >= 11) else None
    z_vals = stratified_zvals(generator, near, far, cfg.n_samples, cfg.perturb,
                              cfg.use_disp)
    use_dirs = cfg.variant == "nerf"
    result = run_field(models["coarse"], rays_o, rays_d,
                       rays_d if use_dirs else None, sun_d, t_embed, z_vals,
                       shadow=cfg.shadow, dtype=dtype, noise=noise)
    if cfg.shadow and cfg.solar_correction:
        # the sun direction is both the march direction and the sun input
        sc = run_field(models["coarse"], rays_o, sun_d, None, sun_d, t_embed,
                       z_vals, shadow=True, dtype=dtype, noise=sc_noise)
        result["weights_sc"] = sc["weights"]
        result["transparency_sc"] = sc["transparency"]
        result["sun_sc"] = sc["sun"]
    return {f"{k}_coarse": v for k, v in result.items()}
