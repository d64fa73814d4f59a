"""The plain ray renderer (counterpart of satnerf_tpu/render/render.py).

The coarse pass, the hierarchical fine pass and the solar-correction
sun-ray pass of each. This is the eager path: with field modules it is what
the CPU runs and the plain version the kernels (ops/fused_mlp.py) are held
against; with the per-sample field kernels as its models (`--fused on`, the
hierarchical depth pass) it also runs on the card, the compositor staying
plain tensor code as it is plain XLA in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from satnerf_tpu_torch.render.composite import composite
from satnerf_tpu_torch.render.sampling import (merge_sorted_zvals, sample_pdf,
                                               stratified_zvals)


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
    (R,S) training-time sigma noise or None. `model` is one of:
      * a field module (RadianceField): the points are expanded here and
        `dtype` is its matmul operand type;
      * a callable (xyz, view_dir, sun_dir, t_embed) -> dict on expanded
        points (the point-mode kernel, ops/fused_mlp.fused_field_apply);
      * a callable with `.ray_mode = True`, (rays_o, march_d, sun_d, t_embed,
        z_vals) -> dict: the expansion happens inside it
        (ops/fused_mlp.fused_field_apply_rays).
    """
    if getattr(model, "ray_mode", False):
        out = model(rays_o, march_d, sun_d, t_embed, z_vals)
        return composite(out, z_vals, noise=noise, shadow=shadow)
    xyz = rays_o[:, None, :] + march_d[:, None, :] * z_vals[:, :, None]
    n_rays, n_s, _ = xyz.shape

    def per_sample(v):
        return None if v is None else v[:, None, :].expand(n_rays, n_s, v.shape[-1])

    if isinstance(model, torch.nn.Module):
        out = model(xyz, view_dir=per_sample(rays_d), sun_dir=per_sample(sun_d),
                    t_embed=per_sample(t_embed), dtype=dtype)
    else:
        out = model(xyz, per_sample(rays_d), per_sample(sun_d),
                    per_sample(t_embed))
    return composite(out, z_vals, noise=noise, shadow=shadow)


def render_rays(models: dict, rays, t_embed, cfg: RenderConfig,
                generator: Optional[torch.Generator] = None,
                dtype: Optional[torch.dtype] = None, noise=None,
                sc_noise=None, *, z_vals=None, u=None, fine_noise=None,
                sc_noise_fine=None) -> dict:
    """Render a batch of rays.

    models: {"coarse": model[, "fine": model]}, each as run_field takes it.
    rays: (N, 11) [o(3), d(3), near, far, sun_dir(3)]; (N, 8) without the
    sun for nerf. t_embed: (N, tau) or None. noise, sc_noise: (N, S)
    training-time sigma noise of the primary pass and of the
    solar-correction pass, or None; fine_noise, sc_noise_fine
    (N, S + n_importance) the same for the fine model. z_vals (N, S) and u
    (N, n_importance) replace the draws from `generator` (the stratified
    depths; the uniforms of the resampling, drawn only when cfg.perturb > 0).
    Returns the reference-shaped dict with keys suffixed _coarse / _fine;
    with cfg.solar_correction the shadow variants also march each field
    along the sun rays (reference rendering.py:90-108) and return
    weights_sc, transparency_sc and sun_sc.
    """
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    sun_d = rays[:, 8:11] if (cfg.shadow and rays.shape[1] >= 11) else None
    if z_vals is None:
        z_vals = stratified_zvals(generator, near, far, cfg.n_samples,
                                  cfg.perturb, cfg.use_disp)
    view_d = rays_d if cfg.variant == "nerf" else None

    def run(model, z, noise, sc_noise):
        result = run_field(model, rays_o, rays_d, view_d, sun_d, t_embed, z,
                           shadow=cfg.shadow, dtype=dtype, noise=noise)
        if cfg.shadow and cfg.solar_correction:
            # the sun direction is both the march direction and the sun input
            sc = run_field(model, rays_o, sun_d, None, sun_d, t_embed, z,
                           shadow=True, dtype=dtype, noise=sc_noise)
            result["weights_sc"] = sc["weights"]
            result["transparency_sc"] = sc["transparency"]
            result["sun_sc"] = sc["sun"]
        return result

    result = run(models["coarse"], z_vals, noise, sc_noise)
    out = {f"{k}_coarse": v for k, v in result.items()}
    if cfg.n_importance > 0:
        z_all = resample_zvals(generator, z_vals, result["weights"],
                               cfg.n_importance, det=(cfg.perturb == 0), u=u)
        fine = run(models["fine"], z_all, fine_noise, sc_noise_fine)
        out.update({f"{k}_fine": v for k, v in fine.items()})
    return out


def resample_zvals(generator, z_vals, weights, n_importance: int, det: bool,
                   u=None):
    """The fine pass's depths (rendering.py:118-131): n_importance samples
    of the PDF the coarse weights define over the depth midpoints, detached,
    merged with the coarse depths into one sorted (N, S + n_importance)."""
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine = sample_pdf(generator, z_mid, weights[:, 1:-1].detach(),
                        n_importance, det=det, u=u)
    return merge_sorted_zvals(z_vals, z_fine.detach())
