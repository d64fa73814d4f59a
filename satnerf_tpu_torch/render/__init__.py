from satnerf_tpu_torch.render.composite import composite, ray_weights
from satnerf_tpu_torch.render.render import RenderConfig, render_rays
from satnerf_tpu_torch.render.sampling import stratified_zvals

__all__ = ["RenderConfig", "composite", "ray_weights", "render_rays",
           "stratified_zvals"]
