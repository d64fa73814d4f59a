"""satnerf_tpu_torch — the PyTorch / CUDA port of satnerf_tpu for NVIDIA Hopper.

The JAX package `satnerf_tpu` is the reference this package is held against.
The port imports `torch`, never `jax` or `flax`, and nothing of `satnerf_tpu`:
the host-side numpy code (config, geo/, data/, the DSM chain in eval/ and
ops/, logging) has its own copies here, under the same relative names.

Layout (module paths mirror satnerf_tpu):
  config.py            the experiment flags, with `device` (cuda by default)
  models/nerf.py       RadianceField (nerf / s-nerf / sat-nerf) + TransientEmbedding
  render/              stratified sampling, alpha compositing, the plain renderer
  ops/fused_mlp.py     fused_render_rays and fused_train_loss_grads: the kernels'
                       wrappers, each with its plain version beside it
  ops/_build.py        nvcc build of csrc/ into build/satnerf_tpu_torch/, ctypes binding
  csrc/                hand-written CUDA C++ for sm_90a
  train/               losses, schedules, NeRFSystem (render_image, train_step),
                       the loop (fit, validate), checkpoints and the JAX bridges
  data/, geo/, utils/  the satellite dataset, geodesy and GeoTIFF, a synthetic AOI
  eval/                DSM metrics, product images, rebuild a system from a run
  cli/                 train, create_dsm and eval_aoi entry points (python -m ...)
"""

__version__ = "0.1.0"
