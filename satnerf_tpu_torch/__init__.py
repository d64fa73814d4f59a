"""satnerf_tpu_torch — the PyTorch / CUDA port of satnerf_tpu for NVIDIA Hopper.

The JAX package `satnerf_tpu` is the reference this package is held against.
The port imports `torch` and never `jax` or `flax`; the host-side numpy code
that `satnerf_tpu` already keeps jax-free (config, geo/, data/, the DSM chain
in eval/ and ops/) is imported from there rather than copied.

Layout (module paths mirror satnerf_tpu):
  models/nerf.py       RadianceField (nerf / s-nerf / sat-nerf) + TransientEmbedding
  render/              stratified sampling, alpha compositing, the plain renderer
  ops/fused_mlp.py     fused_render_rays: the serving kernel's wrapper + plain version
  ops/_build.py        nvcc build of csrc/ into build/satnerf_tpu_torch/, ctypes binding
  csrc/                hand-written CUDA C++ for sm_90a
  train/system.py      render-only NeRFSystem (render_image over chunks)
  train/checkpoints.py PL-style .ckpt read/write and the JAX weight bridge
  eval/loader.py       rebuild a system from opts.json + epoch={n}.ckpt
  cli/                 create_dsm and eval_aoi entry points (python -m ...)
"""

__version__ = "0.1.0"
