"""The port's kernels and their wrappers. Each wrapper adds one to its
kernel's count where it launches it; these read and clear every count."""


def launch_counts() -> dict:
    """Every kernel's launches: ops/fused_mlp.py's LAUNCHES (the nerf
    variant's kernels among them), siren_dense's K = 0 kernel apart
    ("siren_dense_k0": its launches on the "k0" mainloop), and the draw
    kernel's (ops/jax_draws.py)."""
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.ops import jax_draws as JD

    return {**FM.LAUNCHES, **JD.LAUNCHES,
            "siren_dense_k0": FM.MAINLOOP_LAUNCHES.get(("siren_dense", "k0"), 0)}


def reset_launch_counts() -> None:
    """Every count launch_counts reads to 0."""
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.ops import jax_draws as JD

    FM.reset_launches()
    JD.reset_launches()
