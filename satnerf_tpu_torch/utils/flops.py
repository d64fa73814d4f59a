"""Analytic FLOP model of the radiance fields — the basis of MFU figures and
of a speed-of-light rate on the card this port runs on.

Counts useful (unpadded) multiply-accumulates of the field MLP per sample
point, mirroring the layer dims of models/nerf.py (reference models/nerf.py
160-177, snerf.py 124-139, satnerf.py 151-153). Compositing/loss FLOPs are
O(R*S) elementwise and negligible next to the O(R*S*F^2) field.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
# sheet), FLOP/s: dense bf16 on the tensor cores, and fp32 on the CUDA cores
# (the port's fp32 kernels are SIMT FMAs, no TF32). The defaults below.
H100_PEAK_BF16 = 989e12
H100_PEAK_F32 = 67e12
# The TPU v5e's dense peaks, kept for importers of the JAX package's names.
V5E_PEAK_BF16 = 197e12
V5E_PEAK_F32 = V5E_PEAK_BF16 / 4  # MXU f32 passes at 1/4 rate


def field_macs_per_point(model: str = "sat-nerf", layers: int = 8,
                         feat: int = 512, tau: int = 4) -> int:
    """Multiply-accumulates per sample point for one field evaluation."""
    fh = feat // 2
    if model == "nerf":
        # posenc inputs: xyz -> 3*2*10 = 60 dims, viewdir -> 3*2*4 = 24
        in_x, in_d = 60, 24
        macs = in_x * feat + (layers - 1) * feat * feat   # trunk
        macs += in_x * feat                               # skip concat rows
        macs += feat * 1                                  # sigma head
        macs += feat * feat                               # feats head
        macs += (feat + in_d) * fh + fh * 3               # rgb_0, rgb_1
        return macs
    macs = 3 * feat + (layers - 1) * feat * feat  # trunk (fc_0 + fc_1..L-1)
    macs += 3 * feat                              # skip concat rows (xyz)
    macs += feat * 1                              # sigma head
    macs += feat * feat                           # feats head
    macs += feat * fh + fh * 3                    # rgb_0, rgb_1
    macs += (feat + 3) * fh + 2 * fh * fh + fh * 1  # sun_v_0..out
    macs += 3 * fh + fh * 3                       # sky_0, sky_1
    if model == "sat-nerf":
        macs += (feat + tau) * fh + fh * 1        # beta_0, beta_1
    return macs


def flops_per_ray(model: str = "sat-nerf", layers: int = 8, feat: int = 512,
                  n_samples: int = 64, tau: int = 4, *,
                  mode: str = "train", sc: bool = False,
                  n_importance: int = 0) -> float:
    """Useful FLOPs per ray.

    mode="render": one forward field pass (2 FLOP/MAC).
    mode="train":  the single-kernel fused step = forward recompute + dgrad
                   + wgrad matmuls = 3x the forward FLOPs (the separate
                   forward launch was eliminated — see fused_mlp.py's
                   fused_train_loss_grads). A conventional fwd + recompute-
                   backward design would be 4x.

    sc=True (training only): the solar-correction pass evaluates the field
    once more along the SUN ray (rendering.py:102-108). Since r2 it is also
    loss-in-kernel (fused_sc_loss_grads: recompute + backward in one
    launch) = 3x forward on S points, like the primary pass.

    n_importance>0: hierarchical sampling adds a fine-model pass over the
    sorted union of samples (rendering.py:118-156) — S coarse points plus
    (S + n_importance) fine points, each at the mode's multiplier.
    """
    per_pt = 2.0 * field_macs_per_point(model, layers, feat, tau)
    pts = n_samples + ((n_samples + n_importance) if n_importance > 0 else 0)
    mult = 1.0 if mode == "render" else 3.0
    flops = mult * per_pt * pts
    if sc and mode == "train":
        # one sun pass per model over that model's samples: S coarse
        # (+ S + n_importance fine when hierarchical) = pts points total
        flops += 3.0 * per_pt * pts
    return flops


def speed_of_light_rays_per_sec(model: str = "sat-nerf", layers: int = 8,
                                feat: int = 512, n_samples: int = 64,
                                tau: int = 4, *, mode: str = "train",
                                peak: float = H100_PEAK_BF16) -> float:
    """Compute-bound ceiling (rays/s on one card) at its dense peak, by
    default the H100's bf16 rate."""
    return peak / flops_per_ray(model, layers, feat, n_samples, tau,
                                mode=mode)
