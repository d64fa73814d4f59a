"""Transient-embedding indices for validation images.

The Sat-NeRF transient embedding is defined per TRAIN image; validation images
need a surrogate index. The reference hardcodes per-image choices found by a
best-PSNR search (eval_satnerf.py:186-209); `find_best_embedding_for_val_image`
reproduces that search for unseen AOIs (eval_satnerf.py:148-164).
"""

from __future__ import annotations

import numpy as np

_PREDEFINED = {
    "JAX_068": {"JAX_068_013_RGB": 0, "JAX_068_002_RGB": 8, "JAX_068_012_RGB": 1},
    "JAX_004": {"JAX_004_022_RGB": 0, "JAX_004_014_RGB": 0, "JAX_004_009_RGB": 5},
    "JAX_214": {"JAX_214_020_RGB": 0, "JAX_214_006_RGB": 8,
                "JAX_214_001_RGB": 18, "JAX_214_008_RGB": 2},
    "JAX_260": {"JAX_260_015_RGB": 0, "JAX_260_006_RGB": 3, "JAX_260_004_RGB": 10},
}


def predefined_val_ts(img_id: str):
    """Hardcoded embedding index for the DFC2019 val images, else None."""
    aoi_id = img_id[:7]
    table = _PREDEFINED.get(aoi_id)
    if table is None:
        return None
    return table.get(img_id, 0)


def find_best_embedding_for_val_image(system, params, rays, gt_rgbs,
                                      train_indices=None,
                                      max_rays: int = 4096) -> int:
    """Brute-force the train embedding that maximizes PSNR for this image
    (eval_satnerf.py:148-164).

    Unlike the reference (which renders the FULL image once per candidate —
    cheap on its GPU eval path), the search renders only an evenly-strided
    subset of `max_rays` rays per candidate: the argmax over candidates is
    preserved (PSNR over a uniform spatial subsample ranks embeddings the
    same way) at ~1/100 the cost per full-resolution image. Set
    max_rays=0 to force the reference's full-image behavior.

    Collective like `render_image`: every rank of the render group calls it
    with the same arguments, and each picks the same t from the whole
    products it holds."""
    from satnerf_tpu_torch.ops.ssim import psnr

    if train_indices is None:
        train_indices = range(system.cfg.t_embbeding_vocab)
    n = rays.shape[0]
    if max_rays and n > max_rays:
        sub = np.linspace(0, n - 1, max_rays).astype(np.int64)
        rays = np.asarray(rays)[sub]
        gt_rgbs = np.asarray(gt_rgbs)[sub]
    best_t, best_psnr = 0, -np.inf
    for t in train_indices:
        ts = np.full(rays.shape[0], int(t), dtype=np.int32)
        results = system.render_image(params, rays, ts)
        typ = "fine" if "rgb_fine" in results else "coarse"
        p = psnr(results[f"rgb_{typ}"], gt_rgbs)
        if p > best_psnr:
            best_t, best_psnr = int(t), p
    return best_t
