"""Loss library: NeRF MSE, S-NeRF solar correction, Sat-NeRF beta-uncertainty
and depth supervision, plain functions over the render-result dict of tensors.

Counterpart of satnerf_tpu/train/losses.py (reference metrics.py:8-103),
with its two deliberate fixes: the fine-branch uncertainty loss uses
beta_fine, and the depth loss takes the weighted mean explicitly. These are
the losses of the CPU path and of the plain version of the training kernel.
"""

from __future__ import annotations

import torch

BETA_MIN = 0.05


def _typs(results: dict):
    return ["coarse", "fine"] if "rgb_fine" in results else ["coarse"]


def nerf_loss(results: dict, targets):
    """Plain MSE color loss (metrics.py:8-19)."""
    loss_dict = {}
    for typ in _typs(results):
        loss_dict[f"{typ}_color"] = torch.mean((results[f"rgb_{typ}"] - targets) ** 2)
    return sum(loss_dict.values()), loss_dict


def solar_correction_terms(results: dict, typ: str, lambda_sc: float):
    """Terms 2+3 of the S-NeRF solar-correction loss (metrics.py:27-34).

    term2 ties predicted sun visibility to the (detached) transparency along
    sun rays; term3 pushes the visibility integral toward 1.
    """
    sun_sc = results[f"sun_sc_{typ}"][..., 0]  # (N, S)
    trans = results[f"transparency_sc_{typ}"].detach()
    weights = results[f"weights_sc_{typ}"].detach()
    term2 = torch.sum((trans - sun_sc) ** 2, dim=-1)
    term3 = 1.0 - torch.sum(weights * sun_sc, dim=-1)
    return (
        lambda_sc / 3.0 * torch.mean(term2),
        lambda_sc / 3.0 * torch.mean(term3),
    )


def snerf_loss(results: dict, targets, lambda_sc: float = 0.05):
    """MSE + solar correction (metrics.py:36-54)."""
    loss_dict = {}
    for typ in _typs(results):
        loss_dict[f"{typ}_color"] = torch.mean((results[f"rgb_{typ}"] - targets) ** 2)
        if lambda_sc > 0 and f"sun_sc_{typ}" in results:
            t2, t3 = solar_correction_terms(results, typ, lambda_sc)
            loss_dict[f"{typ}_sc_term2"] = t2
            loss_dict[f"{typ}_sc_term3"] = t3
    return sum(loss_dict.values()), loss_dict


def uncertainty_aware_terms(results: dict, targets, typ: str):
    """Beta-uncertainty color + log-beta terms (metrics.py:21-25).

    beta is the weight-integrated per-sample uncertainty plus BETA_MIN; the
    +3/2 offset keeps the log term positive given BETA_MIN = 0.05. A render
    that integrates beta itself supplies it as `beta_ray_{typ}` (N, 1);
    otherwise it is reduced here from the per-sample weights and beta.
    """
    if f"beta_ray_{typ}" in results:
        beta = results[f"beta_ray_{typ}"] + BETA_MIN
    else:
        beta = (
            torch.sum(results[f"weights_{typ}"][..., None] * results[f"beta_{typ}"],
                      dim=-2)
            + BETA_MIN
        )
    color = torch.mean((results[f"rgb_{typ}"] - targets) ** 2 / (2.0 * beta**2))
    logbeta = (3.0 + torch.mean(torch.log(beta))) / 2.0
    return color, logbeta


def satnerf_loss(results: dict, targets, lambda_sc: float = 0.0):
    """Uncertainty-aware loss + optional solar correction (metrics.py:56-73)."""
    loss_dict = {}
    for typ in _typs(results):
        color, logbeta = uncertainty_aware_terms(results, targets, typ)
        loss_dict[f"{typ}_color"] = color
        loss_dict[f"{typ}_logbeta"] = logbeta
        if lambda_sc > 0 and f"sun_sc_{typ}" in results:
            t2, t3 = solar_correction_terms(results, typ, lambda_sc)
            loss_dict[f"{typ}_sc_term2"] = t2
            loss_dict[f"{typ}_sc_term3"] = t3
    return sum(loss_dict.values()), loss_dict


def depth_loss(results: dict, target_depths, weights=1.0, lambda_ds: float = 1.0):
    """Weighted MSE on predicted ray termination depth (metrics.py:75-92).

    `weights` are the bundle-adjustment reprojection-error weights; lambda is
    scaled by 1/3 like the reference.
    """
    lam = lambda_ds / 3.0
    loss_dict = {}
    for typ in _typs(results):
        per_ray = (results[f"depth_{typ}"] - target_depths) ** 2
        loss_dict[f"{typ}_ds"] = lam * torch.mean(weights * per_ray)
    return sum(loss_dict.values()), loss_dict


def load_loss(variant: str, lambda_sc: float = 0.0):
    """Loss factory mirroring metrics.py:94-103."""
    if variant == "nerf":
        return lambda results, targets: nerf_loss(results, targets)
    if variant == "s-nerf":
        return lambda results, targets: snerf_loss(results, targets, lambda_sc)
    if variant == "sat-nerf":
        return lambda results, targets: satnerf_loss(results, targets, lambda_sc)
    raise ValueError(f"model {variant!r} is not valid")
