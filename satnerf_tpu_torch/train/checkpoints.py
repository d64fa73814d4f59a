"""PL-style checkpoints and the weight bridge from the JAX package.

On disk a port checkpoint is `{ckpts_dir}/{exp_name}/epoch={n}.ckpt`, a
torch.save of {"state_dict": {nerf_coarse.*, [nerf_fine.*,] embedding_t.weight}}
— the reference's PyTorch-Lightning payload, which
satnerf_tpu.train.checkpoints.import_torch_checkpoint already reads. The
params container of train/system.py is an nn.ModuleDict with exactly those
keys, so its state_dict() is the payload.

Reading the JAX package's msgpack checkpoints needs flax and waits for a
later port (ROADMAP).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def checkpoint_path(ckpts_dir: str, exp_name: str, epoch: int) -> str:
    return os.path.join(ckpts_dir, exp_name, f"epoch={epoch}.ckpt")


def _name_map(variant: str, layers: int):
    """(JAX Dense name, reference torch module path), as
    satnerf_tpu/train/checkpoints.py:116-130."""
    names = [(f"fc_{i}", f"fc_net.{2 * i}") for i in range(layers)]
    names += [("sigma_head", "sigma_from_xyz.0"),
              ("feats_head", "feats_from_xyz"),
              ("rgb_0", "rgb_from_xyzdir.0"),
              ("rgb_1", "rgb_from_xyzdir.2")]
    if variant in ("s-nerf", "sat-nerf"):
        names += [("sun_v_0", "sun_v_net.0"), ("sun_v_1", "sun_v_net.2"),
                  ("sun_v_2", "sun_v_net.4"), ("sun_v_out", "sun_v_net.6"),
                  ("sky_0", "sky_color.0"), ("sky_1", "sky_color.2")]
    if variant == "sat-nerf":
        names += [("beta_0", "beta_from_xyz.0"), ("beta_1", "beta_from_xyz.2")]
    return names


def params_from_jax(params_np: dict, variant: str, layers: int = 8) -> dict:
    """JAX parameter pytree {coarse[, fine][, t]} of numpy arrays -> the
    port's state_dict (float32 CPU tensors), each Dense kernel (in, out)
    transposed to a Linear weight (out, in)."""
    sd = {}
    for ours, prefix in (("coarse", "nerf_coarse"), ("fine", "nerf_fine")):
        if ours not in params_np:
            continue
        for jax_name, torch_name in _name_map(variant, layers):
            d = params_np[ours][jax_name]["Dense_0"]
            # torch.tensor copies, so the result owns writable memory
            sd[f"{prefix}.{torch_name}.weight"] = torch.tensor(
                np.asarray(d["kernel"], np.float32).T)
            sd[f"{prefix}.{torch_name}.bias"] = torch.tensor(
                np.asarray(d["bias"], np.float32))
    if "t" in params_np:
        sd["embedding_t.weight"] = torch.tensor(
            np.asarray(params_np["t"]["embedding"], np.float32))
    return sd


def save_checkpoint(path: str, params: torch.nn.Module) -> None:
    """Write params.state_dict() as a PL-style {"state_dict": ...} payload."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = {k: v.detach().float().cpu() for k, v in params.state_dict().items()}
    torch.save({"state_dict": sd}, path)


def load_checkpoint(path: str, params: torch.nn.Module) -> torch.nn.Module:
    """Load a PL-style checkpoint into `params` (strict key match)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    params.load_state_dict(ckpt.get("state_dict", ckpt))
    return params
