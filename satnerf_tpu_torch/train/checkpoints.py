"""PL-style checkpoints and the weight bridge from the JAX package.

On disk a port checkpoint is `{ckpts_dir}/{exp_name}/epoch={n}.ckpt`, a
torch.save of {"state_dict": {nerf_coarse.*, [nerf_fine.*,] embedding_t.weight}}
— the reference's PyTorch-Lightning payload, which
satnerf_tpu.train.checkpoints.import_torch_checkpoint already reads. The
params container of train/system.py is an nn.ModuleDict with exactly those
keys, so its state_dict() is the payload. A training checkpoint adds, under
the PL names, "optimizer_states" ([Adam's state_dict]) and "global_step";
one without them still loads for serving.

The JAX package writes msgpack checkpoints under the same names:
{params, opt_state, step}, the parameter pytree {coarse[, fine][, t]}, and
`opt_state` the state dict of optax.adam(schedule), {"0": {count, mu, nu},
"1": {count}}. `load_checkpoint` tells the two formats apart by their first
bytes, as satnerf_tpu/eval/loader.py does, and reads a msgpack file through
train/msgpack_ckpt.py (no flax, no msgpack package), the weights through
`params_from_jax` and the Adam moments and count through `adam_from_jax`.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from satnerf_tpu_torch.train.msgpack_ckpt import read_msgpack


def checkpoint_path(ckpts_dir: str, exp_name: str, epoch: int) -> str:
    return os.path.join(ckpts_dir, exp_name, f"epoch={epoch}.ckpt")


def jax_init_name(model: str, layers: int, units: int, seed: int) -> str:
    """File name of the JAX package's initial checkpoint of a configuration:
    what its `fit` starts from, `NeRFSystem(cfg).init_state(PRNGKey(seed))`
    written by its `save_checkpoint` at step 0."""
    return f"jax_init_{model}_{layers}x{units}_seed{seed}.ckpt"


def jax_init_path(init_dir: str, model: str, layers: int, units: int,
                  seed: int) -> str:
    """The JAX initial checkpoint for (model, layers x units, seed) in
    `init_dir`; FileNotFoundError naming the file when it is not there."""
    path = os.path.join(init_dir, jax_init_name(model, layers, units, seed))
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no JAX initial checkpoint for {model} {layers} x {units} seed "
            f"{seed}: looked for {path}")
    return path


def jax_dense_names(variant: str, layers: int):
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
        for jax_name, torch_name in jax_dense_names(variant, layers):
            d = params_np[ours][jax_name]["Dense_0"]
            # np.array copies into C order in one pass (torch.tensor of the
            # transposed view copies element by element), so the result
            # owns writable memory
            sd[f"{prefix}.{torch_name}.weight"] = torch.from_numpy(np.array(
                np.asarray(d["kernel"], np.float32).T, order="C"))
            sd[f"{prefix}.{torch_name}.bias"] = torch.tensor(
                np.asarray(d["bias"], np.float32))
    if "t" in params_np:
        sd["embedding_t.weight"] = torch.tensor(
            np.asarray(params_np["t"]["embedding"], np.float32))
    return sd


def adam_from_jax(optimizer: torch.optim.Adam, params: torch.nn.Module,
                  mu: dict, nu: dict, count: int, variant: str,
                  layers: int = 8) -> None:
    """Fill `optimizer` (an Adam over params.parameters()) with an optax
    adam state: `mu` and `nu` are parameter-shaped pytrees of numpy arrays
    ({coarse[, fine][, t]}, as params_from_jax takes them), `count` the number
    of updates taken. Moments go through the same bridge as the weights."""
    moments = [params_from_jax(m, variant, layers) for m in (mu, nu)]
    step = torch.tensor(float(count))
    for name, p in params.named_parameters():
        optimizer.state[p] = {
            "step": step.clone(),
            "exp_avg": moments[0][name].to(p.device, p.dtype),
            "exp_avg_sq": moments[1][name].to(p.device, p.dtype),
        }


def save_checkpoint(path: str, params: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None,
                    step: int | None = None) -> None:
    """Write params.state_dict() as a PL-style {"state_dict": ...} payload;
    with an optimizer and a step, also "optimizer_states" and "global_step"
    so training resumes from it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = {k: v.detach().float().cpu() for k, v in params.state_dict().items()}
    payload = {"state_dict": sd}
    if optimizer is not None:
        opt = optimizer.state_dict()
        opt["state"] = {k: {n: (v.detach().cpu() if torch.is_tensor(v) else v)
                            for n, v in st.items()}
                        for k, st in opt["state"].items()}
        payload["optimizer_states"] = [opt]
    if step is not None:
        payload["global_step"] = int(step)
    torch.save(payload, path)


def _float_numpy(tree):
    """The decoded pytree with every array as float32 numpy (bfloat16
    arrays come out of the decoder as torch tensors)."""
    if isinstance(tree, dict):
        return {k: _float_numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.float().numpy()
    return np.asarray(tree, np.float32)


def _jax_layout(params_np: dict) -> tuple:
    """(variant, layers) of a JAX parameter pytree, read from its names: the
    trunk's fc_i, and the heads only s-nerf (sun_v_*) and sat-nerf (beta_*)
    have."""
    coarse = params_np["coarse"]
    layers = sum(1 for k in coarse if re.fullmatch(r"fc_\d+", k))
    variant = ("sat-nerf" if "beta_0" in coarse
               else "s-nerf" if "sun_v_0" in coarse else "nerf")
    return variant, layers


def _load_jax_checkpoint(path: str, params: torch.nn.Module,
                        optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load a msgpack checkpoint of the JAX package into `params` (strict
    key match) and, given an Adam over params.parameters(), its optax Adam
    moments and count into `optimizer`. Returns the JAX step."""
    raw = read_msgpack(path)
    params_np = _float_numpy(raw["params"])
    variant, layers = _jax_layout(params_np)
    params.load_state_dict(params_from_jax(params_np, variant, layers))
    if optimizer is not None and raw.get("opt_state"):
        adam = raw["opt_state"]["0"]
        adam_from_jax(optimizer, params, _float_numpy(adam["mu"]),
                      _float_numpy(adam["nu"]), int(adam["count"]), variant,
                      layers)
    return int(raw.get("step", 0))


def load_checkpoint(path: str, params: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load a PL-style checkpoint into `params` (strict key match) and, when
    both are there, its optimizer state into `optimizer`. Returns the
    checkpoint's global step (0 for one written without it).

    A torch checkpoint is a zip archive and starts with b"PK"; anything else
    is taken for a msgpack checkpoint of the JAX package
    (_load_jax_checkpoint)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        return _load_jax_checkpoint(path, params, optimizer)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    params.load_state_dict(ckpt.get("state_dict", ckpt))
    if optimizer is not None and ckpt.get("optimizer_states"):
        optimizer.load_state_dict(ckpt["optimizer_states"][0])
    return int(ckpt.get("global_step", 0))
