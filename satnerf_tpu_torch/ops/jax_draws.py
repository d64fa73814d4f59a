"""jax.random's draws as the JAX package's training makes them, on the device
the tensors live on: csrc/jax_draws.cu on the card, utils/jax_prng.py (numpy,
the plain version) on the CPU, the same bits on both.

Each function takes a raw key (uint32[2], jax_prng's) and a shape and returns
a tensor on `device`: `bits` (int32 holding the uint32 words), `uniform`
(float32), `randint` (int64 holding JAX's int32 values) and `normal`
(float32). On the card each is one launch of `satnerf_jax_draws`, counted in
LAUNCHES["jax_draws"]; there it never gives way to the plain version.
`permutation` is JAX's `_shuffle`: a launch of bits a round and a stable
torch.sort by them.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from satnerf_tpu_torch.utils import jax_prng

LAUNCHES = {"jax_draws": 0}
_MODES = {"bits": (0, torch.int32), "uniform": (1, torch.float32),
          "randint": (2, torch.int64), "normal": (3, torch.float32)}
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def reset_launches() -> None:
    LAUNCHES["jax_draws"] = 0


@functools.lru_cache(maxsize=1)
def _entry():
    """The C entry satnerf_jax_draws (the kernels built and loaded at the
    first call)."""
    from satnerf_tpu_torch.ops._build import load_library

    return load_library().satnerf_jax_draws


def launch(mode: str, key, shape: Sequence[int], device, *, lo: float = 0.0,
           scale: float = 0.0, span: int = 1, mult: int = 0,
           minval: int = 0) -> torch.Tensor:
    """One launch of satnerf_jax_draws on the card: a fresh tensor of
    `shape` on `device` (CUDA) in the mode's type."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"jax_draws launches on CUDA, not {device}")
    code, dtype = _MODES[mode]
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    err = _entry()(code, int(key[0]), int(key[1]), out.numel(), float(lo),
                   float(scale), int(span), int(mult), int(minval),
                   out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES["jax_draws"] += 1
    if err != 0:
        raise RuntimeError(f"jax_draws launch failed: CUDA error {err}")
    return out


def _on(device) -> bool:
    """True where the draw runs on the card."""
    return torch.device(device).type == "cuda"


def bits(key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """jax.random.bits(key, shape, uint32), the words as int32."""
    if _on(device):
        return launch("bits", key, shape, device)
    return torch.from_numpy(jax_prng.random_bits(key, shape).view(np.int32))


def uniform(key, shape: Sequence[int], device="cpu", minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    if _on(device):
        lo, scale = jax_prng.uniform_scale(minval, maxval)
        return launch("uniform", key, shape, device, lo=lo, scale=scale)
    return torch.from_numpy(jax_prng.uniform(key, shape, minval, maxval))


def randint(key, shape: Sequence[int], minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) (int32 values), as
    int64 for indexing. The kernel splits the key itself."""
    if _on(device):
        span, mult = jax_prng.randint_span(minval, maxval)
        return launch("randint", key, shape, device, span=span, mult=mult,
                      minval=minval)
    return torch.from_numpy(
        jax_prng.randint(key, shape, minval, maxval).astype(np.int64))


def normal(key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """jax.random.normal(key, shape, float32)."""
    if _on(device):
        lo, scale = jax_prng.uniform_scale(NORMAL_LO, 1.0)
        return launch("normal", key, shape, device, lo=lo, scale=scale)
    return torch.from_numpy(jax_prng.normal(key, shape))


def permutation(key, n: int, device="cpu") -> torch.Tensor:
    """jax.random.permutation(key, n) as int64: a round of bits, split from
    the key, and a stable sort of the positions by them, as many rounds as
    JAX takes (jax_prng.permutation_rounds)."""
    if not _on(device):
        return torch.from_numpy(jax_prng.permutation(key, n).astype(np.int64))
    x = torch.arange(n, device=device)
    for _ in range(jax_prng.permutation_rounds(n)):
        key, sub = jax_prng.split(key)
        order = torch.sort(bits(sub, (n,), device).long() & 0xFFFFFFFF,
                           stable=True).indices
        x = x[order]
    return x

