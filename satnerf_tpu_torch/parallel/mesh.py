"""Which rows of the ray set each rank trains on (counterpart of
satnerf_tpu/parallel/mesh.py `shard_rays`).

The model is replicated on every rank; the ray axis is split. Every process
loads the whole ray set, pads it with zero rows to a multiple of the world
size, and keeps the contiguous block of rows that `shard_rays` in the JAX
package gives the device of its rank on a 1-D mesh in device order: rank r
of w keeps rows [r * n / w, (r + 1) * n / w) of the padded n. The padding
rows are data of the last rank, as they are in the JAX package.
"""

from __future__ import annotations

import numpy as np


def shard_rows(n_rows: int, world: int, rank: int) -> tuple:
    """(lo, hi, padded): rank's block [lo, hi) of the rows padded to
    `padded`, the next multiple of `world`."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    padded = n_rows + (-n_rows) % world
    per = padded // world
    return rank * per, (rank + 1) * per, padded


def shard_rays(*arrays, world: int, rank: int, pad_value=0.0):
    """Each array's block of rows for `rank` (numpy, along axis 0) after the
    padding to a multiple of `world`. Returns (padded_len, [blocks...])."""
    padded, out = None, []
    for a in arrays:
        a = np.asarray(a)
        lo, hi, padded = shard_rows(a.shape[0], world, rank)
        rem = padded - a.shape[0]
        if rem:
            a = np.pad(a, [(0, rem)] + [(0, 0)] * (a.ndim - 1),
                       constant_values=pad_value)
        out.append(np.ascontiguousarray(a[lo:hi]))
    return padded, out
