"""A msgpack decoder for the checkpoints of the JAX package, in plain Python.

The JAX package writes `flax.serialization.msgpack_serialize` of
{params, opt_state, step} (satnerf_tpu/train/checkpoints.py). This module
reads the subset of msgpack that writer produces, with neither flax nor the
msgpack package:

- maps, arrays, str, bin, ints, floats, nil and bool;
- ext type 1, an ndarray: a msgpack tuple (shape, dtype name, C-order
  bytes), read into a numpy array, or into a torch.bfloat16 tensor for the
  dtype name "bfloat16" (numpy has no such dtype);
- ext type 2, a Python complex: a msgpack tuple (real, imag);
- ext type 3, a numpy scalar: an ndarray of shape (), returned as the scalar;
- flax's chunked arrays: maps {"__msgpack_chunked_array__": True, "shape",
  "chunks"} of arrays larger than 1 GiB, joined back into one array.

Anything else is refused with a ValueError that names the type byte or the
ext type.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"

# fixed-size formats: type byte -> (struct format, size)
_NUMBERS = {0xca: (">f", 4), 0xcb: (">d", 8),
            0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
            0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# lengths read from the stream: type byte -> (struct format, size) of the length
_LENGTHS = {0xc4: (">B", 1), 0xc5: (">H", 2), 0xc6: (">I", 4),   # bin
            0xc7: (">B", 1), 0xc8: (">H", 2), 0xc9: (">I", 4),   # ext
            0xd9: (">B", 1), 0xda: (">H", 2), 0xdb: (">I", 4),   # str
            0xdc: (">H", 2), 0xdd: (">I", 4),                    # array
            0xde: (">H", 2), 0xdf: (">I", 4)}                    # map
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (the ndarray tuples' dtype names)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wants {n} more)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map_(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.value() for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return self.str_(t & 0x1f)
        if t == 0xc0:
            return None
        if t in (0xc2, 0xc3):
            return t == 0xc3
        if t in _NUMBERS:
            return self.unpack(*_NUMBERS[t])
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        if t not in _LENGTHS:
            raise ValueError(f"msgpack: type byte 0x{t:02x} at byte "
                             f"{self.pos - 1} is not one this reader knows")
        n = self.unpack(*_LENGTHS[t])
        if t <= 0xc6:
            return bytes(self.take(n))
        if t <= 0xc9:
            return self.ext(n)
        if t <= 0xdb:
            return self.str_(n)
        if t <= 0xdd:
            return [self.value() for _ in range(n)]
        return self.map_(n)

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code in (1, 3):
            arr = _ndarray(payload)
            if code == 3:
                return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
            return arr
        if code == 2:
            real, imag = _Reader(payload).value()
            return complex(real, imag)
        raise ValueError(f"msgpack: ext type {code} is not one of flax's "
                         f"(1 ndarray, 2 complex, 3 numpy scalar)")


def _ndarray(payload: bytes):
    shape, name, buf = _Reader(payload, raw=True).value()
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<i2").reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if torch.is_tensor(chunks[0]):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate([np.ravel(c) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The Python tree flax.serialization.msgpack_restore returns for `data`:
    dicts, lists, scalars and numpy arrays (torch.bfloat16 tensors for
    bfloat16 arrays), the chunked arrays joined."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the "
                         f"first object")
    return _unchunk(tree)


def read_msgpack(path: str):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
