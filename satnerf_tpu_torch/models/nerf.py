"""Radiance-field MLPs: NeRF, Shadow-NeRF and Sat-NeRF in one nn.Module.

Counterpart of satnerf_tpu/models/nerf.py. Submodules carry the reference
torch names (fc_net.{2i}, sigma_from_xyz.0, feats_from_xyz,
rgb_from_xyzdir.{0,2}, sun_v_net.{0,2,4,6}, sky_color.{0,2},
beta_from_xyz.{0,2}), so `satnerf_tpu.train.checkpoints.export_torch_state_dict`
output loads with `load_state_dict` unchanged.

Initialization reproduces the torch distributions the JAX package mirrors
(satnerf_tpu/models/nerf.py:38-61), drawn from an explicit generator:
Linear kernels and biases U(+-1/sqrt(fan_in)); SIREN kernels
U(+-sqrt(6/fan_in)); the first SIREN kernel (trunk layer 0 and sun_v_0)
U(+-1/fan_in).

`dtype` is the matmul operand type: inputs and weights are rounded to it and
the products are summed in float32 with a float32 bias, as the fused kernels
do. Parameters stay float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Sine(nn.Module):
    """SIREN activation sin(w0 * x)."""

    def __init__(self, w0: float = 1.0):
        super().__init__()
        self.w0 = w0

    def forward(self, x):
        return torch.sin(self.w0 * x)


def _init_linear(lin: nn.Linear, kind: str, generator: Optional[torch.Generator]):
    fan_in = lin.in_features
    bound = {
        "torch": 1.0 / math.sqrt(fan_in),
        "siren": math.sqrt(6.0 / fan_in),
        "siren_first": 1.0 / fan_in,
    }[kind]
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        # torch draws the bias bound from the layer fan_in in all cases
        b = 1.0 / math.sqrt(fan_in)
        lin.bias.uniform_(-b, b, generator=generator)


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """(x) -> [sin(2^k x), cos(2^k x)] per frequency k, no identity term
    (satnerf_tpu/models/nerf.py:95-109)."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)
    return enc.reshape(*x.shape[:-1], n_freqs * 2 * x.shape[-1])


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Linear with operands rounded to `dtype`, float32 sums and bias."""
    if dtype == torch.float32:
        return F.linear(x.float(), lin.weight, lin.bias)
    return F.linear(x.to(dtype).float(), lin.weight.to(dtype).float(), lin.bias)


class RadianceField(nn.Module):
    """Parameterized NeRF / Shadow-NeRF / Sat-NeRF field.

    forward(xyz, view_dir, sun_dir, t_embed) takes per-point inputs with any
    leading dims and returns rgb (...,3), sigma (...,) and, for the shadow
    variants, sun_v (...,1) and sky_rgb (...,3), plus beta (...,1) for
    sat-nerf — the same dict as the flax module.
    """

    def __init__(self, layers: int = 8, feat: int = 256, mapping: bool = True,
                 mapping_sizes: Sequence[int] = (10, 4),
                 skips: Sequence[int] = (4,), siren: bool = False,
                 use_view_dirs: bool = True, use_shadow: bool = False,
                 use_beta: bool = False, rgb_padding: float = 0.001,
                 t_dim: int = 4, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers, self.feat = layers, feat
        self.mapping, self.mapping_sizes = mapping, tuple(mapping_sizes)
        self.skips = tuple(skips)
        self.siren = siren
        self.use_view_dirs = use_view_dirs
        self.use_shadow, self.use_beta = use_shadow, use_beta
        self.rgb_padding = rgb_padding
        self.t_dim = t_dim
        self.dtype = dtype
        fh = feat // 2
        in_xyz = 3 * 2 * mapping_sizes[0] if mapping else 3
        in_dir = 3 * 2 * mapping_sizes[1] if mapping else 3

        def act(first=False):
            return Sine(30.0 if first else 1.0) if siren else nn.ReLU()

        kind = "siren" if siren else "torch"
        fc = []
        for i in range(layers):
            n_in = in_xyz if i == 0 else feat + (in_xyz if i in self.skips else 0)
            lin = nn.Linear(n_in, feat)
            _init_linear(lin, "siren_first" if (siren and i == 0) else kind,
                         generator)
            fc += [lin, act(first=(i == 0))]
        self.fc_net = nn.Sequential(*fc)

        self.sigma_from_xyz = nn.Sequential(nn.Linear(feat, 1), nn.Softplus())
        self.feats_from_xyz = nn.Linear(feat, feat)
        rgb_in = feat + (in_dir if use_view_dirs else 0)
        self.rgb_from_xyzdir = nn.Sequential(
            nn.Linear(rgb_in, fh), act(), nn.Linear(fh, 3), nn.Sigmoid())
        heads = [self.sigma_from_xyz[0], self.feats_from_xyz,
                 self.rgb_from_xyzdir[0], self.rgb_from_xyzdir[2]]
        for lin in heads:
            _init_linear(lin, "torch", generator)

        if use_shadow:
            # sun_v_0 has the siren_first init but sin(1 * x): the reference
            # uses Siren() with its default w0 = 1 there
            self.sun_v_net = nn.Sequential(
                nn.Linear(feat + 3, fh), Sine(1.0) if siren else nn.ReLU(),
                nn.Linear(fh, fh), act(), nn.Linear(fh, fh), act(),
                nn.Linear(fh, 1), nn.Sigmoid())
            _init_linear(self.sun_v_net[0], "siren_first" if siren else "torch",
                         generator)
            _init_linear(self.sun_v_net[2], kind, generator)
            _init_linear(self.sun_v_net[4], kind, generator)
            _init_linear(self.sun_v_net[6], "torch", generator)
            self.sky_color = nn.Sequential(
                nn.Linear(3, fh), nn.ReLU(), nn.Linear(fh, 3), nn.Sigmoid())
            _init_linear(self.sky_color[0], "torch", generator)
            _init_linear(self.sky_color[2], "torch", generator)
        if use_beta:
            self.beta_from_xyz = nn.Sequential(
                nn.Linear(feat + t_dim, fh), act(), nn.Linear(fh, 1),
                nn.Softplus())
            _init_linear(self.beta_from_xyz[0], "torch", generator)
            _init_linear(self.beta_from_xyz[2], "torch", generator)

    def _act(self, x, first=False):
        if self.siren:
            return torch.sin((30.0 if first else 1.0) * x)
        return torch.relu(x)

    def forward(self, xyz, view_dir=None, sun_dir=None, t_embed=None,
                sigma_only: bool = False, dtype: Optional[torch.dtype] = None):
        dt = self.dtype if dtype is None else dtype
        enc_xyz = (positional_encoding(xyz, self.mapping_sizes[0])
                   if self.mapping else xyz)

        h = enc_xyz
        for i in range(self.layers):
            if i in self.skips:
                h = torch.cat([enc_xyz, h], dim=-1)  # xyz first
            h = self._act(dense(self.fc_net[2 * i], h, dt), first=(i == 0))

        sigma = F.softplus(dense(self.sigma_from_xyz[0], h, dt))[..., 0]
        if sigma_only:
            return {"sigma": sigma}

        feats = dense(self.feats_from_xyz, h, dt)
        if self.use_view_dirs and view_dir is not None:
            enc_dir = (positional_encoding(view_dir, self.mapping_sizes[1])
                       if self.mapping else view_dir)
            rgb_in = torch.cat([feats, enc_dir], dim=-1)
        else:
            rgb_in = feats
        r = self._act(dense(self.rgb_from_xyzdir[0], rgb_in, dt))
        rgb = torch.sigmoid(dense(self.rgb_from_xyzdir[2], r, dt))
        rgb = rgb * (1 + 2 * self.rgb_padding) - self.rgb_padding
        out = {"rgb": rgb, "sigma": sigma}

        if self.use_shadow:
            sv = torch.cat([feats, sun_dir], dim=-1)
            sv = dense(self.sun_v_net[0], sv, dt)
            sv = torch.sin(sv) if self.siren else torch.relu(sv)
            for i in (2, 4):
                sv = self._act(dense(self.sun_v_net[i], sv, dt))
            out["sun_v"] = torch.sigmoid(dense(self.sun_v_net[6], sv, dt))
            sky = torch.relu(dense(self.sky_color[0], sun_dir, dt))  # sun_dir only
            out["sky_rgb"] = torch.sigmoid(dense(self.sky_color[2], sky, dt))

        if self.use_beta:
            b = torch.cat([feats, t_embed], dim=-1)
            b = self._act(dense(self.beta_from_xyz[0], b, dt))
            out["beta"] = F.softplus(dense(self.beta_from_xyz[2], b, dt))
        return out


class TransientEmbedding(nn.Embedding):
    """Per-image transient embedding, N(0, 1) init like torch's nn.Embedding
    (reference main.py:56-58: nn.Embedding(30, 4))."""

    def __init__(self, vocab: int = 30, dim: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__(vocab, dim)
        with torch.no_grad():
            self.weight.normal_(generator=generator)


def build_model(variant: str, fc_layers: int = 8, fc_units: int = 512,
                mapping_sizes: Sequence[int] = (10, 4), t_dim: int = 4,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None) -> RadianceField:
    """Variant factory with the defaults of satnerf_tpu.models.build_model:

      nerf     : positional mapping, ReLU, view dirs, no shadow/beta
      s-nerf   : no mapping, SIREN, no view dirs, shadow heads
      sat-nerf : no mapping, SIREN, no view dirs, shadow heads + beta head
    """
    common = dict(layers=fc_layers, feat=fc_units,
                  mapping_sizes=tuple(mapping_sizes), t_dim=t_dim, dtype=dtype,
                  generator=generator)
    if variant == "nerf":
        return RadianceField(mapping=True, siren=False, use_view_dirs=True,
                             use_shadow=False, use_beta=False, **common)
    if variant == "s-nerf":
        return RadianceField(mapping=False, siren=True, use_view_dirs=False,
                             use_shadow=True, use_beta=False, **common)
    if variant == "sat-nerf":
        return RadianceField(mapping=False, siren=True, use_view_dirs=False,
                             use_shadow=True, use_beta=True, **common)
    raise ValueError(f"model {variant!r} is not valid")
