"""Render-only NeRFSystem (counterpart of satnerf_tpu/train/system.py).

Holds the model configuration and renders whole images in chunks on one
device. Parameters live in an nn.ModuleDict keyed like the reference
Lightning module — nerf_coarse, [nerf_fine,] embedding_t — so its
state_dict() is the PL checkpoint payload (train/checkpoints.py).

The serving path is `_fused_product_render`: stratified depths, then
ops/fused_mlp.fused_render_rays, repacked in the reference-shaped results
dict with the per-ray products pre-integrated (weights == 1 over a
singleton sample axis), so satnerf_tpu/eval/images.py works unchanged.
On CUDA that is the siren_dense / heads_composite kernel chain; on the
CPU, its plain version. The nerf variant renders through the plain
render_rays on the CPU only.

Not carried over from the JAX system: the f16 eval-wire compression, the
threaded fetch pool and shard_map (one device here).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from satnerf_tpu.config import Config
from satnerf_tpu_torch.models.nerf import TransientEmbedding, build_model
from satnerf_tpu_torch.ops.fused_mlp import fused_render_rays
from satnerf_tpu_torch.render.render import RenderConfig, render_rays
from satnerf_tpu_torch.render.sampling import stratified_zvals


class NeRFSystem:
    def __init__(self, cfg: Config, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.use_ts = cfg.model == "sat-nerf"
        # "auto": bf16 matmul operands (f32 sums) on the card, f32 on the CPU
        use_bf16 = cfg.precision == "bfloat16" or (
            cfg.precision == "auto" and self.device.type == "cuda")
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.eval_render_cfg = RenderConfig(
            variant=cfg.model, n_samples=cfg.n_samples,
            n_importance=cfg.n_importance, perturb=0.0, solar_correction=False)

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> nn.ModuleDict:
        """Fresh parameters on the system's device, drawn from `generator`."""
        cfg = self.cfg

        def field():
            return build_model(cfg.model, cfg.fc_layers, cfg.fc_units,
                               t_dim=cfg.t_embbeding_tau,
                               dtype=self.compute_dtype, generator=generator)

        mods = {"nerf_coarse": field()}
        if cfg.n_importance > 0:
            mods["nerf_fine"] = field()
        if self.use_ts:
            mods["embedding_t"] = TransientEmbedding(
                cfg.t_embbeding_vocab, cfg.t_embbeding_tau, generator=generator)
        return nn.ModuleDict(mods).to(self.device).eval()

    # ----------------------------------------------------------------- render

    def _check_supported(self) -> None:
        if self.cfg.n_importance > 0:
            raise NotImplementedError(
                "n_importance > 0 (hierarchical serve) is not ported yet: "
                "ROADMAP queue 1, 'hierarchical serve'")
        if self.device.type == "cuda" and self.cfg.model == "nerf":
            raise NotImplementedError(
                "the nerf variant has no CUDA kernel yet: ROADMAP queue 2, K8 "
                "fused_nerf_render_rays")

    def _embed_ts(self, params, ts, n: int):
        """(n, tau) transient embedding for sat-nerf (index 0 when ts is
        None, as the JAX eval render pads it), else None."""
        if not self.use_ts:
            return None
        if ts is None:
            ts = torch.zeros(n, dtype=torch.long, device=self.device)
        return params["embedding_t"](ts.long())

    def render(self, params, rays, ts) -> dict:
        """Plain render_rays at eval settings (per-sample outputs)."""
        self._check_supported()
        return render_rays({"coarse": params["nerf_coarse"]}, rays,
                           self._embed_ts(params, ts, rays.shape[0]),
                           self.eval_render_cfg, dtype=self.compute_dtype)

    def _fused_product_render(self, params, rays, ts) -> dict:
        cfg, rcfg = self.cfg, self.eval_render_cfg
        self._check_supported()
        n = rays.shape[0]
        t_embed = self._embed_ts(params, ts, n)
        z_vals = stratified_zvals(None, rays[:, 6:7], rays[:, 7:8],
                                  rcfg.n_samples, rcfg.perturb, rcfg.use_disp)
        out = fused_render_rays(
            params["nerf_coarse"], rays[:, 0:3], rays[:, 3:6], rays[:, 8:11],
            t_embed, z_vals, layers=cfg.fc_layers, feat=cfg.fc_units, skip=4,
            use_beta=self.use_ts, tau=cfg.t_embbeding_tau,
            dtype=self.compute_dtype)
        res = {
            "rgb_coarse": out["rgb"],
            "depth_coarse": out["depth"],
            "opacity_coarse": out["opacity"],
            "weights_coarse": torch.ones((n, 1), dtype=torch.float32,
                                         device=rays.device),
            "sun_coarse": out["sun"][:, None, :],
            "albedo_coarse": out["albedo"][:, None, :],
            "sky_coarse": out["sky"][:, None, :],
        }
        if "beta" in out:
            res["beta_coarse"] = out["beta"][:, None, :]
        return res

    def render_chunk(self, params, rays, ts) -> dict:
        """Render one chunk of device tensors: rays (n, 11), ts (n,) or None."""
        if self.cfg.model == "nerf":
            return self.render(params, rays, ts)
        return self._fused_product_render(params, rays, ts)

    def render_image(self, params, rays: np.ndarray, ts) -> dict:
        """Render H*W rays in chunks of cfg.chunk and return numpy products
        (the reference's batched_inference, eval_satnerf.py:46-66)."""
        chunk = self.cfg.chunk
        outs = []
        with torch.inference_mode():
            for i in range(0, rays.shape[0], chunk):
                r = torch.from_numpy(np.ascontiguousarray(
                    rays[i:i + chunk], dtype=np.float32)).to(self.device)
                t = None
                if ts is not None:
                    t = torch.from_numpy(np.asarray(ts[i:i + chunk],
                                                    np.int64)).to(self.device)
                res = self.render_chunk(params, r, t)
                outs.append({k: v.float().cpu().numpy() for k, v in res.items()})
        return {k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}
