"""NeRFSystem: the model configuration, the render and the train step on one
device (counterpart of satnerf_tpu/train/system.py).

Parameters live in an nn.ModuleDict keyed like the reference Lightning
module — nerf_coarse, [nerf_fine,] embedding_t — so its state_dict() is the
PL checkpoint payload (train/checkpoints.py).

Serving is `_fused_product_render`: stratified depths, then
ops/fused_mlp.fused_render_rays, repacked in the reference-shaped results
dict with the per-ray products pre-integrated (weights == 1 over a
singleton sample axis), so eval/images.py reads it unchanged.

Training is `train_step`: draw a batch from the device-resident dataset,
`loss_and_grads` (stratified depths with jitter, optional sigma noise, the
beta warm-up gate, ops/fused_mlp.fused_train_loss_grads, the embedding
gradient by index_add_ over the batch's image ids), Adam, the learning rate
read from the schedule at the step counter before its increment.

On CUDA both paths are the hand-written kernel chains; on the CPU, their
plain versions. The nerf variant renders through the plain render_rays on
the CPU only and does not train yet.

Not carried over from the JAX system: the f16 eval-wire compression, the
threaded fetch pool, shard_map and the mesh (one device here).
"""

from __future__ import annotations

from typing import Optional

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.models.nerf import TransientEmbedding, build_model
from satnerf_tpu_torch.ops.fused_mlp import (fused_render_rays,
                                             fused_train_loss_grads)
from satnerf_tpu_torch.render.render import RenderConfig, render_rays
from satnerf_tpu_torch.render.sampling import stratified_zvals
from satnerf_tpu_torch.train.losses import BETA_MIN
from satnerf_tpu_torch.train.schedules import get_schedule


def steps_per_epoch(dataset_len: int, batch_size: int) -> int:
    """Reference epoch definition (train_utils.py:14-15)."""
    return max(1, dataset_len // batch_size)


@dataclass
class TrainState:
    params: nn.ModuleDict
    optimizer: torch.optim.Optimizer
    step: int = 0  # optimizer steps taken; 0-based index of the next one


class NeRFSystem:
    def __init__(self, cfg: Config, device=None, dataset_len: int = 0):
        """device None resolves to cfg.device (the card unless the
        configuration asks for the CPU). dataset_len is the number of
        training rays; it sets the steps per epoch."""
        self.cfg = cfg
        self.device = torch.device(
            device if device is not None else getattr(cfg, "device", "cuda"))
        self.use_ts = cfg.model == "sat-nerf"
        # epoch = one pass over the data at the effective batch
        self.spe = steps_per_epoch(dataset_len or cfg.batch_size,
                                   cfg.batch_size * cfg.grad_accum)
        num_epochs = max(cfg.max_train_steps // self.spe, 1)
        self.lr_schedule = get_schedule(cfg.lr_scheduler, cfg.lr, num_epochs,
                                        self.spe)
        # "auto": bf16 matmul operands (f32 sums) on the card, f32 on the CPU
        use_bf16 = cfg.precision == "bfloat16" or (
            cfg.precision == "auto" and self.device.type == "cuda")
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.eval_render_cfg = RenderConfig(
            variant=cfg.model, n_samples=cfg.n_samples,
            n_importance=cfg.n_importance, perturb=0.0, solar_correction=False)
        self.render_cfg = RenderConfig(
            variant=cfg.model, n_samples=cfg.n_samples,
            n_importance=cfg.n_importance, perturb=1.0,
            solar_correction=cfg.sc_lambda > 0)

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

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Fresh parameters with Adam as optax.adam sets it up (betas
        0.9 / 0.999, eps 1e-8 outside the root); the learning rate is set
        from the schedule by every train_step."""
        params = self.init_params(generator)
        optimizer = torch.optim.Adam(params.parameters(), lr=self.cfg.lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        return TrainState(params, optimizer, 0)

    # ----------------------------------------------------------------- render

    def _check_supported(self, train: bool = False) -> None:
        cfg = self.cfg
        if cfg.n_importance > 0:
            raise NotImplementedError(
                "n_importance > 0 (hierarchical serve and train) is not "
                "ported yet: ROADMAP queue 1, 'hierarchical serve'")
        if self.device.type == "cuda" and cfg.model == "nerf":
            raise NotImplementedError(
                "the nerf variant has no CUDA kernel yet: ROADMAP queue 2, K8 "
                "fused_nerf_render_rays")
        if not train:
            return
        waiting = [
            (cfg.model == "nerf", "training the nerf variant: ROADMAP queue "
             "2, K7 fused_nerf_train_loss_grads"),
            (cfg.sc_lambda > 0, "sc_lambda > 0 (the solar-correction pass): "
             "ROADMAP queue 2, K3 fused_sc_loss_grads"),
            (cfg.ds_lambda > 0, "ds_lambda > 0 (the depth-supervision pass): "
             "ROADMAP queue 2, K4 fused_train_render_rays"),
            (cfg.grad_accum != 1, "grad_accum > 1: ROADMAP queue 1, 'the "
             "train step's options'"),
            (cfg.sampling != "replacement", "--sampling shuffle: ROADMAP "
             "queue 1, 'the train step's options'"),
        ]
        for hit, what in waiting:
            if hit:
                raise NotImplementedError(f"{what} is not ported yet")

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

    # ------------------------------------------------------------------ train

    def _noise_std(self, step: int):
        if self.cfg.noise_std == 0.0:
            return None
        return self.cfg.noise_std * 0.9 ** step

    def beta_gate(self, step: int) -> float:
        """1.0 once the beta loss is on. The reference increments its step
        counter before the epoch check (main.py:120,128), so the switch comes
        one step earlier than a 0-based epoch would put it."""
        if not self.use_ts:
            return 0.0
        return float((step + 1) // self.spe >= self.cfg.first_beta_epoch)

    def loss_and_grads(self, params, rays, rgbs, ts, step: int,
                       generator: Optional[torch.Generator] = None,
                       z_vals=None, noise=None):
        """Loss, metrics and gradients of one batch (the n_importance == 0,
        no-SC, no-DS branch of the JAX _fused_loss_and_grads).

        rays (B, 11), rgbs (B, 3), ts (B,) image ids, on the system's
        device; step the 0-based global step. z_vals (B, S) and noise (B, S)
        replace the draws from `generator` when given. Returns
        (loss, metrics, grads) with grads keyed like
        params.named_parameters().
        """
        cfg, rcfg = self.cfg, self.render_cfg
        self._check_supported(train=True)
        if z_vals is None:
            z_vals = stratified_zvals(generator, rays[:, 6:7], rays[:, 7:8],
                                      rcfg.n_samples, rcfg.perturb,
                                      rcfg.use_disp)
        noise_std = self._noise_std(step)
        if noise_std is None:
            noise = None
        elif noise is None:
            noise = noise_std * torch.randn(
                z_vals.shape, generator=generator, dtype=torch.float32,
                device=z_vals.device)
        with torch.no_grad():
            t_embed = self._embed_ts(params, ts, rays.shape[0])
        wmix = self.beta_gate(step)
        parts, g_field, d_t = fused_train_loss_grads(
            params["nerf_coarse"], rays[:, 0:3], rays[:, 3:6], rays[:, 8:11],
            t_embed, z_vals, noise, rgbs, wmix, layers=cfg.fc_layers,
            feat=cfg.fc_units, skip=4, use_beta=self.use_ts,
            beta_min=BETA_MIN, tau=cfg.t_embbeding_tau,
            dtype=self.compute_dtype)
        if self.use_ts:
            loss = (wmix * (parts["color_sat"] + parts["logbeta"])
                    + (1.0 - wmix) * parts["mse"])
        else:
            loss = parts["mse"]
        grads = {f"nerf_coarse.{k}": v for k, v in g_field.items()}
        if self.use_ts:
            table = params["embedding_t"].weight
            grads["embedding_t.weight"] = torch.zeros_like(table).index_add_(
                0, ts.long(), d_t.to(table.dtype))
        metrics = {"loss": loss, "psnr": -10.0 * torch.log10(parts["mse"]),
                   "loss_total": loss}
        return loss, metrics, grads

    def train_step(self, state: TrainState, data: dict,
                   generator: Optional[torch.Generator] = None, idx=None,
                   z_vals=None, noise=None) -> dict:
        """One optimizer step on a batch drawn with replacement from the
        device-resident `data` = {"rays" (N, 11), "rgbs" (N, 3), "ts" (N,)}.
        `idx` (batch_size,), `z_vals` and `noise` replace the draws from
        `generator`. Updates `state` in place and returns the metrics
        (tensors on the device, plus the float "lr")."""
        cfg = self.cfg
        if idx is None:
            idx = torch.randint(0, data["rays"].shape[0], (cfg.batch_size,),
                                generator=generator, device=self.device)
        ts = data["ts"][idx] if self.use_ts else None
        _, metrics, grads = self.loss_and_grads(
            state.params, data["rays"][idx], data["rgbs"][idx], ts,
            state.step, generator, z_vals, noise)
        for name, p in state.params.named_parameters():
            p.grad = grads[name]
        lr = self.lr_schedule(state.step)  # read before the increment
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics["lr"] = lr
        return metrics
