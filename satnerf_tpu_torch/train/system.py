"""NeRFSystem: the model configuration, the render and the train step on one
device (counterpart of satnerf_tpu/train/system.py).

Parameters live in an nn.ModuleDict keyed like the reference Lightning
module — nerf_coarse, [nerf_fine,] embedding_t — so its state_dict() is the
PL checkpoint payload (train/checkpoints.py).

Serving is `_fused_product_render`: stratified depths, then
ops/fused_mlp.fused_render_rays, repacked in the reference-shaped results
dict with the per-ray products pre-integrated (weights == 1 over a
singleton sample axis), so eval/images.py reads it unchanged.

Training is `train_step`: draw a batch from the device-resident dataset
(with replacement, or along the epoch's permutation with `--sampling
shuffle`), `loss_and_grads`, Adam, the learning rate read from the schedule
at the step counter before its increment; with `grad_accum` N, N
micro-batches averaged into the one Adam step. `loss_and_grads` runs up to
three passes whose gradients add (counterpart of `_fused_loss_and_grads`,
satnerf_tpu/train/system.py:472-635):

  primary  stratified depths with jitter, optional sigma noise, the beta
           warm-up gate, ops/fused_mlp.fused_train_loss_grads, the embedding
           gradient by index_add_ over the batch's image ids
  SC       (sc_lambda > 0) fused_sc_loss_grads along the sun rays at the
           primary pass's depths with its own noise; adds to nerf_coarse.*
  DS       (ds_lambda > 0) a batch of key-point rays drawn from the depth
           set, rendered by fused_train_render_rays with its own depths and
           noise; the depth loss is differentiated by autograd through that
           function and adds to nerf_coarse.* and, at the depth batch's image
           ids, to embedding_t.weight; it stops contributing at
           ds_drop_step

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
                                             fused_sc_loss_grads,
                                             fused_train_loss_grads,
                                             fused_train_render_rays)
from satnerf_tpu_torch.render.render import RenderConfig, render_rays
from satnerf_tpu_torch.render.sampling import stratified_zvals
from satnerf_tpu_torch.train.losses import BETA_MIN, depth_loss
from satnerf_tpu_torch.train.schedules import get_schedule


def steps_per_epoch(dataset_len: int, batch_size: int) -> int:
    """Reference epoch definition (train_utils.py:14-15)."""
    return max(1, dataset_len // batch_size)


def epoch_draw_positions(step: int, spe: int, batch: int, n: int,
                         device=None) -> torch.Tensor:
    """Permutation slots for `--sampling shuffle`: step s of an epoch reads
    slots [s * batch, (s + 1) * batch) of the epoch's permutation, so the
    draws within an epoch are disjoint (spe * batch <= n by the epoch
    definition)."""
    pos = (step % spe) * batch + torch.arange(batch, device=device)
    return pos % n


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
        self.depth = cfg.ds_lambda > 0
        self.ds_drop_step = int(round(cfg.ds_drop * cfg.max_train_steps))
        if cfg.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")
        if cfg.grad_accum > 1 and cfg.sampling == "shuffle":
            raise ValueError(
                "grad_accum > 1 requires --sampling replacement: the "
                "epoch-permutation walk is defined per optimizer step, not "
                "per micro-batch")
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
        if train and cfg.model == "nerf":
            raise NotImplementedError(
                "training the nerf variant: ROADMAP queue 2, K7 "
                "fused_nerf_train_loss_grads is not ported yet")

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

    def epoch_perm(self, n: int, epoch: int) -> torch.Tensor:
        """The permutation of the n training rays that `--sampling shuffle`
        walks during `epoch`, on the system's device: torch.randperm from a
        generator seeded with cfg.seed + 2 folded with the epoch, so a
        resumed run walks the same permutation."""
        g = torch.Generator().manual_seed((self.cfg.seed + 2) * 1_000_003 + epoch)
        return torch.randperm(n, generator=g).to(self.device)

    def _draw_noise(self, noise, noise_std, shape, generator):
        """`noise` if injected, else noise_std * N(0, 1); None without noise."""
        if noise_std is None:
            return None
        if noise is not None:
            return noise
        return noise_std * torch.randn(shape, generator=generator,
                                       dtype=torch.float32, device=self.device)

    def loss_and_grads(self, params, rays, rgbs, ts, step: int,
                       generator: Optional[torch.Generator] = None,
                       z_vals=None, noise=None, *, sc_noise=None, depth=None,
                       d_z_vals=None, d_noise=None):
        """Loss, metrics and gradients of one batch (the n_importance == 0
        branch of the JAX _fused_loss_and_grads).

        rays (B, 11), rgbs (B, 3), ts (B,) image ids, on the system's
        device; step the 0-based global step; depth = (d_rays (B, 11),
        d_targets (B, 2) [depth, weight], d_ts (B,)), the depth batch, when
        ds_lambda > 0. z_vals (B, S), noise, sc_noise, d_z_vals, d_noise
        (B, S) replace the draws from `generator` when given; an uninjected
        call consumes the generator in that order, each noise only with
        noise_std > 0, sc_noise only with sc_lambda > 0 and the last two
        only with a depth batch. Returns (loss, metrics, grads) with grads
        keyed like params.named_parameters(); metrics["loss"] is the loss
        with the SC terms and before the depth term, as the JAX step logs it.
        """
        cfg, rcfg = self.cfg, self.render_cfg
        self._check_supported(train=True)
        field = params["nerf_coarse"]
        kw = dict(layers=cfg.fc_layers, feat=cfg.fc_units, skip=4,
                  use_beta=self.use_ts, tau=cfg.t_embbeding_tau,
                  dtype=self.compute_dtype)
        noise_std = self._noise_std(step)

        def zvals(r):
            return stratified_zvals(generator, r[:, 6:7], r[:, 7:8],
                                    rcfg.n_samples, rcfg.perturb, rcfg.use_disp)

        if z_vals is None:
            z_vals = zvals(rays)
        noise = self._draw_noise(noise, noise_std, z_vals.shape, generator)
        with torch.no_grad():
            t_embed = self._embed_ts(params, ts, rays.shape[0])
        wmix = self.beta_gate(step)
        parts, g_field, d_t = fused_train_loss_grads(
            field, rays[:, 0:3], rays[:, 3:6], rays[:, 8:11], t_embed, z_vals,
            noise, rgbs, wmix, beta_min=BETA_MIN, **kw)
        if self.use_ts:
            loss = (wmix * (parts["color_sat"] + parts["logbeta"])
                    + (1.0 - wmix) * parts["mse"])
        else:
            loss = parts["mse"]
        grads = {f"nerf_coarse.{k}": v for k, v in g_field.items()}
        table = params["embedding_t"].weight if self.use_ts else None
        if self.use_ts:
            grads["embedding_t.weight"] = torch.zeros_like(table).index_add_(
                0, ts.long(), d_t.to(table.dtype))

        if rcfg.solar_correction:
            # the sun-ray pass: the primary pass's depths, its own noise
            sc_noise = self._draw_noise(sc_noise, noise_std, z_vals.shape,
                                        generator)
            sc_parts, g_sc = fused_sc_loss_grads(
                field, rays[:, 0:3], rays[:, 8:11], t_embed, z_vals, sc_noise,
                cfg.sc_lambda, **kw)
            loss = loss + sc_parts["term2"] + sc_parts["term3"]
            for k, v in g_sc.items():
                grads[f"nerf_coarse.{k}"] += v
        metrics = {"loss": loss}  # with SC, before DS

        if self.depth and depth is not None:
            d_rays, d_targets, d_ts = depth
            if d_z_vals is None:
                d_z_vals = zvals(d_rays)
            d_noise = self._draw_noise(d_noise, noise_std, d_z_vals.shape,
                                       generator)
            # the reference compares its 1-based step counter (main.py:139)
            active = step + 1 < self.ds_drop_step
            t_leaf = None
            if self.use_ts:
                t_leaf = self._embed_ts(params, d_ts, d_rays.shape[0]).detach()
                t_leaf.requires_grad_(active)
            # once the term has dropped out only its value is logged: the
            # render runs without a graph and keeps no activations
            with torch.set_grad_enabled(active):
                out = fused_train_render_rays(
                    field, d_rays[:, 0:3], d_rays[:, 3:6], d_rays[:, 8:11],
                    t_leaf, d_z_vals, d_noise, **kw)
                kp_w = 1.0 if cfg.ds_noweights else d_targets[:, 1]
                ld, _ = depth_loss({"depth_coarse": out["depth"]},
                                   d_targets[:, 0], kp_w, cfg.ds_lambda)
            metrics["loss_depth"] = ld.detach()
            if active:
                names = [f"nerf_coarse.{n}" for n, _ in field.named_parameters()]
                leaves = list(field.parameters())
                if self.use_ts:
                    leaves.append(t_leaf)
                d_grads = torch.autograd.grad(ld, leaves, allow_unused=True)
                for name, g in zip(names, d_grads):
                    if g is not None:
                        grads[name] += g
                if self.use_ts and d_grads[-1] is not None:
                    grads["embedding_t.weight"].index_add_(
                        0, d_ts.long(), d_grads[-1].to(table.dtype))
                loss = loss + ld.detach()

        metrics["psnr"] = -10.0 * torch.log10(parts["mse"])
        metrics["loss_total"] = loss
        return loss, metrics, grads

    def train_step(self, state: TrainState, data: dict,
                   generator: Optional[torch.Generator] = None, idx=None,
                   z_vals=None, noise=None, *, sc_noise=None, d_idx=None,
                   d_z_vals=None, d_noise=None) -> dict:
        """One optimizer step on batches drawn from the device-resident
        `data` = {"rays" (N, 11), "rgbs" (N, 3), "ts" (N,)} plus, with
        ds_lambda > 0, {"d_rays" (M, 11), "d_depths" (M, 2), "d_ts" (M,)}
        and, with `--sampling shuffle`, {"perm" (N,)}, the epoch's
        permutation (epoch_perm), which the caller refreshes at every epoch
        boundary. The color batch is drawn with replacement, or read from
        the permutation at epoch_draw_positions; the depth batch always with
        replacement.

        `idx` and `d_idx` (batch_size,), `z_vals`, `noise`, `sc_noise`,
        `d_z_vals`, `d_noise` replace the draws from `generator`; with
        grad_accum N each is a sequence of N, one a micro-batch. An
        uninjected micro-batch consumes the generator in the order idx,
        d_idx, then loss_and_grads' order. With grad_accum N the losses,
        metrics and gradients of N micro-batches are averaged into one Adam
        step at one learning rate, and state.step grows by one. Updates
        `state` in place and returns the metrics (tensors on the device,
        plus the float "lr")."""
        cfg = self.cfg
        accum = cfg.grad_accum
        injected = dict(idx=idx, z_vals=z_vals, noise=noise, sc_noise=sc_noise,
                        d_idx=d_idx, d_z_vals=d_z_vals, d_noise=d_noise)
        if accum == 1:
            injected = {k: [v] for k, v in injected.items()}
        else:
            injected = {k: [None] * accum if v is None else list(v)
                        for k, v in injected.items()}
        n = data["rays"].shape[0]
        metrics = grads = None
        for m in range(accum):
            inj = {k: v[m] for k, v in injected.items()}
            idx = inj.pop("idx")
            if idx is None and cfg.sampling == "shuffle":
                idx = data["perm"][epoch_draw_positions(
                    state.step, self.spe, cfg.batch_size, n, self.device)]
            elif idx is None:
                idx = torch.randint(0, n, (cfg.batch_size,),
                                    generator=generator, device=self.device)
            depth, d_idx = None, inj.pop("d_idx")
            if self.depth:
                if d_idx is None:
                    d_idx = torch.randint(
                        0, data["d_rays"].shape[0], (cfg.batch_size,),
                        generator=generator, device=self.device)
                depth = (data["d_rays"][d_idx], data["d_depths"][d_idx],
                         data["d_ts"][d_idx])
            ts = data["ts"][idx] if self.use_ts else None
            _, m_i, g_i = self.loss_and_grads(
                state.params, data["rays"][idx], data["rgbs"][idx], ts,
                state.step, generator, depth=depth, **inj)
            if grads is None:
                metrics, grads = m_i, g_i
            else:
                for k in metrics:
                    metrics[k] = metrics[k] + m_i[k]
                for k in grads:
                    grads[k] += g_i[k]
        if accum > 1:
            metrics = {k: v / accum for k, v in metrics.items()}
            for g in grads.values():
                g /= accum
        for name, p in state.params.named_parameters():
            p.grad = grads[name]
        lr = self.lr_schedule(state.step)  # read before the increment
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics["lr"] = lr
        return metrics
