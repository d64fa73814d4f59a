"""NeRFSystem: the model configuration, the render and the train step on one
device (counterpart of satnerf_tpu/train/system.py).

Parameters live in an nn.ModuleDict keyed like the reference Lightning
module — nerf_coarse, [nerf_fine,] embedding_t — so its state_dict() is the
PL checkpoint payload (train/checkpoints.py).

`fused_mode` picks the path, resolved from `--fused` as the JAX system
resolves it (`resolve_fused_mode`, which also sends `auto` to "off" where
the kernels cannot hold the width or the samples a ray, and refuses an
explicit mode there): "rays" (`--fused rays`, and `auto` on the card) runs the
per-ray kernels below; "points" (`--fused on`) and "off" (`--fused off`, and
`auto` on the CPU) run the plain renderer (render/render.py) under autograd,
over the point-mode field kernel K6 or over the field modules. The nerf
variant has no rays mode: `--fused rays` and `auto` on the card resolve to
"points", where it serves through fused_nerf_render_rays (K8), takes its
plain step through fused_nerf_train_loss_grads (K7) and, with n_importance
> 0 or depth supervision, trains through the plain renderer over
fused_nerf_apply (K9).

Serving in rays mode is `_fused_product_render`: stratified depths, then
ops/fused_mlp.fused_render_rays, repacked in the reference-shaped results
dict with the per-ray products pre-integrated (weights == 1 over a
singleton sample axis), so eval/images.py reads it unchanged. With
n_importance > 0 it is a two-launch dispatch: the coarse render with its
weights, `sample_pdf` over them, the sorted union of depths, the fine render.

Training is `train_step`: draw a batch from the device-resident dataset
(with replacement, or along the epoch's permutation with `--sampling
shuffle`), `loss_and_grads`, Adam, the learning rate read from the schedule
at the step counter before its increment; with `grad_accum` N, N
micro-batches averaged into the one Adam step.

Every random number of a step is the JAX package's, bit for bit: the step
takes the run's key (PRNGKey(seed + 1), a raw uint32[2] of
utils/jax_prng.py) and derives its keys as the JAX step does
(jax_prng.step_keys: fold_in the rank, then the step, then split),
and the draws are jax.random's bits, uniform, randint and normal, made by
ops/jax_draws.py (csrc/jax_draws.cu on the card). So a run of the port sees
the rays, depths and noise a run of the JAX package sees at every step, on
every rank, and a resumed run draws what an uninterrupted one does.

In rays mode `loss_and_grads` runs up to three passes whose gradients add
(counterpart of `_fused_loss_and_grads`,
satnerf_tpu/train/system.py:472-635):

  primary  stratified depths with jitter, optional sigma noise, the beta
           warm-up gate, ops/fused_mlp.fused_train_loss_grads, the embedding
           gradient by index_add_ over the batch's image ids; with
           n_importance > 0 the coarse launch also returns its weights, and
           a second launch runs the fine model over the resampled depths
  SC       (sc_lambda > 0) fused_sc_loss_grads along the sun rays, once a
           model, at that model's depths with its own noise
  DS       (ds_lambda > 0) a batch of key-point rays drawn from the depth
           set. Coarse only: rendered by fused_train_render_rays (K4).
           Hierarchical: the plain renderer over the ray-mode field kernel
           fused_field_apply_rays (K5) for both models. The depth loss is
           differentiated by autograd through those functions; it stops
           contributing at ds_drop_step

In points and off mode `loss_and_grads` is the JAX `_loss_and_metrics` under
autograd: one `render_rays` of the batch (with the sun-ray passes when
sc_lambda > 0), the variant's loss, the depth pass, one backward.

On CUDA the kernels are the hand-written chains; on the CPU, their plain
versions.

Across devices (parallel/): one process a device, each rank drawing its
batch_size / world rays from its shard of the data, the gradients and
metrics averaged by all-reduce before Adam, where the JAX system runs one
shard_map over a mesh; `render_image` splits each chunk's rows over the
ranks on rank 0's host and gathers the products, where the JAX system's
shard_map runs over its eval mesh. Not carried over from the JAX system: the f16
eval-wire compression and the threaded fetch pool.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.models.nerf import (TransientEmbedding, build_model,
                                          init_bound)
from satnerf_tpu_torch.ops import fused_mlp as FM
from satnerf_tpu_torch.ops import fused_nerf as FN
from satnerf_tpu_torch.ops import jax_draws as JD
from satnerf_tpu_torch.ops.fused_nerf import (fused_nerf_apply,
                                              fused_nerf_render_rays,
                                              fused_nerf_train_loss_grads)
from satnerf_tpu_torch.ops.fused_mlp import (fused_field_apply,
                                             fused_field_apply_rays,
                                             fused_render_rays,
                                             fused_sc_loss_grads,
                                             fused_train_loss_grads,
                                             fused_train_render_rays)
from satnerf_tpu_torch.parallel import distributed as D
from satnerf_tpu_torch.parallel.mesh import shard_rows
from satnerf_tpu_torch.render.render import (RenderConfig, render_rays,
                                             resample_zvals)
from satnerf_tpu_torch.render.sampling import stratified_zvals
from satnerf_tpu_torch.train.checkpoints import (jax_dense_names,
                                                 params_from_jax)
from satnerf_tpu_torch.train.losses import (BETA_MIN, depth_loss, nerf_loss,
                                            satnerf_loss, snerf_loss)
from satnerf_tpu_torch.train.schedules import get_schedule
from satnerf_tpu_torch.utils import jax_prng

# The most points one serving pass is given: a chunk of 65,536 rays x 64
# samples. A pass of more samples a ray (the fine pass) is split along the
# rays, so its activations (about 4 KB a point in bf16, 8 KB in fp32) stay
# what a coarse chunk holds and no element offset passes 2^32.
MAX_RENDER_POINTS = 1 << 22


def _in_pieces(fn, n: int, step: int) -> dict:
    """fn(i, j) -> dict of tensors over rows [i, j), for pieces of `step`
    rows of n; the pieces concatenated."""
    outs = [fn(i, min(n, i + step)) for i in range(0, n, step)]
    if len(outs) == 1:
        return outs[0]
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


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


def resolve_compute_dtype(cfg: Config, device) -> torch.dtype:
    """The matmul operands' dtype: `--precision`, where "auto" is bf16 (fp32
    sums) on the card and fp32 on the CPU."""
    use_bf16 = cfg.precision == "bfloat16" or (
        cfg.precision == "auto" and torch.device(device).type == "cuda")
    return torch.bfloat16 if use_bf16 else torch.float32


def _kernel_limit(cfg: Config, mode: str, dtype: torch.dtype) -> Optional[str]:
    """Why the kernels of `mode` cannot run `cfg` on the card, or None: the
    width limits of the heads' kernels, then the samples a ray the per-ray
    kernels' shared memory holds at the longest ray they are given (the
    coarse samples plus n_importance in the fine pass)."""
    feat, fh = cfg.fc_units, cfg.fc_units // 2
    if cfg.model == "nerf":
        if (feat > FN.NERF_HEADS_MAX_FEATURES
                or fh > FN.NERF_HEADS_MAX_HIDDEN):
            return (f"fc_units {feat} is wider than the "
                    f"{FN.NERF_HEADS_MAX_FEATURES} features the nerf heads' "
                    f"kernels hold (ops/fused_nerf.py NERF_HEADS_MAX_FEATURES)")
        if cfg.n_importance == 0 and cfg.ds_lambda == 0:  # the K7 step
            limit = FN.nerf_composite_max_samples(feat, fh, dtype)
            if cfg.n_samples > limit:
                return (f"n_samples {cfg.n_samples} is more than the {limit} "
                        f"samples a ray nerf_composite_loss_bwd holds at "
                        f"fc_units {feat} in {dtype} "
                        f"(nerf_composite_max_samples)")
        return None
    widest = min(FM.HEADS_MAX_FEATURES, FM.NARROW_MAX_N)
    if feat > widest:
        return (f"fc_units {feat} is wider than the {widest} features the "
                f"heads' kernels hold (ops/fused_mlp.py HEADS_MAX_FEATURES)")
    if mode != "rays":
        return None
    n_s = cfg.n_samples + cfg.n_importance
    limits = [("composite_loss_bwd", FM.composite_max_samples(feat, fh),
               "composite_max_samples")]
    if cfg.sc_lambda > 0:
        limits.append(("sc_loss_bwd", FM.sc_max_samples(feat, fh),
                       "sc_max_samples"))
    for kernel, limit, fn in limits:
        if n_s > limit:
            return (f"{n_s} samples a ray (n_samples {cfg.n_samples} + "
                    f"n_importance {cfg.n_importance}) are more than the "
                    f"{limit} {kernel} holds at fc_units {feat} ({fn})")
    return None


def resolve_fused_mode(cfg: Config, device) -> tuple:
    """(fused_mode, reason) for `--fused` on `device`, as the JAX system
    resolves it, and within what the kernels hold. "rays": the per-ray
    kernels; "points": the plain renderer over the point-mode field kernel;
    "off": the plain renderer over the field modules, on whatever device was
    asked for. The nerf variant's kernels all run in "points" mode; "auto" is
    a fused mode on the card and "off" on the CPU.

    On the card a configuration the kernels cannot hold (_kernel_limit) is
    decided here, before anything is launched: "auto" resolves to "off" and
    `reason` says which width or sample count and which limit ruled the
    kernels out (None otherwise); an explicit "rays" or "on" raises
    ValueError. Constructs nothing on the device."""
    device = torch.device(device)
    if cfg.fused == "off":
        return "off", None
    if cfg.fused == "on":
        mode = "points"
    elif cfg.fused == "rays" or device.type == "cuda":
        mode = "points" if cfg.model == "nerf" else "rays"
    else:
        return "off", None
    if device.type != "cuda":  # the kernels' plain versions hold any size
        return mode, None
    reason = _kernel_limit(cfg, mode, resolve_compute_dtype(cfg, device))
    if reason is None:
        return mode, None
    if cfg.fused == "auto":
        return "off", reason
    raise ValueError(f"--fused {cfg.fused}: {reason}; use --fused off (the "
                     f"plain renderer over the field modules) or auto")


@dataclass
class TrainState:
    params: nn.ModuleDict
    optimizer: torch.optim.Optimizer
    step: int = 0  # optimizer steps taken; 0-based index of the next one


def jax_init_params(cfg: Config, params: nn.ModuleDict, seed: int) -> dict:
    """The JAX package's initial parameter pytree {coarse[, fine][, t]} as
    numpy arrays, `NeRFSystem(cfg).init_params(PRNGKey(seed))` to the bit
    (satnerf_tpu/train/system.py:216-232), drawn by utils/jax_prng.py. The
    shapes are read from `params`, the port's modules of that
    configuration, with each layer's init kind (models/nerf.py): coarse
    from key 0 of split(PRNGKey(seed), 4), fine from key 1, the transient
    embedding from key 2, each Dense kernel and bias from flax's key of its
    module path."""
    keys = jax_prng.split(jax_prng.prng_key(seed), 4)

    def field(module, key):
        tree = {}
        for name, torch_name in jax_dense_names(cfg.model, cfg.fc_layers):
            lin = module.get_submodule(torch_name)
            fan_in, fan_out = lin.in_features, lin.out_features
            bound = init_bound(lin.init_kind, fan_in)
            b_bound = init_bound("torch", fan_in)
            tree[name] = {"Dense_0": {
                "kernel": jax_prng.uniform(
                    jax_prng.flax_param_key(key, (name, "Dense_0"), 1),
                    (fan_in, fan_out), -bound, bound),
                "bias": jax_prng.uniform(
                    jax_prng.flax_param_key(key, (name, "Dense_0"), 2),
                    (fan_out,), -b_bound, b_bound)}}
        return tree

    tree = {"coarse": field(params["nerf_coarse"], keys[0])}
    if "nerf_fine" in params:
        tree["fine"] = field(params["nerf_fine"], keys[1])
    if "embedding_t" in params:
        emb = params["embedding_t"]
        tree["t"] = {"embedding": jax_prng.normal(
            jax_prng.flax_param_key(keys[2], (), 1),
            (emb.num_embeddings, emb.embedding_dim))}
    return tree


class NeRFSystem:
    def __init__(self, cfg: Config, device=None, dataset_len: int = 0):
        """device None resolves to cfg.device (the card unless the
        configuration asks for the CPU). dataset_len is the number of
        training rays (all ranks'); it sets the steps per epoch.

        In a process group (parallel/distributed.py) the system is rank
        `rank` of `world`: a step draws batch_size / world rays from the
        rank's shard of the data, and the gradients and metrics are averaged
        across the ranks before Adam."""
        self.cfg = cfg
        self.device = torch.device(
            device if device is not None else getattr(cfg, "device", "cuda"))
        self.rank, self.world = D.rank(), D.world()
        if cfg.batch_size % self.world:
            raise ValueError(f"batch_size {cfg.batch_size} must divide across "
                             f"{self.world} devices")
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
        self.compute_dtype = resolve_compute_dtype(cfg, self.device)
        self.is_nerf = cfg.model == "nerf"
        # decided here, before anything is launched: a configuration the
        # kernels cannot hold runs "off" under auto (said on one line) and
        # raises under an explicit --fused rays / on
        self.fused_mode, self.fused_reason = resolve_fused_mode(cfg,
                                                                self.device)
        if self.fused_reason is not None:
            print(f"--fused auto resolves to off: {self.fused_reason}")
        self.eval_render_cfg = RenderConfig(
            variant=cfg.model, n_samples=cfg.n_samples,
            n_importance=cfg.n_importance, perturb=0.0, solar_correction=False)
        self.render_cfg = RenderConfig(
            variant=cfg.model, n_samples=cfg.n_samples,
            n_importance=cfg.n_importance, perturb=1.0,
            solar_correction=cfg.sc_lambda > 0)
        # the depth pass renders the key-point rays for their depths only
        self.ds_render_cfg = dataclasses.replace(self.render_cfg,
                                                 solar_correction=False)

    def init_params(self, seed: int = 0) -> nn.ModuleDict:
        """Fresh parameters on the system's device: the JAX package's
        `init_params(PRNGKey(seed))` to the bit (`jax_init_params`)."""
        cfg = self.cfg

        # built on the CPU from a generator of their own (the global one
        # draws nothing), overwritten by the JAX draw, then moved to the
        # device. The meta device would spare those draws (tens of ms) but
        # costs seconds of torch's lazy imports at a process's first call.
        gen = torch.Generator().manual_seed(seed)

        def field():
            return build_model(cfg.model, cfg.fc_layers, cfg.fc_units,
                               t_dim=cfg.t_embbeding_tau,
                               dtype=self.compute_dtype, generator=gen)

        mods = {"nerf_coarse": field()}
        if cfg.n_importance > 0:
            mods["nerf_fine"] = field()
        if self.use_ts:
            mods["embedding_t"] = TransientEmbedding(
                cfg.t_embbeding_vocab, cfg.t_embbeding_tau, generator=gen)
        params = nn.ModuleDict(mods)
        params.load_state_dict(params_from_jax(
            jax_init_params(cfg, params, seed), cfg.model, cfg.fc_layers))
        return params.to(self.device).eval()

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters (`init_params(seed)`) with Adam as optax.adam
        sets it up (betas 0.9 / 0.999, eps 1e-8 outside the root); the
        learning rate is set from the schedule by every train_step."""
        params = self.init_params(seed)
        optimizer = torch.optim.Adam(params.parameters(), lr=self.cfg.lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        return TrainState(params, optimizer, 0)

    # ----------------------------------------------------------------- render

    def _embed_ts(self, params, ts, n: int):
        """(n, tau) transient embedding for sat-nerf (index 0 when ts is
        None, as the JAX eval render pads it), else None."""
        if not self.use_ts:
            return None
        if ts is None:
            ts = torch.zeros(n, dtype=torch.long, device=self.device)
        return params["embedding_t"](ts.long())

    def _field_kw(self) -> dict:
        cfg = self.cfg
        kw = dict(layers=cfg.fc_layers, feat=cfg.fc_units, skip=4,
                  dtype=self.compute_dtype)
        if not self.is_nerf:
            kw.update(use_beta=self.use_ts, tau=cfg.t_embbeding_tau)
        return kw

    @staticmethod
    def _sun_dir(rays):
        """The sun direction columns, where the rays have them (blender rays
        are (N, 8): origin, direction, near, far)."""
        return rays[:, 8:11] if rays.shape[1] >= 11 else None

    def field_fns(self, params) -> dict:
        """{"coarse"[, "fine"]: model} as render_rays takes them, for the
        system's fused_mode: the ray-mode field kernel, the point-mode field
        kernel, or the field modules."""
        mode = self.fused_mode
        kw = self._field_kw()

        def fn(field):
            if mode == "rays":
                def apply_rays(rays_o, march_d, sun_d, t_embed, z_vals):
                    return fused_field_apply_rays(field, rays_o, march_d,
                                                  sun_d, t_embed, z_vals, **kw)

                apply_rays.ray_mode = True
                return apply_rays
            if mode == "points" and self.is_nerf:
                return lambda xyz, view_dir, sun_dir, t_embed: \
                    fused_nerf_apply(field, xyz, view_dir, **kw)
            if mode == "points":
                return lambda xyz, view_dir, sun_dir, t_embed: \
                    fused_field_apply(field, xyz, sun_dir, t_embed, **kw)
            return field

        models = {"coarse": fn(params["nerf_coarse"])}
        if self.cfg.n_importance > 0:
            models["fine"] = fn(params["nerf_fine"])
        return models

    def render(self, params, rays, ts) -> dict:
        """Plain render_rays at eval settings (per-sample outputs)."""
        return render_rays(self.field_fns(params), rays,
                           self._embed_ts(params, ts, rays.shape[0]),
                           self.eval_render_cfg, dtype=self.compute_dtype)

    def _fused_product_render(self, params, rays, ts) -> dict:
        rcfg = self.eval_render_cfg
        n = rays.shape[0]
        t_embed = self._embed_ts(params, ts, n)
        z_vals = stratified_zvals(None, rays[:, 6:7], rays[:, 7:8],
                                  rcfg.n_samples, rcfg.perturb, rcfg.use_disp)
        kw = self._field_kw()
        sun_d = self._sun_dir(rays)

        def piece(field, z, want_weights, i, j):
            if self.is_nerf:
                return fused_nerf_render_rays(
                    field, rays[i:j, 0:3], rays[i:j, 3:6], z[i:j],
                    return_weights=want_weights, **kw)
            return fused_render_rays(
                field, rays[i:j, 0:3], rays[i:j, 3:6], sun_d[i:j],
                None if t_embed is None else t_embed[i:j], z[i:j],
                return_weights=want_weights, **kw)

        def run(field, z, want_weights):
            return _in_pieces(
                lambda i, j: piece(field, z, want_weights, i, j),
                n, max(1, MAX_RENDER_POINTS // z.shape[1]))

        def pack(out, suffix):
            res = {
                f"rgb_{suffix}": out["rgb"],
                f"depth_{suffix}": out["depth"],
                f"opacity_{suffix}": out["opacity"],
                f"weights_{suffix}": torch.ones((n, 1), dtype=torch.float32,
                                                device=rays.device),
            }
            if not self.is_nerf:
                res.update({
                    f"sun_{suffix}": out["sun"][:, None, :],
                    f"albedo_{suffix}": out["albedo"][:, None, :],
                    f"sky_{suffix}": out["sky"][:, None, :],
                })
            if "beta" in out:
                res[f"beta_{suffix}"] = out["beta"][:, None, :]
            return res

        n_imp = rcfg.n_importance
        coarse = run(params["nerf_coarse"], z_vals, n_imp > 0)
        res = pack(coarse, "coarse")
        if n_imp > 0:
            # the resampling over the coarse weights, then one more render
            # with the fine model (rendering.py:118-156)
            z_all = resample_zvals(None, z_vals, coarse["weights"], n_imp,
                                   det=(rcfg.perturb == 0))
            res.update(pack(run(params["nerf_fine"], z_all, False), "fine"))
        return res

    def render_chunk(self, params, rays, ts) -> dict:
        """Render one chunk of device tensors: rays (n, 11), or (n, 8)
        without the sun direction (blender), ts (n,) or None. The per-ray
        kernels serve whenever a fused mode is on for the nerf variant, and in
        rays mode for the others."""
        if self.fused_mode == "rays" or (self.is_nerf
                                         and self.fused_mode != "off"):
            return self._fused_product_render(params, rays, ts)
        rcfg = self.eval_render_cfg
        return _in_pieces(
            lambda i, j: self.render(params, rays[i:j],
                                     None if ts is None else ts[i:j]),
            rays.shape[0],
            max(1, MAX_RENDER_POINTS // (rcfg.n_samples + rcfg.n_importance)))

    def render_image(self, params, rays: np.ndarray, ts) -> dict:
        """Render H*W rays in chunks of cfg.chunk and return numpy products
        (the reference's batched_inference, eval_satnerf.py:46-66).

        Across the w ranks of the render group (parallel/distributed.py:
        the ranks on rank 0's host) it is collective, as the JAX system's
        shard_map over its eval mesh: every rank of the group calls it with
        the same rays and ts in the same order. A chunk is cfg.chunk rounded
        up to a multiple of w, the last one padded with zero rays (ts 0),
        rank r renders its block of each chunk's rows (parallel/mesh.py
        `shard_rows`), the blocks are gathered and the padding dropped, and
        every rank returns the whole products. With w = 1 each chunk is
        rendered whole on this device."""
        w = D.render_world()
        chunk = -(-self.cfg.chunk // w) * w
        outs = []
        with torch.inference_mode():
            for i in range(0, rays.shape[0], chunk):
                r = np.asarray(rays[i:i + chunk], dtype=np.float32)
                t = None if ts is None else np.asarray(ts[i:i + chunk],
                                                       np.int64)
                n = r.shape[0]
                if w > 1:
                    lo, hi, _ = shard_rows(chunk, w, D.render_rank())
                    r = np.pad(r, ((0, chunk - n), (0, 0)))[lo:hi]
                    if t is not None:
                        t = np.pad(t, (0, chunk - n))[lo:hi]
                r = torch.from_numpy(np.ascontiguousarray(r)).to(self.device)
                if t is not None:
                    t = torch.from_numpy(np.ascontiguousarray(t)).to(
                        self.device)
                res = self.render_chunk(params, r, t)
                if w > 1:
                    res = {k: v[:n] for k, v in D.all_gather_rows(res).items()}
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
        """The permutation of the rank's n training rays that `--sampling
        shuffle` walks during `epoch`, on the system's device: the JAX
        package's, jax.random.permutation(fold_in(fold_in(PRNGKey(seed + 2),
        epoch), rank), n) (satnerf_tpu/train/loop.py:202-204,
        system.py:794-795), so a resumed run walks the same permutation."""
        key = jax_prng.fold_in(jax_prng.fold_in(
            jax_prng.prng_key(self.cfg.seed + 2), epoch), self.rank)
        return JD.permutation(key, n, self.device)

    @staticmethod
    def _key(key, what: str):
        if key is None:
            raise ValueError(f"{what} is neither injected nor drawn: pass a "
                             f"key (a raw uint32[2], utils/jax_prng.py)")
        return key

    def _draw_noise(self, noise, noise_std, shape, sub, i: int, what: str):
        """`noise` if injected, else noise_std * jax.random.normal(sub(i),
        shape); None without noise."""
        if noise_std is None:
            return None
        if noise is not None:
            return noise
        return noise_std * JD.normal(self._key(sub(i), what), shape,
                                     self.device)

    def _draws(self, rays, key, noise_std, sc: bool, z_vals=None,
               noise=None, u=None, fine_noise=None, sc_noise=None,
               sc_noise_fine=None) -> dict:
        """The random numbers of one training render of `rays`, each as
        injected or else drawn from `key` as the JAX render draws them
        (satnerf_tpu/render/render.py:99, system.py:486-490): key split six
        ways, (k_z, k_noise, k_pdf, k_fine_noise, k_sc1, k_sc2), and z_vals
        (B, S) jittered by uniform(k_z); noise (B, S) normal(k_noise); with
        n_importance > 0, u (B, n_importance) uniform(k_pdf) and fine_noise
        (B, S + n_importance) normal(k_fine_noise); with `sc`, sc_noise
        (B, S) normal(k_sc1) and, with n_importance > 0, sc_noise_fine
        (B, S + n_importance) normal(k_sc2). A noise is drawn only with
        noise_std > 0 and is None otherwise."""
        rcfg, n_imp = self.render_cfg, self.cfg.n_importance

        def sub(i):  # split(key, 6)[i], made only for a draw that needs it
            return None if key is None else jax_prng.split_at(key, i)

        if z_vals is None:
            z_vals = stratified_zvals(self._key(sub(0), "z_vals"),
                                      rays[:, 6:7], rays[:, 7:8],
                                      rcfg.n_samples, rcfg.perturb,
                                      rcfg.use_disp)
        n, n_s = z_vals.shape
        d = dict(z_vals=z_vals, u=None, fine_noise=None, sc_noise=None,
                 sc_noise_fine=None)
        d["noise"] = self._draw_noise(noise, noise_std, (n, n_s), sub, 1,
                                      "noise")
        if n_imp > 0:
            d["u"] = u if u is not None else JD.uniform(
                self._key(sub(2), "u"), (n, n_imp), self.device)
            d["fine_noise"] = self._draw_noise(
                fine_noise, noise_std, (n, n_s + n_imp), sub, 3, "fine_noise")
        if sc:
            d["sc_noise"] = self._draw_noise(sc_noise, noise_std, (n, n_s),
                                             sub, 4, "sc_noise")
            if n_imp > 0:
                d["sc_noise_fine"] = self._draw_noise(
                    sc_noise_fine, noise_std, (n, n_s + n_imp), sub, 5,
                    "sc_noise_fine")
        return d

    def loss_and_grads(self, params, rays, rgbs, ts, step: int, key=None,
                       z_vals=None, noise=None, *, sc_noise=None, depth=None,
                       d_z_vals=None, d_noise=None, u=None, fine_noise=None,
                       sc_noise_fine=None, d_u=None, d_fine_noise=None):
        """Loss, metrics and gradients of one batch: the JAX
        _fused_loss_and_grads in rays mode, value_and_grad of its
        _loss_and_metrics in points and off mode.

        rays (B, 11), rgbs (B, 3), ts (B,) image ids, on the system's
        device; step the 0-based global step; depth = (d_rays (B, 11),
        d_targets (B, 2) [depth, weight], d_ts (B,)), the depth batch, when
        ds_lambda > 0. The keyword tensors replace the draws from `key`
        (the micro-batch's k_loss, a raw uint32[2]), which is split as the
        JAX loss splits it (satnerf_tpu/train/system.py:380, :486-490):
        k_render, k_depth = split(key), the color batch's z_vals (B, S),
        noise (B, S), u (B, n_importance), fine_noise (B, S + n_importance),
        sc_noise (B, S) and sc_noise_fine (B, S + n_importance) from
        k_render (`_draws`), the depth batch's d_z_vals, d_noise, d_u and
        d_fine_noise from k_depth, whatever the mode. Each noise is drawn
        only with noise_std > 0, u and the fine noises only with
        n_importance > 0, the two sc noises only with sc_lambda > 0 and the
        last four only with a depth batch; a draw that is needed, not
        injected and has no key raises ValueError. Returns (loss, metrics,
        grads) with grads keyed like params.named_parameters();
        metrics["loss"] is the loss with the SC
        terms and before the depth term, as the JAX step logs it, and
        metrics["psnr"] is of the fine model's MSE when there is one.
        """
        noise_std = self._noise_std(step)
        # k_render, k_depth = split(key)
        k_render = None if key is None else jax_prng.split_at(key, 0)
        # the sun-ray pass of the shadow variants (none for nerf)
        sc = self.render_cfg.solar_correction and self.render_cfg.shadow
        draws = self._draws(rays, k_render, noise_std, sc, z_vals, noise, u,
                            fine_noise, sc_noise, sc_noise_fine)
        d_draws = None
        if self.depth and depth is not None:
            k_depth = None if key is None else jax_prng.split_at(key, 1)
            d_draws = self._draws(depth[0], k_depth, noise_std, False,
                                  d_z_vals, d_noise, d_u, d_fine_noise)
        else:
            depth = None
        if self.fused_mode == "rays":
            return self._rays_loss_and_grads(params, rays, rgbs, ts, step,
                                             draws, depth, d_draws)
        if (self.is_nerf and self.fused_mode == "points"
                and self.cfg.n_importance == 0 and not self.depth):
            return self._nerf_loss_and_grads(params, rays, rgbs, draws)
        return self._autograd_loss_and_grads(params, rays, rgbs, ts, step,
                                             draws, depth, d_draws)

    def _depth_render_loss(self, params, depth, d_draws):
        """The depth loss of the key-point batch through the plain renderer
        over the system's field functions, coarse and fine. It marches no
        sun rays: the depth loss reads the depths only."""
        d_rays, d_targets, d_ts = depth
        res = render_rays(
            self.field_fns(params), d_rays,
            self._embed_ts(params, d_ts, d_rays.shape[0]), self.ds_render_cfg,
            dtype=self.compute_dtype, noise=d_draws["noise"],
            z_vals=d_draws["z_vals"], u=d_draws["u"],
            fine_noise=d_draws["fine_noise"])
        kp_w = 1.0 if self.cfg.ds_noweights else d_targets[:, 1]
        return depth_loss(res, d_targets[:, 0], kp_w, self.cfg.ds_lambda)[0]

    def _rays_loss_and_grads(self, params, rays, rgbs, ts, step, draws, depth,
                             d_draws):
        cfg, n_imp = self.cfg, self.cfg.n_importance
        kw = self._field_kw()
        with torch.no_grad():
            t_embed = self._embed_ts(params, ts, rays.shape[0])
        wmix = self.beta_gate(step)
        rays_o, rays_d, sun_d = rays[:, 0:3], rays[:, 3:6], self._sun_dir(rays)

        def mix(parts):
            if self.use_ts:
                return (wmix * (parts["color_sat"] + parts["logbeta"])
                        + (1.0 - wmix) * parts["mse"])
            return parts["mse"]

        z_vals = draws["z_vals"]
        out = fused_train_loss_grads(
            params["nerf_coarse"], rays_o, rays_d, sun_d, t_embed, z_vals,
            draws["noise"], rgbs, wmix, beta_min=BETA_MIN,
            return_weights=n_imp > 0, **kw)
        parts, g_field, d_t = out[:3]
        loss = mix(parts)
        grads = {f"nerf_coarse.{k}": v for k, v in g_field.items()}
        sc_passes = [("nerf_coarse", z_vals, draws["sc_noise"])]
        if n_imp > 0:
            # the two-launch dispatch: resample over the coarse weights, then
            # the same kernel chain over the sorted union with the fine model
            z_all = resample_zvals(None, z_vals, out[3], n_imp, det=False,
                                   u=draws["u"])
            parts, g_field, d_t_fine = fused_train_loss_grads(
                params["nerf_fine"], rays_o, rays_d, sun_d, t_embed, z_all,
                draws["fine_noise"], rgbs, wmix, beta_min=BETA_MIN, **kw)
            loss = loss + mix(parts)
            grads.update({f"nerf_fine.{k}": v for k, v in g_field.items()})
            d_t = d_t + d_t_fine
            sc_passes.append(("nerf_fine", z_all, draws["sc_noise_fine"]))
        table = params["embedding_t"].weight if self.use_ts else None
        if self.use_ts:
            grads["embedding_t.weight"] = torch.zeros_like(table).index_add_(
                0, ts.long(), d_t.to(table.dtype))

        if self.render_cfg.solar_correction:
            # the sun-ray pass of each model: its depths, its own noise
            for name, z_pass, sc_noise in sc_passes:
                sc_parts, g_sc = fused_sc_loss_grads(
                    params[name], rays_o, sun_d, t_embed, z_pass, sc_noise,
                    cfg.sc_lambda, **kw)
                loss = loss + sc_parts["term2"] + sc_parts["term3"]
                for k, v in g_sc.items():
                    grads[f"{name}.{k}"] += v
        metrics = {"loss": loss}  # with SC, before DS

        if depth is not None:
            # the reference compares its 1-based step counter (main.py:139)
            active = step + 1 < self.ds_drop_step
            # once the term has dropped out only its value is logged: the
            # render runs without a graph and keeps no activations
            if n_imp > 0:
                with torch.set_grad_enabled(active):
                    ld = self._depth_render_loss(params, depth, d_draws)
                if active:
                    names, leaves = zip(*params.named_parameters())
                    for name, g in zip(names, torch.autograd.grad(
                            ld, leaves, allow_unused=True)):
                        if g is not None:
                            grads[name] += g
            else:
                ld = self._k4_depth_pass(params, depth, d_draws, active, grads)
            metrics["loss_depth"] = ld.detach()
            if active:
                loss = loss + ld.detach()

        metrics["psnr"] = -10.0 * torch.log10(parts["mse"])
        metrics["loss_total"] = loss
        return loss, metrics, grads

    def _nerf_loss_and_grads(self, params, rays, rgbs, draws):
        """The nerf variant's primary pass through fused_nerf_train_loss_grads
        (K7): plain MSE, no embedding, no solar correction (the variant has no
        sun head). Counterpart of satnerf_tpu/train/system.py:502-514."""
        mse, g_field = fused_nerf_train_loss_grads(
            params["nerf_coarse"], rays[:, 0:3], rays[:, 3:6],
            draws["z_vals"], draws["noise"], rgbs, **self._field_kw())
        grads = {f"nerf_coarse.{k}": v for k, v in g_field.items()}
        metrics = {"loss": mse, "psnr": -10.0 * torch.log10(mse),
                   "loss_total": mse}
        return mse, metrics, grads

    def _k4_depth_pass(self, params, depth, d_draws, active: bool, grads):
        """The coarse-only depth pass through fused_train_render_rays; adds
        its gradients onto `grads` while active. Returns the depth loss."""
        cfg, field = self.cfg, params["nerf_coarse"]
        d_rays, d_targets, d_ts = depth
        t_leaf = None
        if self.use_ts:
            t_leaf = self._embed_ts(params, d_ts, d_rays.shape[0]).detach()
            t_leaf.requires_grad_(active)
        with torch.set_grad_enabled(active):
            out = fused_train_render_rays(
                field, d_rays[:, 0:3], d_rays[:, 3:6], self._sun_dir(d_rays),
                t_leaf, d_draws["z_vals"], d_draws["noise"],
                **self._field_kw())
            kp_w = 1.0 if cfg.ds_noweights else d_targets[:, 1]
            ld, _ = depth_loss({"depth_coarse": out["depth"]},
                               d_targets[:, 0], kp_w, cfg.ds_lambda)
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
                table = params["embedding_t"].weight
                grads["embedding_t.weight"].index_add_(
                    0, d_ts.long(), d_grads[-1].to(table.dtype))
        return ld

    def _autograd_loss_and_grads(self, params, rays, rgbs, ts, step, draws,
                                 depth, d_draws):
        """Points and off mode: the batch through the plain renderer, the
        variant's loss with the beta gate and the SC terms, the depth pass,
        and one backward over every parameter."""
        cfg = self.cfg
        with torch.enable_grad():
            results = render_rays(
                self.field_fns(params), rays,
                self._embed_ts(params, ts, rays.shape[0]), self.render_cfg,
                dtype=self.compute_dtype, noise=draws["noise"],
                sc_noise=draws["sc_noise"], z_vals=draws["z_vals"],
                u=draws["u"], fine_noise=draws["fine_noise"],
                sc_noise_fine=draws["sc_noise_fine"])
            if self.is_nerf:
                loss, _ = nerf_loss(results, rgbs)
            elif self.use_ts and self.beta_gate(step) == 1.0:
                loss, _ = satnerf_loss(results, rgbs, cfg.sc_lambda)
            else:
                loss, _ = snerf_loss(results, rgbs, cfg.sc_lambda)
            total = loss
        metrics = {"loss": loss.detach()}
        if depth is not None:
            active = step + 1 < self.ds_drop_step
            with torch.set_grad_enabled(active):
                ld = self._depth_render_loss(params, depth, d_draws)
                if active:
                    total = total + ld
            metrics["loss_depth"] = ld.detach()
        names, leaves = zip(*params.named_parameters())
        got = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g)
                 for n, p, g in zip(names, leaves, got)}
        typ = "fine" if "rgb_fine" in results else "coarse"
        mse = torch.mean((results[f"rgb_{typ}"].detach() - rgbs) ** 2)
        metrics["psnr"] = -10.0 * torch.log10(mse)
        metrics["loss_total"] = total.detach()
        return metrics["loss_total"], metrics, grads

    def train_step(self, state: TrainState, data: dict, key=None, idx=None,
                   z_vals=None, noise=None, *, sc_noise=None, d_idx=None,
                   d_z_vals=None, d_noise=None, u=None, fine_noise=None,
                   sc_noise_fine=None, d_u=None, d_fine_noise=None) -> dict:
        """One optimizer step on batches drawn from the device-resident
        `data` (the rank's shard in a process group: batch_size / world rays
        a micro-batch) = {"rays" (N, 11), "rgbs" (N, 3), "ts" (N,)} plus, with
        ds_lambda > 0, {"d_rays" (M, 11), "d_depths" (M, 2), "d_ts" (M,)}
        and, with `--sampling shuffle`, {"perm" (N,)}, the epoch's
        permutation (epoch_perm), which the caller refreshes at every epoch
        boundary. The color batch is drawn with replacement, or read from
        the permutation at epoch_draw_positions; the depth batch always with
        replacement.

        `key` is the run's key, PRNGKey(seed + 1) as a raw uint32[2]
        (utils/jax_prng.py), from which the step derives its own as the JAX
        step does (jax_prng.step_keys): fold_in the rank, then state.step;
        a micro-batch's (k_idx, k_didx, k_loss). idx is randint(k_idx,
        (batch,), 0, N), d_idx randint(k_didx, (batch,), 0, M), and k_loss
        is loss_and_grads' key. `idx` and `d_idx` (batch_size,) and
        loss_and_grads' `z_vals`, `noise`, `u`, `fine_noise`, `sc_noise`,
        `sc_noise_fine`, `d_z_vals`, `d_noise`, `d_u`, `d_fine_noise` replace
        those draws; with grad_accum N each is a sequence of N, one a
        micro-batch. With grad_accum N the losses,
        metrics and gradients of N micro-batches are averaged into one Adam
        step at one learning rate, and state.step grows by one. Updates
        `state` in place and returns the metrics (tensors on the device,
        plus the float "lr"). In a process group the averaged gradients and
        metrics are averaged across the ranks, one all-reduce each, before
        Adam: a step adds no draw of its own."""
        cfg = self.cfg
        accum = cfg.grad_accum
        batch = cfg.batch_size // self.world
        injected = dict(idx=idx, z_vals=z_vals, noise=noise, sc_noise=sc_noise,
                        d_idx=d_idx, d_z_vals=d_z_vals, d_noise=d_noise, u=u,
                        fine_noise=fine_noise, sc_noise_fine=sc_noise_fine,
                        d_u=d_u, d_fine_noise=d_fine_noise)
        if accum == 1:
            injected = {k: [v] for k, v in injected.items()}
        else:
            injected = {k: [None] * accum if v is None else list(v)
                        for k, v in injected.items()}
        n = data["rays"].shape[0]
        keys = [(None, None, None)] * accum
        if key is not None:
            keys = jax_prng.step_keys(key, self.rank, state.step, accum)
        metrics = grads = None
        for m in range(accum):
            inj = {k: v[m] for k, v in injected.items()}
            k_idx, k_didx, k_loss = keys[m]
            idx = inj.pop("idx")
            if idx is None and cfg.sampling == "shuffle":
                idx = data["perm"][epoch_draw_positions(
                    state.step, self.spe, batch, n, self.device)]
            elif idx is None:
                idx = JD.randint(self._key(k_idx, "idx"), (batch,), 0, n,
                                 self.device)
            depth, d_idx = None, inj.pop("d_idx")
            if self.depth:
                if d_idx is None:
                    d_idx = JD.randint(self._key(k_didx, "d_idx"), (batch,), 0,
                                       data["d_rays"].shape[0], self.device)
                depth = (data["d_rays"][d_idx], data["d_depths"][d_idx],
                         data["d_ts"][d_idx])
            ts = data["ts"][idx] if self.use_ts else None
            _, m_i, g_i = self.loss_and_grads(
                state.params, data["rays"][idx], data["rgbs"][idx], ts,
                state.step, k_loss, depth=depth, **inj)
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
        if D.is_distributed():  # pmean, satnerf_tpu/train/system.py:742-743
            D.all_reduce_mean(grads.values())
            keys = sorted(metrics)
            flat = torch.stack([metrics[k].detach().float().reshape(())
                                for k in keys])
            D.all_reduce_mean([flat])
            metrics = dict(zip(keys, flat.unbind()))
        for name, p in state.params.named_parameters():
            p.grad = grads[name]
        lr = self.lr_schedule(state.step)  # read before the increment
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics["lr"] = lr
        return metrics
