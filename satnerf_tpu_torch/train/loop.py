"""The training loop: dataset loading, device placement, the step loop,
per-epoch validation and checkpointing (counterpart of
satnerf_tpu/train/loop.py, the reference's Lightning Trainer glue,
main.py:233-261). Behavior parity:

  * `num_sanity_val_steps` validation images before training (main.py:257)
  * validation every epoch; the first val item is a train image excluded from
    the metrics (main.py:170-171, 202-203)
  * checkpoints at every `save_every_n_epochs`-th epoch, named epoch={n}.ckpt,
    and at the end; `--ckpt_path` resumes weights, Adam state and step
  * per-step scalars: lr, train/loss, train/psnr, and train/loss_depth with
    depth supervision
  * `--sampling shuffle`: the epoch's permutation is drawn at every epoch
    boundary and, from the step count, on resume
  * DSM MAE against lidar GT during validation when gt_dir is set

The hot loop stays on the device: the dataset lives there and batches are
drawn there (train/system.py); scalars are fetched at the log boundary only.
One device, one process.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.data import load_dataset
from satnerf_tpu_torch.eval.dsm_metrics import compute_mae_and_save_dsm_diff
from satnerf_tpu_torch.eval.images import save_nerf_output_to_images
from satnerf_tpu_torch.eval.val_ts import (find_best_embedding_for_val_image,
                                           predefined_val_ts)
from satnerf_tpu_torch.ops.ssim import psnr as psnr_np
from satnerf_tpu_torch.ops.ssim import ssim as ssim_np
from satnerf_tpu_torch.train.checkpoints import (checkpoint_path,
                                                 load_checkpoint,
                                                 save_checkpoint)
from satnerf_tpu_torch.train.logging import RunLogger, visualize_depth
from satnerf_tpu_torch.train.system import NeRFSystem


def validate(system: NeRFSystem, params, val_dataset, cfg: Config,
             logger: RunLogger, step: int, epoch: int,
             max_images: int | None = None, save_images: bool = False):
    """Render val images, log PSNR/SSIM (+ DSM MAE for sat data)."""
    n_images = len(val_dataset)
    if max_images is not None:
        n_images = min(n_images, max_images)

    metrics = {"psnr": [], "ssim": [], "mae": []}
    for i in range(n_images):
        sample = val_dataset.load_image(i)
        rays, rgbs = sample["rays"], sample["rgbs"]
        h, w = int(sample["h"]), int(sample["w"])

        ts = None
        if system.use_ts:
            t = predefined_val_ts(sample["src_id"])
            if t is None:
                own = int(sample["ts"][0])
                vocab = cfg.t_embbeding_vocab
                n_train = min(getattr(val_dataset, "n_train", vocab) or vocab,
                              vocab)
                if own < n_train:
                    # the val-probe train image: its own id is a trained
                    # embedding (item 0 of the val split is a train image)
                    t = own
                else:
                    # its id (n_train + i) is outside the trained embeddings:
                    # search them for the best-PSNR surrogate, as the eval
                    # entry point does (reference eval_satnerf.py:148-164)
                    t = find_best_embedding_for_val_image(
                        system, params, rays, rgbs,
                        train_indices=range(n_train))
            ts = np.full(rays.shape[0], t, dtype=np.int32)

        results = system.render_image(params, rays, ts)
        typ = "fine" if "rgb_fine" in results else "coarse"
        pred = results[f"rgb_{typ}"]

        img = np.moveaxis(pred.reshape(h, w, 3), -1, 0)
        img_gt = np.moveaxis(rgbs.reshape(h, w, 3), -1, 0)
        is_val_image = not (cfg.data == "sat" and i == 0)
        split = "val" if is_val_image else "train"
        idx = i - 1 if is_val_image else i
        if logger.tb is not None:
            depth_vis = visualize_depth(results[f"depth_{typ}"].reshape(h, w))
            logger.images(step, f"{split}_{idx}/GT_pred_depth",
                          np.stack([img_gt, img, depth_vis]))

        if save_images and cfg.data == "sat" and i <= 1:
            out_dir = os.path.join(cfg.logs_dir, cfg.exp_name, split)
            save_nerf_output_to_images(val_dataset, sample, results, out_dir,
                                       epoch)

        p = psnr_np(pred, rgbs)
        s = ssim_np(img, img_gt)
        if is_val_image:
            metrics["psnr"].append(p)
            metrics["ssim"].append(s)
            if cfg.data == "sat" and cfg.gt_dir is not None:
                try:
                    out_dir = os.path.join(cfg.logs_dir, cfg.exp_name, "val")
                    tmp = os.path.join(out_dir, "dsm", f"tmp_pred_dsm_{step}.tif")
                    val_dataset.dsm_from_prediction(
                        rays, results[f"depth_{typ}"], dsm_path=tmp)
                    mae = compute_mae_and_save_dsm_diff(
                        tmp, sample["src_id"], cfg.gt_dir, out_dir, 0, save=False)
                    os.remove(tmp)
                    metrics["mae"].append(mae)
                except Exception:  # parity: main.py:218-219 -> NaN
                    metrics["mae"].append(float("nan"))

    out = {}
    if metrics["psnr"]:
        out["val/psnr"] = float(np.mean(metrics["psnr"]))
        out["val/ssim"] = float(np.mean(metrics["ssim"]))
    if metrics["mae"]:
        out["val/mae"] = float(np.nanmean(metrics["mae"]))
    if out:
        logger.scalars(step, out)
    return out


def _save(path: str, state) -> str:
    save_checkpoint(path, state.params, state.optimizer, state.step)
    return path


def fit(cfg: Config) -> dict:
    """Run the full training job. Returns {"state", "system", "metrics",
    "cfg"}."""
    t0 = time.time()
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cfg.device is 'cuda' but no CUDA device is visible "
                           "(pass --device cpu to train on the CPU)")
    if cfg.n_devices > 1:
        raise ValueError(f"--n_devices {cfg.n_devices}: this port trains on one "
                         f"device; training across devices is ROADMAP item M7")

    train_sets = load_dataset(cfg, split="train")
    train_ds = train_sets[0]
    depth_ds = train_sets[1] if len(train_sets) > 1 else None
    val_ds = load_dataset(cfg, split="val")[0]
    system = NeRFSystem(cfg, device=device, dataset_len=len(train_ds))
    logger = RunLogger(cfg.logs_dir, cfg.exp_name)
    # opts.json is half the checkpoint contract (opt.py:85-87): guarantee it
    # whether the run came through the CLI or through fit() directly
    if not os.path.exists(os.path.join(cfg.logs_dir, cfg.exp_name, "opts.json")):
        cfg.dump()

    state = system.init_state(torch.Generator().manual_seed(cfg.seed))
    if cfg.ckpt_path:
        state.step = load_checkpoint(cfg.ckpt_path, state.params,
                                     state.optimizer)
        print(f"resumed from {cfg.ckpt_path} at step {state.step}")

    # the dataset lives on the device; batches are drawn there
    ids = getattr(train_ds, "all_ids", None)
    if ids is None:
        ids = np.zeros(len(train_ds), np.int64)
    def on_device(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    data = {"rays": on_device(train_ds.all_rays, np.float32),
            "rgbs": on_device(train_ds.all_rgbs, np.float32),
            "ts": on_device(ids, np.int64)}
    if depth_ds is not None:
        data.update(d_rays=on_device(depth_ds.all_rays, np.float32),
                    d_depths=on_device(depth_ds.all_depths, np.float32),
                    d_ts=on_device(depth_ds.all_ids, np.int64))
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    # --sampling shuffle: the color rays are read along a per-epoch
    # permutation; the depth rays keep the draw with replacement
    shuffle = cfg.sampling == "shuffle"
    if shuffle:
        data["perm"] = system.epoch_perm(len(train_ds), state.step // system.spe)

    # sanity validation (main.py:257)
    if cfg.num_sanity_val_steps > 0:
        validate(system, state.params, val_ds, cfg, logger, step=0, epoch=0,
                 max_images=cfg.num_sanity_val_steps)

    spe = system.spe
    start_step = state.step
    last_log = time.time()
    rays_done = 0
    final_metrics = {}
    profiler = None

    for step_i in range(start_step, cfg.max_train_steps):
        # device trace of a steady-state window of ten steps
        if cfg.profile_dir and step_i == start_step + 20:
            from torch.profiler import ProfilerActivity, profile

            profiler = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]
                               if device.type == "cuda"
                               else [ProfilerActivity.CPU])
            profiler.start()
        if profiler is not None and step_i == start_step + 30:
            profiler.stop()
            os.makedirs(cfg.profile_dir, exist_ok=True)
            trace = os.path.join(cfg.profile_dir, "train_steps_20_30.json")
            profiler.export_chrome_trace(trace)
            profiler = None
            print(f"wrote torch profiler trace to {trace}")

        m = system.train_step(state, data, generator)
        rays_done += cfg.batch_size * cfg.grad_accum

        if (step_i + 1) % cfg.log_every_n_steps == 0:
            # the only place the loop fetches device scalars
            m = {k: float(v) for k, v in m.items()}
            if not np.isfinite(m["loss"]):
                # the state is already poisoned; an emergency dump keeps it
                # for diagnosis. Not named epoch={n}: it stays invisible to
                # the eval entry points' epoch lookup
                p = _save(os.path.join(cfg.ckpts_dir, cfg.exp_name,
                                       "nan-crash.ckpt"), state)
                raise FloatingPointError(
                    f"non-finite loss {m['loss']} at step {step_i + 1} "
                    f"(lr {m['lr']:.3g}); poisoned state dumped to {p} — "
                    f"resume from the last epoch={{n}}.ckpt")
            now = time.time()
            rps = rays_done / max(now - last_log, 1e-9)
            last_log, rays_done = now, 0
            logger.scalars(step_i + 1, {
                "lr": m["lr"], "train/loss": m["loss"],
                "train/psnr": m["psnr"], "train/rays_per_sec": rps,
                **({"train/loss_depth": m["loss_depth"]}
                   if "loss_depth" in m else {})})
            print(f"step {step_i + 1}/{cfg.max_train_steps} "
                  f"loss {m['loss']:.5f} psnr {m['psnr']:.2f} "
                  f"rays/s {rps:,.0f}")

        # epoch boundary: validate + checkpoint
        if (step_i + 1) % spe == 0:
            epoch = (step_i + 1) // spe
            if shuffle:
                data["perm"] = system.epoch_perm(len(train_ds), epoch)
            if epoch % cfg.val_every_n_epochs == 0:
                final_metrics = validate(
                    system, state.params, val_ds, cfg, logger, step_i + 1,
                    epoch, save_images=epoch % cfg.save_every_n_epochs == 0)
                last_log = time.time()  # validation is not training time
                rays_done = 0
            if epoch % cfg.save_every_n_epochs == 0:
                p = checkpoint_path(cfg.ckpts_dir, cfg.exp_name, epoch)
                print(f"saved {_save(p, state)}")

    # final checkpoint + validation
    if profiler is not None:
        profiler.stop()
    epoch = cfg.max_train_steps // spe
    _save(checkpoint_path(cfg.ckpts_dir, cfg.exp_name, epoch), state)
    final_metrics = validate(system, state.params, val_ds, cfg, logger,
                             cfg.max_train_steps, epoch, save_images=True)
    logger.close()
    print(f"done in {time.time() - t0:.1f}s — {final_metrics}")
    return {"state": state, "system": system, "metrics": final_metrics,
            "cfg": cfg}
