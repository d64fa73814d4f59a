"""Experiment configuration: the reference CLI surface (opt.py:10-89) as a
dataclass + argparse front-end, with the opts.json dump preserved so that
eval tooling can re-hydrate a run from its log directory exactly like the
reference (eval_satnerf.py:216-217).

All 23 reference flags keep their names and defaults (including the
`t_embbeding_*` spellings for opts.json compatibility). The knobs this
framework adds come at the end; every flag of the JAX package is kept, so an
opts.json written by either package loads here. The reference's
`config_name` crash when --exp_name is omitted (opt.py:81) is not replicated:
a missing exp_name falls back to the model name.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Config:
    # input paths
    root_dir: str = ""
    img_dir: Optional[str] = None
    ckpts_dir: str = "ckpts"
    logs_dir: str = "logs"
    gt_dir: Optional[str] = None
    cache_dir: Optional[str] = None
    ckpt_path: Optional[str] = None

    # basic stuff and dataset options
    exp_name: Optional[str] = None
    data: str = "sat"  # sat | blender
    model: str = "sat-nerf"  # nerf | s-nerf | sat-nerf
    gpu_id: int = 0  # kept for CLI compatibility; ignored (see `device`)

    # training and network configuration
    lr: float = 5e-4
    lr_scheduler: str = "step"  # step | cosine | exponential | multistep
    batch_size: int = 1024
    img_downscale: float = 1.0
    max_train_steps: int = 300000
    save_every_n_epochs: int = 4
    fc_units: int = 512
    fc_layers: int = 8
    n_samples: int = 64
    n_importance: int = 0
    noise_std: float = 0.0
    chunk: int = 1 << 16  # eval-time device batch (training needs no chunking).
    # The reference's 5120 (opt.py:60-61) was sized for a small card; the
    # forward render of 64k rays x 64 samples holds ~17 GB of bf16 activations
    # (csrc/fused_render.cu), so the default is one 256^2 image per chunk.

    # sat-nerf specific
    sc_lambda: float = 0.0
    ds_lambda: float = 0.0
    ds_drop: float = 0.25
    ds_noweights: bool = False
    first_beta_epoch: int = 2
    t_embbeding_tau: int = 4
    t_embbeding_vocab: int = 30

    # --- additions of this framework (absent in the reference) ---
    seed: int = 0
    device: str = "cuda"  # cuda | cpu — where the entry points run
    n_devices: int = 0  # processes, one a device (0: every visible card)
    precision: str = "auto"  # auto | float32 | bfloat16 (matmul inputs).
    # "auto" = bfloat16 on the card, float32 on the CPU (where tests pin
    # numerics against f32 oracles). Params/accumulation are f32 either way.
    fused: str = "auto"  # auto | rays | on | off — which path the SIREN
    # variants take (train/system.py fused_mode). "rays": the per-ray kernel
    # chains; "on": the plain renderer over the point-mode field kernel;
    # "off": the plain renderer over the field modules, on whatever device
    # was asked for. "auto" = "rays" on the card, "off" on the CPU. On CPU
    # tensors every kernel wrapper runs its plain version.
    sampling: str = "replacement"  # replacement | shuffle — per-step ray draw
    # ("shuffle" = without-replacement per epoch, the reference DataLoader's
    #  semantics via a per-epoch on-device permutation; "replacement" is the
    #  default uniform i.i.d. draw — see docs/DESIGN.md "Batch sampling")
    grad_accum: int = 1  # micro-batches per optimizer step: each step draws
    # grad_accum batches of batch_size rays, averages their grads, and
    # applies ONE update — effective batch = batch_size * grad_accum with
    # the memory footprint of batch_size. Replacement sampling only; epochs
    # count batch_size * grad_accum rays per step.
    eval_wire: str = "auto"  # kept for opts.json compatibility; products are
    # fetched as float32 here
    log_every_n_steps: int = 100
    profile_dir: Optional[str] = None  # write a torch.profiler trace of steps 20-30
    val_every_n_epochs: int = 1
    num_sanity_val_steps: int = 2

    def stamp_exp_name(self) -> None:
        exp_id = self.exp_name if self.exp_name is not None else self.model
        ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        self.exp_name = f"{ts}_{exp_id}"

    def dump(self) -> str:
        """Write opts.json into the run's log dir (opt.py:85-87)."""
        run_dir = os.path.join(self.logs_dir, self.exp_name)
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, "opts.json")
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
        return path

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            d = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="satnerf_tpu_torch training")
    d = Config()
    # input paths
    p.add_argument("--root_dir", type=str, required=True)
    p.add_argument("--img_dir", type=str, default=d.img_dir)
    p.add_argument("--ckpts_dir", type=str, default=d.ckpts_dir)
    p.add_argument("--logs_dir", type=str, default=d.logs_dir)
    p.add_argument("--gt_dir", type=str, default=d.gt_dir)
    p.add_argument("--cache_dir", type=str, default=d.cache_dir)
    p.add_argument("--ckpt_path", type=str, default=d.ckpt_path)
    # basic
    p.add_argument("--exp_name", type=str, default=d.exp_name)
    p.add_argument("--data", type=str, default=d.data, choices=["sat", "blender"])
    p.add_argument("--model", type=str, default=d.model,
                   choices=["nerf", "s-nerf", "sat-nerf"])
    p.add_argument("--gpu_id", type=int, default=0,
                   help="accepted for reference-CLI compatibility; unused (see --device)")
    # training / network
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--lr_scheduler", type=str, default=d.lr_scheduler,
                   choices=["step", "cosine", "exponential", "multistep"])
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--img_downscale", type=float, default=d.img_downscale)
    p.add_argument("--max_train_steps", type=int, default=d.max_train_steps)
    p.add_argument("--save_every_n_epochs", type=int, default=d.save_every_n_epochs)
    p.add_argument("--fc_units", type=int, default=d.fc_units)
    p.add_argument("--fc_layers", type=int, default=d.fc_layers)
    p.add_argument("--n_samples", type=int, default=d.n_samples)
    p.add_argument("--n_importance", type=int, default=d.n_importance)
    p.add_argument("--noise_std", type=float, default=d.noise_std)
    p.add_argument("--chunk", type=int, default=d.chunk)
    # sat-nerf specific
    p.add_argument("--sc_lambda", type=float, default=d.sc_lambda)
    p.add_argument("--ds_lambda", type=float, default=d.ds_lambda)
    p.add_argument("--ds_drop", type=float, default=d.ds_drop)
    p.add_argument("--ds_noweights", action="store_true")
    p.add_argument("--first_beta_epoch", type=int, default=d.first_beta_epoch)
    p.add_argument("--t_embbeding_tau", type=int, default=d.t_embbeding_tau)
    p.add_argument("--t_embbeding_vocab", type=int, default=d.t_embbeding_vocab)
    # additions of this framework
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--device", type=str, default=d.device,
                   choices=["cuda", "cpu"])
    p.add_argument("--n_devices", type=int, default=d.n_devices)
    p.add_argument("--precision", type=str, default=d.precision,
                   choices=["auto", "float32", "bfloat16"],
                   help="the matmul operands' type (sums and parameters stay "
                        "float32): auto is bfloat16 on the card and float32 "
                        "on the CPU; float32 runs exact float32 FMAs on the "
                        "dense kernels' SIMT mainloop, no TF32, and is slower "
                        "than bfloat16 on the card")
    p.add_argument("--fused", type=str, default=d.fused,
                   choices=["auto", "on", "rays", "off"],
                   help="rays: the per-ray CUDA kernel chains (auto on the "
                        "card); on: the plain renderer over the point-mode "
                        "field kernel; off: plain PyTorch all the way (auto "
                        "on the CPU). An explicit off on the card is the "
                        "caller's choice: no kernel is launched and nothing "
                        "falls back to it on its own")
    p.add_argument("--sampling", type=str, default=d.sampling,
                   choices=["replacement", "shuffle"])
    p.add_argument("--grad_accum", type=int, default=d.grad_accum)
    p.add_argument("--eval_wire", type=str, default=d.eval_wire,
                   choices=["auto", "float16", "off"])
    p.add_argument("--log_every_n_steps", type=int, default=d.log_every_n_steps)
    p.add_argument("--profile_dir", type=str, default=d.profile_dir)
    p.add_argument("--val_every_n_epochs", type=int, default=d.val_every_n_epochs)
    p.add_argument("--num_sanity_val_steps", type=int, default=d.num_sanity_val_steps)
    return p


def get_opts(argv=None) -> Config:
    """The command line's Config, its run name stamped with the time (fit
    writes its opts.json, on rank 0)."""
    args = build_parser().parse_args(argv)
    cfg = Config(**vars(args))
    cfg.stamp_exp_name()
    return cfg
