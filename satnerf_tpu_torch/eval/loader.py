"""Rebuild a render system from a run directory (opts.json + epoch={n}.ckpt).

Counterpart of satnerf_tpu/eval/loader.py (the reference's load_nerf,
eval_satnerf.py:68-93): opts.json is the model spec, the PL-style .ckpt
supplies the weights.
"""

from __future__ import annotations

import json
import os

from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.train.checkpoints import checkpoint_path, load_checkpoint
from satnerf_tpu_torch.train.system import NeRFSystem


def load_run_config(logs_dir: str, run_id: str) -> Config:
    with open(os.path.join(logs_dir, run_id, "opts.json")) as f:
        return Config(**{k: v for k, v in json.load(f).items()
                         if k in Config.__dataclass_fields__})


def load_nerf(run_id: str, logs_dir: str, ckpts_dir: str, epoch_number: int,
              device="cuda"):
    """Returns (system, params) ready for render_image on `device`."""
    cfg = load_run_config(logs_dir, run_id)
    ckpt = checkpoint_path(ckpts_dir, run_id, epoch_number)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"Could not find checkpoint {ckpt}")
    system = NeRFSystem(cfg, device=device)
    params = system.init_params()
    load_checkpoint(ckpt, params)
    return system, params


def load_run(run_id: str, logs_dir: str, epoch_number: int,
             checkpoints_dir: str | None = None, root_dir: str | None = None,
             img_dir: str | None = None, gt_dir: str | None = None,
             device="cuda"):
    """The entry points' common start (create_dsm.py / eval.py): opts.json
    with the directories given on the command line in place of its own, and
    the system loaded from epoch `epoch_number`, or epoch_number - 1 when
    that checkpoint is missing (epochs are 1-based). Returns
    (cfg, system, params)."""
    cfg = load_run_config(logs_dir, run_id)
    for name, value in (("gt_dir", gt_dir), ("img_dir", img_dir),
                        ("root_dir", root_dir)):
        if value is not None:
            setattr(cfg, name, value)
    if cfg.cache_dir is not None and not os.path.isdir(cfg.cache_dir):
        cfg.cache_dir = None
    if checkpoints_dir is None:
        checkpoints_dir = cfg.ckpts_dir
    epoch_to_load = epoch_number
    if not os.path.exists(checkpoint_path(checkpoints_dir, run_id, epoch_to_load)):
        epoch_to_load = epoch_number - 1
    print(f"loading checkpoint: "
          f"{checkpoint_path(checkpoints_dir, run_id, epoch_to_load)}")
    system, params = load_nerf(run_id, logs_dir, checkpoints_dir, epoch_to_load,
                               device=device)
    return cfg, system, params
