"""Rebuild a render system from a run directory (opts.json + epoch={n}.ckpt).

Counterpart of satnerf_tpu/eval/loader.py (the reference's load_nerf,
eval_satnerf.py:68-93): opts.json is the model spec, the PL-style .ckpt
supplies the weights.

The entry points render on the cards `render_ranks` gives: opts.json's
n_devices cut to the visible cards, as the JAX loader's system renders over
make_mesh(cfg.n_devices) (0: every visible card), and one card where the
ranks would save less of a card's time than they cost. `run_on_devices`
starts those ranks (parallel/distributed.py), or joins the group
SATNERF_COORDINATOR names; each builds the system on its own card, and every
rank of the render group renders its block of each chunk. Rank 0 alone
writes files and prints.
"""

from __future__ import annotations

import json
import os

import torch

from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.data.satellite import read_dict_from_json
from satnerf_tpu_torch.parallel import distributed as D
from satnerf_tpu_torch.train.checkpoints import checkpoint_path, load_checkpoint
from satnerf_tpu_torch.train.system import NeRFSystem


def load_run_config(logs_dir: str, run_id: str) -> Config:
    with open(os.path.join(logs_dir, run_id, "opts.json")) as f:
        return Config(**{k: v for k, v in json.load(f).items()
                         if k in Config.__dataclass_fields__})


def load_nerf(run_id: str, logs_dir: str, ckpts_dir: str, epoch_number: int,
              device="cuda"):
    """Returns (system, params) ready for render_image on `device` (in a
    process group: on this rank's card)."""
    cfg = load_run_config(logs_dir, run_id)
    ckpt = checkpoint_path(ckpts_dir, run_id, epoch_number)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"Could not find checkpoint {ckpt}")
    system = NeRFSystem(cfg, device=D.rank_device(device))
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
    if D.is_main():
        print(f"loading checkpoint: "
              f"{checkpoint_path(checkpoints_dir, run_id, epoch_to_load)}")
    system, params = load_nerf(run_id, logs_dir, checkpoints_dir, epoch_to_load,
                               device=device)
    return cfg, system, params


# What an entry point's ranks cost and what they save, on NVIDIA H100 80GB
# HBM3 cards at 700 W (chip_smoke.py phase 13): four ranks that each load
# the run, render a 16,384-ray view and leave took 25.0-45.5 s, one card
# alone 0.6 s; a 44.8 M-ray view took 57.0 s on four ranks started for it
# and 59.2 s on one card, the ranks saving about 35 s less than a quarter of
# one card's device time (their start, and the host's work on the whole
# view, which every rank does). One card serves at 2.4e14 operations of the
# fields' layers a second (2 x rays x samples x layers x units^2: sat-nerf
# 8 x 512 and nerf 8 x 256 at 64 samples, the hierarchical dispatch at
# 64 + 128, bf16).
RANKS_COST_S = 35.0
CARD_FIELD_FLOPS = 2.4e14


def render_ranks(cfg: Config, rays: int, device_type: str) -> int:
    """The ranks an entry point starts to render `rays` rays of the run
    `cfg`: one on the CPU (its one device); on the card opts.json's
    n_devices (0: every visible card) cut to the cards that are visible, as
    make_mesh cuts the JAX loader's mesh, and one where what w cards save
    of a card's device time alone, (1 - 1/w) of it, is under what they
    cost, RANKS_COST_S."""
    if device_type != "cuda":
        return 1
    visible = torch.cuda.device_count()
    w = min(cfg.n_devices or visible, visible)
    if w < 2:
        return 1
    samples = cfg.n_samples + (cfg.n_samples + cfg.n_importance
                               if cfg.n_importance else 0)
    one_card_s = (2 * rays * samples * cfg.fc_layers * cfg.fc_units ** 2
                  / CARD_FIELD_FLOPS)
    return w if one_card_s * (1 - 1 / w) > RANKS_COST_S else 1


def view_rays(json_paths, img_downscale: float) -> int:
    """The rays of the views whose metadata `json_paths` list, one entry a
    render (data/satellite.py's image size)."""
    rays = 0
    for p in json_paths:
        d = read_dict_from_json(p)
        rays += (int(int(d["height"]) // img_downscale)
                 * int(int(d["width"]) // img_downscale))
    return rays


def _if_renders(fn, args):
    return fn(*args) if D.renders() else None


def run_on_devices(fn, args, logs_dir: str, run_id: str, device,
                   root_dir: str | None, views):
    """fn(*args) on every rank of the render group: the ranks that
    `render_ranks` gives for the rays of `views(root_dir)` (the json files
    of the views fn renders; root_dir None: opts.json's), started here
    (D.run_in_group), or the group SATNERF_COORDINATOR names. Ranks on other
    hosts than rank 0's skip fn. Returns this process's result: rank 0's
    under `spawn`, None where fn did not run."""
    cfg = load_run_config(logs_dir, run_id)
    device_type = torch.device(device).type
    n = 1
    if not os.environ.get("SATNERF_COORDINATOR"):
        rays = view_rays(views(root_dir or cfg.root_dir), cfg.img_downscale)
        n = render_ranks(cfg, rays, device_type)
    return D.run_in_group(_if_renders, (fn, args), n, device_type)
