"""Training entry point of the PyTorch port — train.py's flow and flags
(the reference's `python3 main.py`, see satnerf_tpu_torch/config.py).

  python -m satnerf_tpu_torch.cli.train --root_dir data/root_dir/JAX_068 \
      --img_dir data/DFC2019/Track3-RGB-crops/JAX_068 \
      --cache_dir cache/JAX_068_ds1 --gt_dir data/Track3-Truth \
      --model sat-nerf --exp_name JAX_068_ds1_sat-nerf [--device cuda]

Trains on the card (the CUDA kernels of ops/fused_mlp.py) unless
`--device cpu` is given. `--ckpt_path ckpts/<run>/epoch=N.ckpt` resumes
weights, Adam state and step count.

Across devices (train/loop.py, parallel/distributed.py): `--n_devices N`
trains N processes on this host, one a card (0, the default: every visible
card; on the CPU, N gloo processes); or launch one process a device with
SATNERF_COORDINATOR=host:port, SATNERF_NUM_PROCS and SATNERF_PROC_ID set
in each. Rank 0 writes the run (opts.json, logs, checkpoints).
"""

from __future__ import annotations

from satnerf_tpu_torch.config import get_opts
from satnerf_tpu_torch.train.loop import fit


def main(argv=None) -> dict:
    cfg = get_opts(argv)
    print(f"\nRunning {cfg.exp_name}\n")
    return fit(cfg)


if __name__ == "__main__":
    main()
