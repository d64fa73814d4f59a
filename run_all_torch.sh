#!/bin/bash
# Canonical experiment suite per AOI through the PyTorch port: run_all.sh
# (the reference's run_all.sh matrix) with python -m satnerf_tpu_torch.cli.train
# in place of train.py: nerf (fc 256), s-nerf, s-nerf+SC 0.05, sat-nerf,
# sat-nerf+SC 0.1, sat-nerf noBA, sat-nerf+DS lambda=1000. 500k steps, ds1.
# Trains on the card; EXTRA_ARGS takes any cli.train flag (--device cpu).
#
# Usage: ./run_all_torch.sh AOI_ID DATA_DIR IMG_DIR GT_DIR [CACHE_DIR] [EXTRA_ARGS...]
#   DATA_DIR: root with per-image jsons + train/test splits (BA-corrected RPCs)
#   A sibling "${DATA_DIR}_noba" root (original RPCs) enables the noBA run.

set -e

aoi_id="$1"
root_dir="$2"
img_dir="$3"
gt_dir="$4"
cache_dir="${5:-cache/${aoi_id}_ds1}"
shift 5 || shift $#
extra="$@"

n_steps=500000
train="python -m satnerf_tpu_torch.cli.train"
common="--root_dir $root_dir --img_dir $img_dir --gt_dir $gt_dir \
        --cache_dir $cache_dir --max_train_steps $n_steps --gpu_id 0 $extra"

echo "=== 1/7 nerf (fc_units 256) ==="
$train $common --model nerf --fc_units 256 \
    --exp_name ${aoi_id}_ds1_nerf

echo "=== 2/7 s-nerf ==="
$train $common --model s-nerf \
    --exp_name ${aoi_id}_ds1_snerf

echo "=== 3/7 s-nerf + solar correction 0.05 ==="
$train $common --model s-nerf --sc_lambda 0.05 \
    --exp_name ${aoi_id}_ds1_snerf_SCx0.05

echo "=== 4/7 sat-nerf ==="
$train $common --model sat-nerf \
    --exp_name ${aoi_id}_ds1_satnerf

echo "=== 5/7 sat-nerf + solar correction 0.1 ==="
$train $common --model sat-nerf --sc_lambda 0.1 \
    --exp_name ${aoi_id}_ds1_satnerf_SCx0.1

if [ -d "${root_dir}_noba" ]; then
  echo "=== 6/7 sat-nerf without bundle adjustment ==="
  $train $common --root_dir "${root_dir}_noba" --model sat-nerf \
      --cache_dir "${cache_dir}_noba" \
      --exp_name ${aoi_id}_ds1_satnerf_noBA
else
  echo "=== 6/7 skipped: ${root_dir}_noba not found ==="
fi

echo "=== 7/7 sat-nerf + depth supervision (lambda 1000) ==="
$train $common --model sat-nerf --ds_lambda 1000 \
    --exp_name ${aoi_id}_ds1_satnerf_DS
