"""Evaluation. The host chain after rendering (depth -> ECEF -> UTM -> DSM
raster -> NCC registration -> MAE, the GeoTIFF product dumps, the
embedding choice for validation images) is numpy code; the port keeps its
own copies of these modules (counterparts under satnerf_tpu/ of the same
relative names)."""

from satnerf_tpu_torch.eval.dsm_metrics import compute_mae_and_save_dsm_diff
from satnerf_tpu_torch.eval.images import save_nerf_output_to_images
from satnerf_tpu_torch.eval.val_ts import (find_best_embedding_for_val_image,
                                     predefined_val_ts)
from satnerf_tpu_torch.geo.geotiff import read_geotiff, write_geotiff

__all__ = ["compute_mae_and_save_dsm_diff", "find_best_embedding_for_val_image",
           "predefined_val_ts", "read_geotiff", "save_nerf_output_to_images",
           "write_geotiff"]
