"""The CPU geometry anchor through the port: tests/test_geometry_anchor_cpu.py
(its configuration, its two gates) with satnerf_tpu_torch.data.synthetic and
satnerf_tpu_torch.cli.train --device cpu.

A 128 px, 10-view smooth-terrain synthetic AOI; sat-nerf 8 x 64, 32 samples
a ray, batch 512 x 800 steps at lr 1e-3, seed 0; then the final validation's
train -> DSM -> register -> MAE chain. A run that learns no geometry scores
the flat-DSM floor, 6.45 m; the gates are the JAX test's: val/mae under
4.0 m and val/psnr over 12.5. The run takes about 100 s on 8 CPU cores
(3.12 m, 14.81 dB), so it carries the `slow` marker and stays out of
tier-1; chip_smoke.py's phase 9 runs the same configuration on the card
(its ANCHOR_* constants are the ones used here).

  python -m pytest tests/test_torch_geometry_anchor_cpu.py -m slow
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import (ANCHOR_AOI, ANCHOR_MAE_M, ANCHOR_PSNR,  # noqa: E402
                        ANCHOR_TRAIN)
from tests.test_geometry_anchor_cpu import MAE_GATE_M, PSNR_FLOOR  # noqa: E402


def test_the_card_phase_holds_the_cpu_anchors_gates():
    """The configuration (tests/test_geometry_anchor_cpu.py:55-82) and the
    gates, which chip_smoke.py's phase 9 runs on the card, are the JAX
    test's."""
    assert (ANCHOR_MAE_M, ANCHOR_PSNR) == (MAE_GATE_M, PSNR_FLOOR)
    assert ANCHOR_AOI == ["--n_train", "10", "--n_test", "1", "--size", "128",
                          "--view_spread", "0.25", "--terrain", "smooth",
                          "--checker", "8", "--alt_bounds", "terrain"]
    flags = dict(zip(ANCHOR_TRAIN[::2], ANCHOR_TRAIN[1::2]))
    assert flags == {"--model": "sat-nerf", "--fc_units": "64",
                     "--fc_layers": "8", "--n_samples": "32",
                     "--chunk": "16384", "--lr": "1e-3",
                     "--batch_size": "512", "--max_train_steps": "800",
                     "--log_every_n_steps": "400",
                     "--save_every_n_epochs": "999",
                     "--val_every_n_epochs": "999", "--seed": "0"}


@pytest.mark.slow
def test_geometry_anchor_cpu_through_the_port(tmp_path):
    from satnerf_tpu_torch.cli import train
    from satnerf_tpu_torch.data import synthetic

    root = str(tmp_path / "aoi")
    synthetic.main([root] + ANCHOR_AOI)
    out = train.main([
        "--root_dir", os.path.join(root, "data"),
        "--gt_dir", os.path.join(root, "gt"),
        "--cache_dir", os.path.join(root, "cache"),
        "--logs_dir", str(tmp_path / "logs"),
        "--ckpts_dir", str(tmp_path / "ckpts"), "--exp_name", "anchor_cpu",
        "--gpu_id", "0", "--device", "cpu"] + ANCHOR_TRAIN)
    metrics = out["metrics"]
    assert out["system"].fused_mode == "off"  # the plain path on the CPU
    assert metrics["val/mae"] < MAE_GATE_M, (
        f"geometry regression: CPU anchor DSM MAE {metrics['val/mae']:.3f} m "
        f"through the port (gate {MAE_GATE_M} m; a no-geometry flat DSM "
        f"scores 6.45 m)")
    assert metrics["val/psnr"] > PSNR_FLOOR, metrics
