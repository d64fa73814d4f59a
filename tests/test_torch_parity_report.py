"""tools/parity_report_torch.py against tools/parity_report.py (ROADMAP M8).

Both tools, on the CPU, score the val split of one synthetic AOI (built by
the port's satnerf_tpu_torch.data.synthetic, byte for byte the JAX tool's)
from the committed JAX checkpoint tests/data/jax_satnerf_4x32.ckpt
(msgpack, sat-nerf 4 x 32, 32 samples a ray), each through its own eval:
PSNR within 0.01 dB, SSIM within 1e-4 and the DSM MAE within 1e-2 m. The
port's tool also reads a PL-style torch checkpoint of the same weights, and
both tools write a report with the same keys.
"""

import importlib
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

torch.set_num_threads(1)

FIXTURE = os.path.join(REPO, "tests", "data", "jax_satnerf_4x32.ckpt")
MODEL = ["--model", "sat-nerf", "--fc_layers", "4", "--fc_units", "32",
         "--n_samples", "32", "--chunk", "1024"]
TOL = {"psnr": 0.01, "ssim": 1e-4, "mae": 1e-2}


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    from satnerf_tpu_torch.data import synthetic

    root = str(tmp_path_factory.mktemp("parity") / "aoi")
    synthetic.main([root, "--size", "16", "--n_train", "3", "--n_test", "2"])
    return root


def _run(tool, aoi, out, ckpt=FIXTURE, extra=()):
    ckpt_name = os.path.join(out, "in", "epoch=3.ckpt")  # the epoch is read off the name
    os.makedirs(os.path.dirname(ckpt_name), exist_ok=True)
    if ckpt != ckpt_name:
        with open(ckpt, "rb") as a, open(ckpt_name, "wb") as b:
            b.write(a.read())
    return tool.main(["--ckpt", ckpt_name,
                      "--root_dir", os.path.join(aoi, "data"),
                      "--gt_dir", os.path.join(aoi, "gt"),
                      "--output_dir", out, *MODEL, *extra])


@pytest.fixture(scope="module")
def reports(aoi, tmp_path_factory):
    base = tmp_path_factory.mktemp("reports")
    jax_tool = importlib.import_module("tools.parity_report")
    port_tool = importlib.import_module("tools.parity_report_torch")
    jax_report = _run(jax_tool, aoi, str(base / "jax"))
    port_report = _run(port_tool, aoi, str(base / "port"),
                       extra=("--device", "cpu"))
    return jax_report, port_report, str(base)


def test_the_port_scores_as_the_jax_tool(reports):
    jax_report, port_report, _ = reports
    for k, tol in TOL.items():
        assert abs(port_report["ours"][k] - jax_report["ours"][k]) <= tol, \
            (k, port_report["ours"], jax_report["ours"])


def test_the_reports_have_the_same_keys(reports):
    jax_report, port_report, base = reports
    assert set(port_report) == set(jax_report) == {
        "checkpoint", "epoch", "root_dir", "ours", "reference", "delta"}
    assert port_report["epoch"] == jax_report["epoch"] == 3
    assert set(port_report["ours"]) == {"psnr", "ssim", "mae"}
    with open(os.path.join(base, "port", "parity_report.json")) as f:
        assert json.load(f) == json.loads(json.dumps(port_report))
    assert os.path.isfile(os.path.join(base, "port", "logs", "parity",
                                       "opts.json"))
    assert os.path.isfile(os.path.join(base, "port", "ckpts", "parity",
                                       "epoch=3.ckpt"))


def test_a_torch_checkpoint_of_the_same_weights_scores_the_same(aoi, reports,
                                                                 tmp_path):
    """The port's own PL-style checkpoint of the fixture's weights, with the
    expected figures given: the deltas are the figures' differences."""
    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.train.checkpoints import (load_checkpoint,
                                                     save_checkpoint)
    from satnerf_tpu_torch.train.system import NeRFSystem

    _, port_report, _ = reports
    system = NeRFSystem(Config(model="sat-nerf", fc_layers=4, fc_units=32,
                               n_samples=32), device="cpu")
    params = system.init_params()
    load_checkpoint(FIXTURE, params)
    torch_ckpt = str(tmp_path / "torch" / "epoch=3.ckpt")
    save_checkpoint(torch_ckpt, params)
    want = port_report["ours"]
    report = _run(importlib.import_module("tools.parity_report_torch"), aoi,
                  str(tmp_path / "out"), ckpt=torch_ckpt,
                  extra=("--device", "cpu", "--expected_psnr",
                         str(want["psnr"]), "--expected_ssim",
                         str(want["ssim"]), "--expected_mae",
                         str(want["mae"])))
    for k in ("psnr", "ssim", "mae"):
        assert abs(report["delta"][k]) < 1e-6, (k, report)
