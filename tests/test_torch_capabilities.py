"""The capability experiments through the port
(tools/run_capability_experiments_torch.py), beside the JAX package's
(tools/run_capability_experiments.py, gated by tests/test_capabilities.py).

- The port's tool runs the JAX tool's presets and experiment table, and
  computes the JAX tool's gates: from the committed JAX report's
  experiments it gives that report's gates, and its limits are
  tests/test_capabilities.py's.
- The smoke preset of the transient experiment runs through the port on the
  CPU (its phases in child processes, as on the card), with the assertions
  of tests/test_capabilities.py's smoke test: both trainings give a finite
  val triplet, the beta maps rendered, the sidecar statistics ran, and the
  report's gates are finite. 200 steps at 32 px cannot show learning; what
  it gates is that the whole chain runs.
- CAPABILITY_torch.json, the full preset on the card, is checked against
  those gates once it is committed.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

import pytest

from tests import test_capabilities as jax_gates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "run_capability_experiments_torch.py")
REPORT = os.path.join(REPO, "CAPABILITY_torch.json")


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return (_module("capability_torch", TOOL),
            _module("capability_jax", os.path.join(
                REPO, "tools", "run_capability_experiments.py")))


@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_presets_and_experiments_are_the_jax_tools(tools, preset):
    port, ref = tools
    assert port.PRESETS[preset] == ref.PRESETS[preset]
    assert port.experiment_table(port.PRESETS[preset]) == \
        ref.experiment_table(ref.PRESETS[preset])


def test_gates_are_the_jax_tools(tools):
    port, _ = tools
    limits = {
        "shadow_sun_corr_sc05": jax_gates.SUN_CORR_GATE,
        "shadow_sun_iou_sc05": jax_gates.SUN_IOU_GATE,
        "transient_satnerf_psnr_gain": jax_gates.TRANSIENT_PSNR_GAIN_GATE,
        "transient_beta_ratio": jax_gates.BETA_RATIO_GATE,
        "ba_noise_degrades_mae": jax_gates.BA_DEGRADE_GATE_M,
        "ba_ds_recovers_mae": jax_gates.BA_RECOVER_GATE_M,
        "solar_sweep_corr_extremes": jax_gates.SOLAR_SWEEP_CORR_MAX,
        "solar_sweep_shadow_iou_extremes": jax_gates.SOLAR_SWEEP_IOU_MAX,
        "solar_sweep_rel_std": jax_gates.SOLAR_SWEEP_REL_STD_MIN,
    }
    assert {k: v[1] for k, v in port.GATES.items()} == {
        "shadow_snerf_beats_nerf_psnr": True, **limits}
    # the JAX report's experiments give the JAX report's gates, and the
    # verdicts pass it as tests/test_capabilities.py does
    with open(jax_gates.REPORT) as f:
        ref = json.load(f)
    assert port.compute_gates(ref["experiments"]) == ref["gates"]
    verdicts = port.gate_verdicts(ref["gates"])
    assert set(verdicts) == set(port.GATES)
    assert all(v["met"] for v in verdicts.values())
    jax_gates._assert_gates(ref)


def test_smoke_transient_through_the_port(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "2"
    work = str(tmp_path / "cap")
    proc = subprocess.run(
        [sys.executable, TOOL, work, "--preset", "smoke", "--experiments",
         "transient", "--device", "cpu"],
        cwd=REPO, env=env, timeout=900, capture_output=True, text=True)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    with open(os.path.join(work, "capability_report.json")) as f:
        report = json.load(f)
    t = report["experiments"]["transient"]
    for run in ("snerf", "satnerf"):
        for k in ("psnr", "ssim", "mae"):
            assert math.isfinite(t[run]["val"][k]), (run, t[run])
        assert t[run]["steps_per_sec"] > 0 and t[run]["train_seconds"] > 0
    beta = t["satnerf"]["beta"]
    assert beta["beta_in_mask"] > 0 and beta["beta_off_mask"] > 0, beta
    assert math.isfinite(beta["ratio"]) and beta["ratio"] > 0, beta
    g = report["gates"]
    assert math.isfinite(g["transient_satnerf_psnr_gain"]), g
    assert math.isfinite(g["transient_beta_ratio"]), g
    assert set(report["gate_verdicts"]) == set(g)
    assert report["device"] == {"platform": "cpu"}


GATE_NAMES = ("shadow_snerf_beats_nerf_psnr", "shadow_sun_corr_sc05",
              "shadow_sun_iou_sc05", "transient_satnerf_psnr_gain",
              "transient_beta_ratio", "ba_noise_degrades_mae",
              "ba_ds_recovers_mae", "solar_sweep_corr_extremes",
              "solar_sweep_shadow_iou_extremes", "solar_sweep_rel_std")


@pytest.fixture(scope="module")
def report():
    with open(REPORT) as f:
        return json.load(f)


def test_committed_report_is_the_full_preset_on_the_card(tools, report):
    port, _ = tools
    assert report["preset"] == "full"
    assert report["config"] == port.PRESETS["full"]
    assert set(report["experiments"]) == {"shadow", "solar", "transient",
                                          "ba"}
    assert report["device"]["platform"] == "gpu"
    assert "H100" in report["device"]["kind"]
    assert report["device"]["nvidia_smi"][0].endswith(" W")
    for exp, runs in report["experiments"].items():
        for run, m in runs.items():
            assert m["train_seconds"] > 0 and m["steps_per_sec"] > 0, run
            for k in ("psnr", "ssim", "mae"):
                assert math.isfinite(m["val"][k]), (exp, run, k)
    assert "sweep" in report["experiments"]["solar"]["snerf_sc10"]
    assert port.compute_gates(report["experiments"]) == report["gates"]
    assert port.gate_verdicts(report["gates"]) == report["gate_verdicts"]
    assert set(report["gate_verdicts"]) == set(GATE_NAMES)


def _open_faults() -> str:
    """ROADMAP.md §3's open faults: from its "Open:" to its "Closed"."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    section = text[text.index("### 3. Faults found in the port"):]
    return section[section.index("Open:"):section.index("Closed")]


@pytest.mark.parametrize("gate", GATE_NAMES)
def test_committed_report_gate(report, gate):
    """Each gate of tests/test_capabilities.py is met by the port's report,
    as that file holds the JAX report to it, or stands in ROADMAP.md §3 as an
    open fault with the port's figure and the JAX report's."""
    value = report["gates"][gate]
    with open(jax_gates.REPORT) as f:
        ref = json.load(f)
    if report["gate_verdicts"][gate]["met"]:
        # the JAX gate function, given this gate alone to fail on
        jax_gates._assert_gates({"gates": {**ref["gates"], gate: value},
                                 "experiments": ref["experiments"]})
        return
    jax_value = ref["gates"][gate]
    faults = _open_faults()
    assert gate in faults, f"{gate} missed and not an open fault in ROADMAP §3"
    assert f"{value:.4f}" in faults and f"{jax_value:.4f}" in faults, (
        gate, value, jax_value)
