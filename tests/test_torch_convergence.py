"""tools/convergence_torch.py: convergence of the port seed by seed against
the JAX package's recorded runs (CONVERGENCE_r05.json).

On the CPU the tool runs at its smoke preset (the fixtures' 8 x 64 width, a
16 px AOI, four steps), both arms at one seed, so that its training, its
scoring, its report and its comparisons are exercised. The committed
report (CONVERGENCE-torch.json, from the card) is held the way
tests/test_torch_capabilities.py holds its own: the configuration is
CONVERGENCE_r05.json's, the card an H100, and each per-seed figure of each
arm lies within CONVERGED_BAND of JAX's (`ours`) or stands in ROADMAP.md §3
as an open fault with both figures.
"""

import importlib.util
import json
import math
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_convergence_parity import CONVERGED_BAND  # noqa: E402

REPORT = os.path.join(REPO, "CONVERGENCE-torch.json")
METRICS = ("psnr", "ssim", "mae")
ARMS = ("torch_init", "jax_init")


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "convergence_torch", os.path.join(REPO, "tools", "convergence_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_band_and_config_are_the_recorded_ones(tool):
    assert tool.CONVERGED_BAND == CONVERGED_BAND
    ref = tool.reference()
    assert {**tool.run_config("full"), "seed": ref["config"]["seed"]} == \
        ref["config"]
    aoi = tool.PRESETS["full"]["aoi"]
    assert ref["provenance"]["aoi"] == (
        f"tools/make_synthetic_aoi.py --size {aoi['size']} --n_train "
        f"{aoi['n_train']} --n_test {aoi['n_test']}")
    # smoke cuts the AOI, the batch, the samples and the steps, not the model
    smoke = tool.run_config("smoke")
    for k in ("model", "fc_units", "fc_layers", "lr", "sc_lambda"):
        assert smoke[k] == ref["config"][k], k


def test_smoke_run_on_the_cpu(tool, tmp_path):
    torch = pytest.importorskip("torch")
    torch.set_num_threads(2)
    report = tool.main([str(tmp_path), "--preset", "smoke", "--device", "cpu",
                        "--seeds", "1"])
    ref = tool.reference()
    assert report["seeds"] == [1] and set(report["arms"]) == set(ARMS)
    assert report["device"] == {"platform": "cpu"}
    assert report["band"] == CONVERGED_BAND
    (row,) = report["per_seed"]
    assert row["seed"] == 1
    for k in METRICS:
        assert row["ours"][k] == ref["ours"][k]["per_seed"][1]
        assert row["torch_reference"][k] == \
            ref["torch_reference"][k]["per_seed"][1]
    for arm in ARMS:
        run = report["runs"][arm]["1"]
        assert run["train_seconds"] > 0 and run["epoch"] >= 0
        for k in METRICS:
            assert math.isfinite(row[arm][k]), (arm, k)
            assert row[arm][k] == run["val"][k]
            d = row["diff_vs_ours"][arm][k]
            assert d == row[arm][k] - row["ours"][k]
            assert row["within_band"][arm][k] == (abs(d) <= CONVERGED_BAND[k])
    assert report["runs"]["torch_init"]["1"]["init_checkpoint"] is None
    assert report["runs"]["jax_init"]["1"]["init_checkpoint"] == \
        "tests/data/jax_init_sat-nerf_8x64_seed1.ckpt"
    # a second call scores nothing again: the runs are read back
    again = tool.main([str(tmp_path), "--preset", "smoke", "--device", "cpu",
                       "--seeds", "1"])
    assert again["per_seed"] == report["per_seed"]
    # from a directory of the preset's own, where a full run never reads them
    assert os.listdir(tmp_path) == ["smoke"]
    assert sorted(os.listdir(tmp_path / "smoke" / "metrics")) == \
        ["jax_init_seed1.json", "torch_init_seed1.json"]


def test_a_seed_without_a_jax_fixture_stops_the_tool(tool, tmp_path):
    with pytest.raises(FileNotFoundError, match="sat-nerf_8x64_seed3"):
        tool.main([str(tmp_path), "--preset", "smoke", "--device", "cpu",
                   "--seeds", "0", "3"])
    assert not os.listdir(tmp_path)  # nothing built, nothing trained


@pytest.fixture(scope="module")
def report():
    with open(REPORT) as f:
        return json.load(f)


def test_committed_report_is_the_recorded_config_on_the_card(tool, report):
    ref = tool.reference()
    assert report["preset"] == "full"
    assert report["config"] == ref["config"]
    assert report["seeds"] == [0, 1, 2] == ref["seeds"]
    assert report["band"] == CONVERGED_BAND
    assert report["device"]["platform"] == "gpu"
    assert "H100" in report["device"]["kind"]
    assert report["device"]["nvidia_smi"][0].endswith(" W")
    assert set(report["arms"]) == set(ARMS)
    runs = {arm: {int(s): r for s, r in by_seed.items()}
            for arm, by_seed in report["runs"].items()}
    for arm in ARMS:
        for s in (0, 1, 2):
            assert runs[arm][s]["train_seconds"] > 0, (arm, s)
            assert all(math.isfinite(runs[arm][s]["val"][k]) for k in METRICS)
        assert (runs[arm][0]["init_checkpoint"] is None) == (arm == "torch_init")
    assert tool.compare(runs, [0, 1, 2], ref) == report["per_seed"]


def _open_faults() -> str:
    """ROADMAP.md §3's open faults: from its "Open:" to its "Closed"."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    section = text[text.index("### 3. Faults found in the port"):]
    return section[section.index("Open:"):section.index("Closed")]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("metric", METRICS)
def test_committed_report_within_band_or_open_fault(report, seed, arm, metric):
    """Each per-seed figure of each arm lies within CONVERGED_BAND of the
    JAX package's (`ours` of CONVERGENCE_r05.json), or ROADMAP.md §3 lists
    it as an open fault with the port's figure and JAX's."""
    row = next(r for r in report["per_seed"] if r["seed"] == seed)
    if row["within_band"][arm][metric]:
        assert abs(row[arm][metric] - row["ours"][metric]) <= \
            CONVERGED_BAND[metric]
        return
    faults = _open_faults()
    port, jax = row[arm][metric], row["ours"][metric]
    assert f"{port:.2f}" in faults and f"{jax:.2f}" in faults, (
        f"seed {seed} {arm} {metric}: {port} against JAX's {jax} is outside "
        f"the band and not an open fault in ROADMAP §3")
