"""The port's bench (satnerf_tpu_torch/cli/bench.py) and its matrix
(tools/bench_matrix_torch.py) on the CPU, at sat-nerf / nerf 8 x 32, 16
samples, batch 64, 2 steps, chunk 64 (the bench's size constants set, no
knob added):

- every row of the matrix runs in this process and prints one JSON line
  with the root bench.py's keys and metric names, vs_baseline null;
- its flops_per_ray is the JAX package's flops_per_ray for the same
  arguments (MFLOP a ray, as bench.py), its mfu value x FLOPs / the H100's
  peak for the precision, and device_ms / idle null on the CPU;
- the matrix holds tools/bench_matrix.py's nine rows, names and overrides,
  plus train_default_b1024 at Config.batch_size, and writes that tool's
  schema (BENCH_MATRIX_r05.json), exiting nonzero when a row fails;
- BENCH_DEVICE=cuda on a host without a card raises and prints nothing.
"""

import ast
import importlib.util
import json
import os

import pytest
import torch

from satnerf_tpu.utils.flops import flops_per_ray as jax_flops_per_ray
from satnerf_tpu_torch.cli import bench as B
from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.utils.flops import H100_PEAK_BF16, H100_PEAK_F32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_MATRIX = _load("tools/bench_matrix.py", "jax_bench_matrix")
MATRIX = _load("tools/bench_matrix_torch.py", "bench_matrix_torch")


def _bench_py_lines() -> list:
    """The dicts the root bench.py prints: {key: value node}, read from its
    source (it imports jax inside main, so it is not run here)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    return [{k.value: v for k, v in zip(node.args[0].keys, node.args[0].values)}
            for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
            and node.args and isinstance(node.args[0], ast.Dict)]


BENCH_PY_KEYS = set(_bench_py_lines()[0])
BENCH_PY_METRICS = {line["metric"].value for line in _bench_py_lines()}


@pytest.fixture()
def small(monkeypatch):
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    for name, v in dict(FEAT=32, SAMPLES=16, N_RAYS=64, TRAIN_BATCH=64,
                        SERVE_BATCH=64, STEPS=2, CHUNK=64).items():
        monkeypatch.setattr(B, name, v)
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    return monkeypatch


def _run(monkeypatch, capsys, overrides: dict) -> dict:
    for k, v in overrides.items():
        monkeypatch.setenv(k, v)
    line = B.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    assert json.loads(out[0]) == line
    return line


@pytest.mark.parametrize("row", list(MATRIX.ROWS))
def test_every_row_prints_one_line_with_bench_keys(row, small, capsys):
    ov = MATRIX.ROWS[row]
    line = _run(small, capsys, ov)
    assert BENCH_PY_KEYS <= set(line), BENCH_PY_KEYS - set(line)
    assert line["metric"] in BENCH_PY_METRICS
    mode = ov.get("BENCH_MODE", "train")
    assert line["metric"] == f"{mode}_rays_per_sec_per_chip"
    assert line["unit"] == "rays/s" and line["vs_baseline"] is None
    assert line["value"] > 0 and line["cards"] == 1
    assert line["batch"] == 64
    assert line["steps"] == int(ov.get("BENCH_STEPS", 2))
    assert len(line["event_ms"]) == 3
    assert line["device_ms"] is None and line["idle"] is None
    model = ov.get("BENCH_MODEL", "sat-nerf")
    sc = float(ov.get("BENCH_SC", 0.0))
    nimp = int(ov.get("BENCH_NIMP", 0))
    fpr = jax_flops_per_ray(model, 8, 32, 16,
                            mode="train" if mode == "train" else "render",
                            sc=sc > 0 and mode == "train", n_importance=nimp)
    assert line["flops_per_ray"] == fpr / 1e6
    peak = H100_PEAK_BF16 if line["precision"] == "bfloat16" else H100_PEAK_F32
    assert line["mfu"] == pytest.approx(line["value"] * fpr / peak, rel=1e-12)


def test_the_matrix_holds_the_jax_rows():
    for name, ov in JAX_MATRIX.ROWS.items():
        assert MATRIX.ROWS[name] == ov, name
    assert set(MATRIX.ROWS) == set(JAX_MATRIX.ROWS) | {"train_default_b1024"}
    assert MATRIX.ROWS["train_default_b1024"] == {
        "BENCH_BATCH": str(Config().batch_size)}


def test_the_matrix_writes_the_jax_schema(small, capsys, tmp_path):
    """Rows through run_row (here the bench in this process), one failing:
    the file has BENCH_MATRIX_r05.json's keys and the tool exits 1."""
    def run_row(name, overrides, timeout_s):
        if name == "serve_nerf":
            raise RuntimeError("bench exit 1: a row that fails")
        with small.context() as m:
            for k, v in overrides.items():
                m.setenv(k, v)
            return {**B.main(), "wall_s": 0.5}

    small.setattr(MATRIX, "run_row", run_row)
    out = str(tmp_path / "m.json")
    assert MATRIX.main(["--out", out, "--rows",
                        "train_default,serve_rays,serve_nerf"]) == 1
    with open(out) as f:
        got = json.load(f)
    with open(os.path.join(REPO, "BENCH_MATRIX_r05.json")) as f:
        r05 = json.load(f)
    assert set(got) == set(r05)
    assert set(got["rows"]) == {"train_default", "serve_rays"}
    assert list(got["failed"]) == ["serve_nerf"]
    for row in got["rows"].values():
        assert set(r05["rows"]["train_default"]) <= set(row)
    assert got["env"] == {"BENCH_DEVICE": "cpu"}


def test_cuda_without_a_card_raises(small, capsys):
    assert not torch.cuda.is_available()
    small.setenv("BENCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.main()
    assert capsys.readouterr().out == ""
