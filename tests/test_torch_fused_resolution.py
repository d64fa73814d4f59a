"""`--fused` resolved at construction within what the kernels hold
(satnerf_tpu_torch/train/system.py resolve_fused_mode).

On a `cuda` device, which nothing here constructs anything on, for sat-nerf
and nerf at F = 512 and 1024 and every `--fused` value: at 512 the modes are
what the JAX system resolves; at 1024, wider than the heads' kernels hold,
`auto` resolves to "off" and says why on one printed line, and an explicit
`rays` or `on` raises ValueError in NeRFSystem.__init__ naming the limit and
`--fused off`. Then the samples a ray at and one past each per-ray limit
(composite_max_samples, sc_max_samples, nerf_composite_max_samples in both
dtypes). On the CPU the plain versions hold any size and nothing changes.

The card test trains one `cli.train` step at sat-nerf and nerf 8 x 1024 on
the plain path and checks the resolved mode in the run's log and a finite
loss.
"""

import json
import os

import pytest
import torch

from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.ops import fused_mlp as FM
from satnerf_tpu_torch.ops import fused_nerf as FN
from satnerf_tpu_torch.train.system import NeRFSystem, resolve_fused_mode

CUDA = torch.device("cuda")
FUSED = ("auto", "rays", "on", "off")
# the mode of each --fused value where the kernels hold the configuration
MODES = {"sat-nerf": {"auto": "rays", "rays": "rays", "on": "points",
                      "off": "off"},
         "nerf": {"auto": "points", "rays": "points", "on": "points",
                  "off": "off"}}


def _cfg(model, feat, fused, **kw):
    return Config(model=model, fc_units=feat, fc_layers=8, fused=fused, **kw)


@pytest.mark.parametrize("fused", FUSED)
@pytest.mark.parametrize("model", ["sat-nerf", "nerf"])
def test_width_512_resolves_as_before(model, fused, capsys):
    cfg = _cfg(model, 512, fused)
    assert resolve_fused_mode(cfg, CUDA) == (MODES[model][fused], None)
    system = NeRFSystem(cfg, device=CUDA)
    assert system.fused_mode == MODES[model][fused]
    assert system.fused_reason is None and cfg.fused == fused
    assert "resolves to off" not in capsys.readouterr().out
    # the CPU: auto is off, the explicit modes run the plain versions
    cpu = "off" if fused == "auto" else MODES[model][fused]
    assert resolve_fused_mode(cfg, "cpu") == (cpu, None)


@pytest.mark.parametrize("fused", FUSED)
@pytest.mark.parametrize("model", ["sat-nerf", "nerf"])
def test_width_1024_auto_is_off_and_explicit_modes_raise(model, fused, capsys):
    cfg = _cfg(model, 1024, fused)
    limit = (FN.NERF_HEADS_MAX_FEATURES if model == "nerf"
             else FM.HEADS_MAX_FEATURES)
    if fused in ("rays", "on"):
        with pytest.raises(ValueError, match=f"--fused {fused}: fc_units 1024 "
                           f"is wider than the {limit} features.*--fused off"):
            NeRFSystem(cfg, device=CUDA)
        # the plain versions on the CPU hold any width
        assert resolve_fused_mode(cfg, "cpu") == (MODES[model][fused], None)
        return
    system = NeRFSystem(cfg, device=CUDA)
    assert system.fused_mode == "off" and cfg.fused == fused
    out = capsys.readouterr().out
    if fused == "off":
        assert system.fused_reason is None and "resolves to off" not in out
        return
    assert f"fc_units 1024 is wider than the {limit} features" in \
        system.fused_reason
    lines = [ln for ln in out.splitlines() if "resolves to off" in ln]
    assert lines == [f"--fused auto resolves to off: {system.fused_reason}"]


def _samples_case(limit_of, model, feat, kw):
    """(resolved at the limit, reason one past it) for `auto` on the card."""
    fh = feat // 2
    limit = limit_of(feat, fh)
    at = resolve_fused_mode(_cfg(model, feat, "auto", **kw(limit)), CUDA)
    past = resolve_fused_mode(_cfg(model, feat, "auto", **kw(limit + 1)),
                              CUDA)
    return limit, at, past


@pytest.mark.parametrize("feat", [256, 512])
@pytest.mark.parametrize("split", ["coarse", "fine"])
def test_samples_past_composite_max_samples(feat, split):
    """The per-ray training kernels at the longest ray they get: the coarse
    samples, or those plus n_importance in the fine pass."""
    def kw(n):
        if split == "coarse":
            return dict(n_samples=n)
        return dict(n_samples=64, n_importance=n - 64)

    limit, at, past = _samples_case(
        lambda f, fh: FM.composite_max_samples(f, fh), "sat-nerf", feat, kw)
    assert at == ("rays", None)
    assert past[0] == "off"
    assert (f"{limit + 1} samples a ray" in past[1]
            and f"the {limit} composite_loss_bwd holds at fc_units {feat}"
            in past[1])
    with pytest.raises(ValueError, match="composite_max_samples"):
        NeRFSystem(_cfg("sat-nerf", feat, "rays", **kw(limit + 1)),
                   device=CUDA)
    # points mode (the point-mode field kernel) has no per-ray kernel
    assert resolve_fused_mode(_cfg("sat-nerf", feat, "on", **kw(limit + 1)),
                              CUDA) == ("points", None)


def test_samples_past_sc_max_samples(monkeypatch):
    """sc_loss_bwd's limit, with the compositor's lifted so that the solar
    correction's is the one that binds (it holds more samples a ray at every
    width)."""
    assert FM.sc_max_samples(512, 256) > FM.composite_max_samples(512, 256)
    monkeypatch.setattr(FM, "composite_max_samples", lambda f, fh: 10 ** 9)
    limit, at, past = _samples_case(
        FM.sc_max_samples, "sat-nerf", 512,
        lambda n: dict(n_samples=n, sc_lambda=0.1))
    assert at == ("rays", None) and past[0] == "off"
    assert f"the {limit} sc_loss_bwd holds" in past[1]
    assert "sc_max_samples" in past[1]
    # without the solar correction the kernel is not on the path
    assert resolve_fused_mode(_cfg("sat-nerf", 512, "auto",
                                   n_samples=limit + 1), CUDA) == ("rays", None)


@pytest.mark.parametrize("precision,dtype", [("auto", torch.bfloat16),
                                             ("float32", torch.float32)])
def test_samples_past_nerf_composite_max_samples(precision, dtype):
    """The nerf plain step (K7) at its limit in the run's dtype; with
    n_importance or depth supervision the step runs no per-ray kernel."""
    limit, at, past = _samples_case(
        lambda f, fh: FN.nerf_composite_max_samples(f, fh, dtype), "nerf", 256,
        lambda n: dict(n_samples=n, precision=precision))
    assert at == ("points", None) and past[0] == "off"
    assert f"n_samples {limit + 1} is more than the {limit} samples" in past[1]
    assert str(dtype) in past[1]
    for extra in (dict(n_importance=4), dict(ds_lambda=1000.0)):
        cfg = _cfg("nerf", 256, "on", n_samples=limit + 1, precision=precision,
                   **extra)
        assert resolve_fused_mode(cfg, CUDA) == ("points", None)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["sat-nerf", "nerf"])
def test_one_step_at_width_1024_on_the_card(tmp_path, model):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from satnerf_tpu_torch.cli import train as cli_train
    from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi

    data_dir, gt_dir = make_synthetic_aoi(str(tmp_path / "aoi"), size=16)
    out = cli_train.main([
        "--root_dir", data_dir, "--gt_dir", gt_dir, "--model", model,
        "--exp_name", "wide", "--fc_units", "1024", "--fc_layers", "8",
        "--n_samples", "64", "--batch_size", "1024", "--max_train_steps", "1",
        "--log_every_n_steps", "1", "--num_sanity_val_steps", "0",
        "--logs_dir", str(tmp_path / "logs"),
        "--ckpts_dir", str(tmp_path / "ckpts")])
    assert out["system"].fused_mode == "off"
    run = out["cfg"].exp_name  # stamped with the time
    with open(os.path.join(tmp_path, "logs", run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[0]["fused"] == "auto" and rows[0]["fused_mode"] == "off"
    assert "1024" in rows[0]["fused_reason"]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert losses and all(torch.isfinite(torch.tensor(losses)))
