"""Serving across the ranks of a host (ROADMAP M9), on the CPU: the port's
collective `render_image` over a 2-rank gloo group against the one-process
render and the JAX package's `render_image` over make_mesh(2) of the
virtual CPU devices, then validation in `fit` and every eval entry point on
two ranks.

Models: sat-nerf 4 x 32, 16 samples, without and with n_importance 8 (the
port in rays mode: the per-ray kernels' plain versions), and nerf 4 x 32
(points mode: K8's plain version), float32, the JAX package's initial
weights through params_from_jax. 500 rays in chunks of 77, which two ranks
round up to 78 (satnerf_tpu/train/system.py:871): the last chunk holds 32
rays and 46 rows of padding, so rank 1's block of it is padding alone.

- Both ranks return the same products, to the bit; they lie within 1e-6 of
  each product's largest entry from the one-process render (whether they
  are bit-equal is printed), and within ATOL 1e-4 of the JAX package's
  render (tests/test_torch_slice.py's tolerance; per-sample JAX products
  integrated against their weights where the port returns them per ray).
- The rows each rank renders of each chunk, padding included, are those the
  JAX package's shard_map hands each device of make_mesh(2).
- A world of one through SATNERF_COORDINATOR renders what no group does, to
  the bit.
- `fit` at n_devices 2 validates on both ranks (each renders half of every
  chunk); its logged metrics are a one-process validation of its checkpoint
  (within 1e-6 of each: the products are within 1e-6, not always bit-equal,
  on the CPU).
- `cli.eval`, `cli.create_dsm`, `cli.study_solar_interpolation` and
  tools/parity_report_torch.py on two ranks: rank 0 writes and prints what a
  one-process run writes and prints, rank 1 nothing.
- Where an entry point starts its own ranks (eval/loader.py
  `render_ranks`): opts.json's n_devices cut to the visible cards, one
  process on the CPU, and one card where a card alone renders the views
  sooner than the ranks would start; `cli.eval` with opts.json's n_devices
  2 renders in this one process and prints the scores of n_devices 1.

All the rank work shares one `spawn` of two ranks (tests/torch_dist_worker.py
`render_group`).
"""

import contextlib
import dataclasses
import io
import json
import os
import pickle
import socket
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from satnerf_tpu.config import Config as JaxConfig  # noqa: E402
from satnerf_tpu.parallel.mesh import make_mesh  # noqa: E402
from satnerf_tpu.train.system import NeRFSystem as JaxSystem  # noqa: E402
from satnerf_tpu_torch.config import Config  # noqa: E402
from satnerf_tpu_torch.parallel import distributed as D  # noqa: E402
from satnerf_tpu_torch.train.checkpoints import params_from_jax  # noqa: E402
from satnerf_tpu_torch.train.system import NeRFSystem  # noqa: E402
from tests import torch_dist_worker as W  # noqa: E402

torch.set_num_threads(1)

N_RAYS, CHUNK, ATOL, REL = 500, 77, 1e-4, 1e-6
BASE = dict(fc_layers=4, fc_units=32, n_samples=16, chunk=CHUNK,
            precision="float32")
CASES = {"sat-nerf": dict(model="sat-nerf"),
         "sat-nerf-hier": dict(model="sat-nerf", n_importance=8),
         "nerf": dict(model="nerf")}
# the port's serving path of each variant: the per-ray kernels (rays mode
# for sat-nerf; points mode for nerf, which serves through K8)
PORT_FUSED = {"sat-nerf": "rays", "nerf": "on"}
RUN_ID, EPOCHS, BATCH = "group", 2, 256


def _rays(seed=0):
    rng = np.random.RandomState(seed)
    rays = rng.rand(N_RAYS, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 8:11] /= np.linalg.norm(rays[:, 8:11], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    return rays, rng.randint(0, 5, N_RAYS).astype(np.int32)


def _port_kw(case):
    kw = {**BASE, **CASES[case]}
    return {**kw, "fused": PORT_FUSED[kw["model"]], "device": "cpu"}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_side():
    """Per case: the JAX config, params, the port's state_dict of them, the
    rays and ts the port renders, the JAX render over make_mesh(2), and the
    (device, rays, ts) each device was handed in each chunk."""
    mesh = make_mesh(2)
    rays, ts = _rays()
    out = {}
    for case, kw in CASES.items():
        jcfg = JaxConfig(**BASE, **kw, fused="off")
        jsys = JaxSystem(jcfg, dataset_len=jcfg.batch_size, mesh=mesh)
        assert jsys.eval_mesh.devices.size == 2
        jparams = jsys.init_params(jax.random.PRNGKey(0))
        params_np = jax.tree_util.tree_map(np.asarray,
                                           jax.device_get(jparams))
        state = params_from_jax(params_np, kw["model"], BASE["fc_layers"])
        t = ts if kw["model"] == "sat-nerf" else None
        seen = []
        render = jsys.render

        def recording(params, r, tt, key, train=False, render=render,
                      seen=seen):
            jax.debug.callback(
                lambda i, rr, t_: seen.append((int(i), np.asarray(rr),
                                               np.asarray(t_))),
                jax.lax.axis_index("data"), r,
                tt if tt is not None else jax.numpy.zeros(r.shape[0],
                                                          jax.numpy.int32))
            return render(params, r, tt, key, train=train)

        ref = jsys.render_image(jparams, rays, t)
        jsys.render = recording
        jsys._render_chunk = None  # trace again through the recording
        jsys.render_image(jparams, rays, t)
        out[case] = {"state": state, "rays": rays, "ts": t, "ref": ref,
                     "rows": seen}
    return out


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi

    root = tmp_path_factory.mktemp("aoi")
    return make_synthetic_aoi(str(root / "aoi"), size=16)


@pytest.fixture(scope="module")
def group(jax_side, aoi, tmp_path_factory):
    """The two ranks' results (tests/torch_dist_worker.py render_group)."""
    root = tmp_path_factory.mktemp("group")
    data_dir, gt_dir = aoi
    cfg = Config(root_dir=data_dir, gt_dir=gt_dir, model="sat-nerf",
                 fc_layers=4, fc_units=32, n_samples=16, batch_size=BATCH,
                 chunk=CHUNK, lr=1e-3, device="cpu", n_devices=2,
                 exp_name=RUN_ID, logs_dir=str(root / "logs"),
                 ckpts_dir=str(root / "ckpts"), num_sanity_val_steps=1,
                 log_every_n_steps=1, save_every_n_epochs=1)
    n_train_rays = _n_train_rays(cfg)
    steps = EPOCHS * (n_train_rays // BATCH)
    cfg = dataclasses.replace(cfg, max_train_steps=steps)
    ckpt = os.path.join(cfg.ckpts_dir, RUN_ID, f"epoch={EPOCHS}.ckpt")
    run = {"cfg": dataclasses.asdict(cfg), "id": RUN_ID,
           "logs": cfg.logs_dir, "ckpts": cfg.ckpts_dir, "epoch": EPOCHS,
           "parity_argv": ["--ckpt", ckpt, "--root_dir", data_dir,
                           "--gt_dir", gt_dir,
                           "--output_dir", str(root / "parity"),
                           "--device", "cpu",
                           "--opts", os.path.join(cfg.logs_dir, RUN_ID,
                                                  "opts.json")]}
    cases = {c: (_port_kw(c), j["state"], j["rays"], j["ts"])
             for c, j in jax_side.items()}
    D.spawn(W.render_group, (str(root), cases, run), 2)
    ranks = []
    for r in range(2):
        with open(root / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"root": root, "ranks": ranks, "cfg": cfg, "run": run}


def _n_train_rays(cfg):
    from satnerf_tpu_torch.data import load_dataset

    return len(load_dataset(cfg, split="train")[0])


def _one_process(case, rays, ts, state):
    system = NeRFSystem(Config(**_port_kw(case)), device="cpu")
    params = system.init_params()
    params.load_state_dict(state)
    return system, params, system.render_image(params, rays, ts)


def test_the_group_is_every_rank_of_the_host(group):
    for r, got in enumerate(group["ranks"]):
        assert (got["world"], got["render_world"], got["render_rank"]) == \
            (2, 2, r)


@pytest.mark.parametrize("case", CASES)
def test_ranks_return_the_same_products(group, case):
    a, b = (g[case]["out"] for g in group["ranks"])
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape[0] == N_RAYS, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_products_are_the_one_process_render(group, jax_side, case):
    j = jax_side[case]
    _, _, want = _one_process(case, j["rays"], j["ts"], j["state"])
    got = group["ranks"][0][case]["out"]
    assert got.keys() == want.keys()
    bit_equal = []
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        lim = REL * max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= lim, k
        bit_equal.append(np.array_equal(got[k], want[k]))
    print(f"{case}: two ranks bit-equal to one process on "
          f"{sum(bit_equal)} of {len(bit_equal)} products")


@pytest.mark.parametrize("case", CASES)
def test_products_match_the_jax_mesh_render(group, jax_side, case):
    got, ref = group["ranks"][1][case]["out"], jax_side[case]["ref"]
    passes = ("coarse", "fine") if "rgb_fine" in ref else ("coarse",)
    for p in passes:
        w = ref[f"weights_{p}"]
        assert got[f"weights_{p}"].shape == (N_RAYS, 1)
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(got[f"{k}_{p}"], ref[f"{k}_{p}"],
                                       atol=ATOL, err_msg=f"{k}_{p}")
        np.testing.assert_allclose(got[f"opacity_{p}"], w.sum(-1), atol=ATOL)
        for k in ("sun", "albedo", "sky", "beta"):
            if f"{k}_{p}" not in ref:
                continue
            np.testing.assert_allclose(
                got[f"{k}_{p}"][:, 0], (w[..., None] * ref[f"{k}_{p}"]).sum(-2),
                atol=ATOL, err_msg=f"{k}_{p}")


def _key(block):
    rays, ts = block
    return rays.tobytes() + (b"" if ts is None
                             else np.asarray(ts, np.int64).tobytes())


@pytest.mark.parametrize("case", CASES)
def test_rows_are_the_jax_mesh_rows(group, jax_side, case):
    """Each rank's (rays, ts) of each chunk, padding included, against what
    the JAX shard_map hands its device; ts only where the model takes them
    (the JAX chunk carries zeros in their place)."""
    sat = CASES[case]["model"] == "sat-nerf"
    n_chunks = -(-N_RAYS // (CHUNK + 1))
    for r in range(2):
        want = [(rays, ts if sat else None)
                for i, rays, ts in jax_side[case]["rows"] if i == r]
        got = group["ranks"][r][case]["rows"]
        assert len(got) == len(want) == n_chunks
        assert all(rays.shape == ((CHUNK + 1) // 2, 11) for rays, _ in got)
        assert sorted(map(_key, got)) == sorted(map(_key, want))
    last = group["ranks"][1][case]["rows"][-1][0]
    assert not last.any()  # rank 1's block of the last chunk is padding


@pytest.mark.parametrize("case", CASES)
def test_a_world_of_one_is_the_render_without_a_group(jax_side, case,
                                                      monkeypatch):
    j = jax_side[case]
    system, params, plain = _one_process(case, j["rays"], j["ts"], j["state"])
    for k, v in {"SATNERF_COORDINATOR": f"localhost:{_free_port()}",
                 "SATNERF_NUM_PROCS": "1", "SATNERF_PROC_ID": "0"}.items():
        monkeypatch.setenv(k, v)
    gathered = []
    gather = D.all_gather_rows
    monkeypatch.setattr(D, "all_gather_rows",
                        lambda p: (gathered.append(1), gather(p))[1])
    out = D.run_in_group(system.render_image, (params, j["rays"], j["ts"]),
                         1, "cpu")
    assert not D.is_distributed() and D.render_world() == 1
    assert not gathered
    assert out.keys() == plain.keys()
    for k in plain:
        np.testing.assert_array_equal(out[k], plain[k], err_msg=k)


def test_gather_outside_a_group_is_a_no_op():
    products = {"a": torch.ones(3, 2), "b": torch.zeros(3, dtype=torch.int64)}
    assert D.all_gather_rows(products) is products
    assert (D.render_world(), D.render_rank(), D.renders()) == (1, 0, True)


def _agree(got: dict, want: dict) -> None:
    """Scores of products within REL of each other: the same keys, each
    within REL of its value (on the CPU a block of a chunk runs the plain
    versions' matmuls at another row count, whose BLAS blocking may round
    otherwise)."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v) <= REL * max(abs(v), 1.0), (k, got[k], v)


def _val_rows(logs):
    with open(os.path.join(logs, RUN_ID, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "val/psnr" in r]


def test_fit_validates_on_both_ranks(group, tmp_path):
    from satnerf_tpu_torch.data import load_dataset
    from satnerf_tpu_torch.eval.loader import load_nerf
    from satnerf_tpu_torch.train.logging import RunLogger
    from satnerf_tpu_torch.train.loop import validate

    cfg = group["cfg"]
    r0, r1 = group["ranks"]
    # every render of validation split across both ranks: rank r renders
    # half of every chunk, rank 1 as often as rank 0
    assert r0["fit_rows"] and r0["fit_rows"] == r1["fit_rows"]
    assert set(r0["fit_rows"]) == {(CHUNK + 1) // 2}
    assert r1["fit_metrics"] == {} and r0["fit_metrics"]
    assert not os.path.exists(os.path.join(cfg.logs_dir, "rank1"))
    logged = _val_rows(cfg.logs_dir)[-1]
    assert logged["step"] == cfg.max_train_steps
    # a one-process validation of the checkpoint it saved
    system, params = load_nerf(RUN_ID, cfg.logs_dir, cfg.ckpts_dir, EPOCHS,
                               device="cpu")
    assert system.world == 1
    one = dataclasses.replace(cfg, logs_dir=str(tmp_path))
    logger = RunLogger(one.logs_dir, RUN_ID)
    want = validate(system, params, load_dataset(one, split="val")[0], one,
                    logger, cfg.max_train_steps, EPOCHS, save_images=False)
    logger.close()
    assert set(want) == {"val/psnr", "val/ssim", "val/mae"}
    _agree(r0["fit_metrics"], want)
    _agree({k: logged[k] for k in want}, want)


def _one_process_run(group, tmp_path):
    """The trained run's opts.json at n_devices 1, beside its checkpoints."""
    cfg = group["cfg"]
    logs = tmp_path / "logs1"
    os.makedirs(logs / RUN_ID)
    with open(os.path.join(cfg.logs_dir, RUN_ID, "opts.json")) as f:
        opts = json.load(f)
    assert opts["n_devices"] == 2
    with open(logs / RUN_ID / "opts.json", "w") as f:
        json.dump({**opts, "n_devices": 1}, f)
    return str(logs)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_entry_points_write_on_rank_zero_alone(group, tmp_path):
    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.cli.eval import eval_aoi
    from satnerf_tpu_torch.cli.study_solar_interpolation import sun_interp

    root, cfg = group["root"], group["cfg"]
    r0, r1 = group["ranks"]
    assert not os.path.exists(root / "rank1")
    with open(root / "stdout1.txt") as f:
        assert f.read() == ""
    assert r1["eval"] is None and r1["dsm"] is None and r1["parity"] is None

    logs1 = _one_process_run(group, tmp_path)
    one = tmp_path / "one"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        kw = dict(checkpoints_dir=cfg.ckpts_dir, device="cpu")
        scores = eval_aoi(RUN_ID, logs1, str(one / "eval"), EPOCHS, **kw)
        mae = create_pretty_dsm(RUN_ID, logs1, str(one / "dsm"), EPOCHS, **kw)
        sun_interp(RUN_ID, logs1, str(one / "solar"), EPOCHS, n_interp=2,
                   **kw)
    _agree(r0["eval"], scores)
    _agree({"mae": r0["dsm"]}, {"mae": mae})
    for sub in ("eval", "dsm", "solar"):
        assert _files(root / "rank0" / sub) == _files(one / sub), sub
    with open(root / "stdout0.txt") as f:
        printed = f.read()
    # the parity tool's lines follow the three entry points'
    assert printed.startswith(out.getvalue().replace(
        str(one), str(root / "rank0")))
    assert set(r0["parity"]["ours"]) == {"psnr", "ssim", "mae"}
    _agree(r0["parity"]["ours"], scores)
    assert os.path.exists(root / "parity" / "parity_report.json")


def test_eval_beyond_the_visible_devices_renders_in_one_process(
        group, tmp_path, capsys, monkeypatch):
    """cli.eval of a run whose opts.json asks for 2 devices, on the CPU's
    one: this process renders alone and prints the scores of n_devices 1."""
    from satnerf_tpu_torch.cli.eval import main

    def no_spawn(*args):
        raise AssertionError("spawned ranks")

    monkeypatch.setattr(D, "spawn", no_spawn)
    cfg = group["cfg"]
    argv = ["eval_aoi", "--run_id", RUN_ID, "--epoch_number", str(EPOCHS),
            "--checkpoints_dir", cfg.ckpts_dir, "--device", "cpu"]
    lines = {}
    for n, logs in ((2, cfg.logs_dir), (1, _one_process_run(group, tmp_path))):
        monkeypatch.setattr(sys, "argv", [
            "eval", *argv, "--logs_dir", logs,
            "--output_dir", str(tmp_path / f"out{n}")])
        main()
        lines[n] = [ln for ln in capsys.readouterr().out.splitlines()
                    if not ln.startswith("loading checkpoint")]
    assert lines[2] == lines[1] and any("Mean PSNR" in ln for ln in lines[1])
    assert _files(tmp_path / "out2") == _files(tmp_path / "out1")


# (device type, visible cards, opts.json's n_devices, rays) -> ranks
HUGE, VIEW = 10 ** 9, 128 * 128
RANKS = {"cpu": ("cpu", 4, 4, HUGE, 1),
         "cut_to_one_visible": ("cuda", 1, 4, HUGE, 1),
         "cut_to_two_visible": ("cuda", 2, 4, HUGE, 2),
         "every_visible": ("cuda", 4, 0, HUGE, 4),
         "asked_for_one": ("cuda", 4, 1, HUGE, 1),
         "small_view": ("cuda", 4, 0, VIEW, 1)}


@pytest.mark.parametrize("case", RANKS)
def test_render_ranks(case, monkeypatch):
    from satnerf_tpu_torch.eval.loader import render_ranks

    device_type, visible, n_devices, rays, want = RANKS[case]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    cfg = Config(model="sat-nerf", fc_layers=8, fc_units=512, n_samples=64,
                 n_devices=n_devices)
    assert render_ranks(cfg, rays, device_type) == want


def test_render_ranks_repay_their_start(monkeypatch):
    """On four cards the ranks start where a card alone would render for
    longer than RANKS_COST_S / (1 - 1/4), at the serving rate."""
    from satnerf_tpu_torch.eval import loader as L

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = Config(model="sat-nerf", fc_layers=8, fc_units=512, n_samples=64,
                 n_devices=4)
    per_ray_s = 2 * 64 * 8 * 512 ** 2 / L.CARD_FIELD_FLOPS
    edge = L.RANKS_COST_S / (1 - 1 / 4) / per_ray_s
    assert L.render_ranks(cfg, int(edge * 0.99), "cuda") == 1
    assert L.render_ranks(cfg, int(edge * 1.01), "cuda") == 4
