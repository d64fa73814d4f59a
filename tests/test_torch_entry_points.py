"""The port's remaining entry points against the JAX package's, on the same
inputs: satnerf_tpu_torch/cli/study_depth_supervision.py,
dsm_diagnostics.py, eval_s2p.py and create_satellite_dataset.py beside
study_depth_supervision.py, tools/dsm_diagnostics.py, eval_s2p.py and
create_satellite_dataset.py, and run_all_torch.sh beside run_all.sh.

Each pair runs on one small synthetic AOI (satnerf_tpu_torch.data.synthetic,
the same bytes as tools/make_synthetic_aoi.py) and what the two write is
compared: GeoTIFFs within 1e-9 of each other (the same float64 host
arithmetic), printed reports and metadata jsons equal. s2p stays an
external binary, stubbed as tests/test_s2p_tools.py does; bundle_adjust
stays a lazy import that both refuse by name when it is absent.
"""

import contextlib
import glob
import importlib
import importlib.util
import io
import json
import os
import random
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from satnerf_tpu_torch.cli import create_satellite_dataset as t_csd  # noqa: E402
from satnerf_tpu_torch.cli import dsm_diagnostics as t_diag  # noqa: E402
from satnerf_tpu_torch.cli import eval_s2p as t_s2p  # noqa: E402
from satnerf_tpu_torch.cli import study_depth_supervision as t_study  # noqa: E402
from satnerf_tpu_torch.config import Config  # noqa: E402
from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi  # noqa: E402
from satnerf_tpu_torch.geo.geotiff import read_geotiff, write_geotiff  # noqa: E402

j_csd = importlib.import_module("create_satellite_dataset")
j_s2p = importlib.import_module("eval_s2p")
j_study = importlib.import_module("study_depth_supervision")
_spec = importlib.util.spec_from_file_location(
    "jax_dsm_diagnostics", os.path.join(REPO, "tools", "dsm_diagnostics.py"))
j_diag = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(j_diag)


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    """A 24 px AOI of 3 train and 1 test views with 60 tie points."""
    root = str(tmp_path_factory.mktemp("aoi"))
    data, gt = make_synthetic_aoi(root, size=24, terrain="smooth", n_train=3,
                                  n_test=1, with_keypoints=True, n_kp=60)
    return {"root": root, "data": data, "gt": gt}


def _tifs_equal(a: str, b: str):
    x, y = read_geotiff(a), read_geotiff(b)
    assert x.data.shape == y.data.shape, (a, b)
    np.testing.assert_allclose(x.data, y.data, atol=1e-9, equal_nan=True,
                               err_msg=b)
    assert x.profile.transform == y.profile.transform, (a, b)


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


# ---------------------------------------------------------- depth study


def test_study_depth_supervision_writes_what_jax_writes(aoi, tmp_path):
    logs = str(tmp_path / "logs")
    Config(root_dir=aoi["data"], gt_dir=aoi["gt"], model="sat-nerf",
           exp_name="ds_study", logs_dir=logs).dump()
    j_study.check_depth_supervision_points("ds_study", logs,
                                           str(tmp_path / "jax"))
    t_study.check_depth_supervision_points("ds_study", logs,
                                           str(tmp_path / "port"))
    jax_tifs = sorted(glob.glob(str(tmp_path / "jax" / "ds_study" / "*.tif")))
    port_tifs = sorted(glob.glob(str(tmp_path / "port" / "ds_study" /
                                     "*.tif")))
    assert len(jax_tifs) == 3  # one per train view
    assert [os.path.basename(p) for p in port_tifs] == \
        [os.path.basename(p) for p in jax_tifs]
    for a, b in zip(jax_tifs, port_tifs):
        _tifs_equal(a, b)
        assert np.isfinite(read_geotiff(b).data).any()


# ------------------------------------------------------ DSM diagnostics


def test_dsm_oracle_and_errstruct_match_jax(aoi, tmp_path):
    kw = dict(root_dir=aoi["data"], gt_dir=aoi["gt"], cache_dir=None,
              split="val", idx=0, samples=64)
    _, j_out = _printed(j_diag.cmd_oracle,
                        Namespace(**kw, out_dir=str(tmp_path / "jax")))
    mae, t_out = _printed(t_diag.main, [
        "oracle", "--root_dir", aoi["data"], "--gt_dir", aoi["gt"],
        "--samples", "64", "--out_dir", str(tmp_path / "port")])
    assert t_out == j_out and "oracle chain floor" in t_out
    assert np.isfinite(mae) and f"MAE {mae:.4f} m" in t_out
    oracle = str(tmp_path / "port" / "dsm" / "oracle.tif")
    _tifs_equal(str(tmp_path / "jax" / "dsm" / "oracle.tif"), oracle)

    gt = os.path.join(aoi["gt"], "SYN_000_DSM.tif")
    _, j_out = _printed(j_diag.cmd_errstruct, Namespace(pred=oracle, gt=gt))
    _, t_out = _printed(t_diag.main, ["errstruct", "--pred", oracle,
                                      "--gt", gt])
    assert t_out == j_out and "raw MAE" in t_out and "per-px" in t_out


def test_dsm_oracle_needs_an_output_directory(aoi, capsys):
    """The oracle writes only where it is told: no fixed default path."""
    with pytest.raises(SystemExit):
        t_diag.main(["oracle", "--root_dir", aoi["data"], "--gt_dir",
                     aoi["gt"]])
    assert "--out_dir" in capsys.readouterr().err


# -------------------------------------------------------------- eval_s2p


def test_s2p_helpers_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    e = rng.uniform(4.36e5, 4.37e5, 20)
    n = rng.uniform(3.357e6, 3.358e6, 20)
    for a, b in zip(j_s2p.lonlat_from_utm(e, n, 17),
                    t_s2p.lonlat_from_utm(e, n, 17)):
        np.testing.assert_array_equal(a, b)
    xyz = np.column_stack([rng.uniform(0, 10, 500), rng.uniform(0, 10, 500),
                           rng.normal(5, 2, 500)])
    for mode in ("med", "avg", "min", "max"):
        np.testing.assert_array_equal(
            j_s2p.project_cloud_into_utm_grid(xyz, [0, 10, 0, 10], 0.5, mode),
            t_s2p.project_cloud_into_utm_grid(xyz, [0, 10, 0, 10], 0.5, mode))
    ply = str(tmp_path / "c.ply")
    with open(ply, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 500\nproperty float x\n"
                "property float y\nproperty float z\nend_header\n")
        np.savetxt(f, xyz, fmt="%.4f")
    np.testing.assert_array_equal(j_s2p.read_ply_xyz(ply),
                                  t_s2p.read_ply_xyz(ply))
    for i in range(5):
        with open(tmp_path / f"im{i}.json", "w") as f:
            json.dump({"img": f"im{i}.tif"}, f)
    random.seed(3)
    want = j_s2p.select_pairs(str(tmp_path), n_pairs=4)
    random.seed(3)
    assert t_s2p.select_pairs(str(tmp_path), n_pairs=4) == want


def _fake_dfc(aoi, tmp_path, aoi_id):
    """DFC2019's layout around the AOI: Track3-Truth holds its GT DSM and
    ROI file, Track3-RGB/{aoi_id} its images, each with its RPC beside it
    (the first also with NITF sun tags)."""
    dfc = tmp_path / "dfc"
    truth, img_dir = dfc / "Track3-Truth", dfc / "Track3-RGB" / aoi_id
    truth.mkdir(parents=True)
    img_dir.mkdir(parents=True)
    for ext in ("tif", "txt"):
        with open(os.path.join(aoi["gt"], f"SYN_000_DSM.{ext}"), "rb") as f:
            (truth / f"{aoi_id}_DSM.{ext}").write_bytes(f.read())
    for i, js in enumerate(sorted(glob.glob(os.path.join(aoi["data"],
                                                         "*.json")))):
        with open(js) as f:
            d = json.load(f)
        name = f"{aoi_id}_{i:03d}_RGB"
        g = read_geotiff(os.path.join(aoi["data"], d["img"]))
        tags = ({"NITF_USE00A_SUN_EL": "52.4", "NITF_USE00A_SUN_AZ": "141.1"}
                if i == 0 else None)
        write_geotiff(str(img_dir / f"{name}.tif"), g.data, tags=tags)
        with open(img_dir / f"{name}.rpc.json", "w") as f:
            json.dump(d["rpc"], f)
    return str(dfc), str(img_dir)


def test_eval_s2p_with_a_stub_binary_matches_jax(aoi, tmp_path, monkeypatch):
    aoi_id = "JAX_999"
    dfc, img_dir = _fake_dfc(aoi, tmp_path, aoi_id)
    root = tmp_path / "root"
    root.mkdir()
    for p in sorted(glob.glob(os.path.join(img_dir, "*.tif"))):
        name = os.path.splitext(os.path.basename(p))[0]
        with open(root / f"{name}.json", "w") as f:
            json.dump({"img": f"{name}.tif", "width": 24, "height": 24,
                       "rpc": {"row_offset": 0.0}}, f)
    # the stub drops the GT surface's points as each pair's cloud
    g = read_geotiff(os.path.join(dfc, "Track3-Truth", f"{aoi_id}_DSM.tif"))
    t = g.profile.transform
    yy, xx = np.mgrid[0:g.data.shape[1], 0:g.data.shape[2]]
    pts = np.column_stack([t.c + t.a * (xx.ravel() + 0.5),
                           t.f + t.e * (yy.ravel() + 0.5),
                           g.data[0].ravel()])
    np.save(tmp_path / "pts.npy", pts[np.isfinite(pts[:, 2])])
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "s2p"
    stub.write_text(f"""#!{sys.executable}
import json, os, sys
import numpy as np
cfg = sys.argv[1]
with open(cfg) as f:
    json.load(f)
d = os.path.join(os.path.dirname(cfg), "tiles", "row0", "col0")
os.makedirs(d, exist_ok=True)
pts = np.load({str(tmp_path / "pts.npy")!r})
with open(os.path.join(d, "cloud.ply"), "w") as f:
    f.write("ply\\nformat ascii 1.0\\nelement vertex %d\\n" % len(pts))
    f.write("property float x\\nproperty float y\\nproperty float z\\n")
    f.write("end_header\\n")
    np.savetxt(f, pts, fmt="%.3f")
""")
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ["PATH"])
    assert subprocess.run(["which", "s2p"], capture_output=True,
                          text=True).stdout.strip() == str(stub)

    out = {}
    for name, mod in (("jax", j_s2p), ("port", t_s2p)):
        random.seed(0)
        out[name] = mod.eval_s2p(aoi_id, str(root), dfc,
                                 output_dir=str(tmp_path / name), n_pairs=2,
                                 resolution=0.5)
    j, p = out["jax"], out["port"]
    assert p["n_clouds"] == j["n_clouds"] == 2
    assert p["mae_avg"] == j["mae_avg"] and p["mae_med"] == j["mae_med"]
    assert np.isfinite(p["mae_avg"]) and np.isfinite(p["mae_med"])
    _tifs_equal(j["dsm_avg"], p["dsm_avg"])
    _tifs_equal(j["dsm_med"], p["dsm_med"])
    cfgs = [sorted(glob.glob(str(tmp_path / n / "s2p_dsms" / aoi_id / "*" /
                                 "config.json"))) for n in ("jax", "port")]
    assert len(cfgs[0]) == 2
    for a, b in zip(*cfgs):
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb)


# ---------------------------------------------- create_satellite_dataset


def test_create_satellite_dataset_writes_what_jax_writes(aoi, tmp_path):
    aoi_id = "JAX_998"
    dfc, _ = _fake_dfc(aoi, tmp_path, aoi_id)
    outs = {}
    for name, mod in (("jax", j_csd), ("port", t_csd)):
        outs[name] = str(tmp_path / name)
        _printed(mod.create_satellite_dataset, aoi_id, dfc, outs[name],
                 ba=False, splits=True)
    jsons = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(outs["jax"], "*.json")))
    assert len(jsons) == 4
    for js in jsons:
        with open(os.path.join(outs["jax"], js)) as a, \
                open(os.path.join(outs["port"], js)) as b:
            assert json.load(a) == json.load(b), js
    with open(os.path.join(outs["port"], jsons[0])) as f:
        assert json.load(f)["sun_metadata_source"] == "image_tags"
    # the split is drawn afresh on each side: the same sizes, every view once
    for name in outs:
        split = {}
        for part in ("train", "test"):
            with open(os.path.join(outs[name], f"{part}.txt")) as f:
                split[part] = f.read().split("\n")
        assert sorted(split["train"] + split["test"]) == jsons
        assert len(split["test"]) == 2
    for mod in (j_csd, t_csd):
        assert mod._read_rpc_file is not None
        with pytest.raises(ImportError, match="bundle_adjust is not installed"):
            mod.create_satellite_dataset(aoi_id, dfc, str(tmp_path / "ba"))


def test_create_satellite_dataset_helpers_match_jax(aoi, tmp_path):
    ids = [f"v{i}.json" for i in range(20)]
    assert t_csd.create_train_test_splits(ids, seed=4) == \
        j_csd.create_train_test_splits(ids, seed=4)
    rpc_file = tmp_path / "a.rpc_adj"
    lines = [f"{k}: {v}" for k, v in (("LINE_OFF", 12.5), ("SAMP_OFF", 3.0),
                                      ("LAT_OFF", 30.35), ("LONG_OFF", -81.66),
                                      ("HEIGHT_OFF", 10.0))]
    lines += [f"LINE_NUM_COEFF_{i + 1}: {0.01 * i}" for i in range(20)]
    rpc_file.write_text("\n".join(lines) + "\n")
    assert t_csd._read_rpc_file(str(rpc_file)) == \
        j_csd._read_rpc_file(str(rpc_file))
    with open(os.path.join(aoi["data"], "SYN_000_000_RGB.json")) as f:
        d = json.load(f)
    src = os.path.join(aoi["data"], d["img"])
    lon0, lat0 = d["rpc"]["lon_offset"], d["rpc"]["lat_offset"]
    box = {"coordinates": [[[lon0 - 4e-4, lat0 - 4e-4],
                            [lon0 + 4e-4, lat0 - 4e-4],
                            [lon0 + 4e-4, lat0 + 4e-4],
                            [lon0 - 4e-4, lat0 + 4e-4]]]}
    for name, mod in (("jax", j_csd), ("port", t_csd)):
        mod.crop_geotiff_lonlat_aoi(src, str(tmp_path / f"{name}.tif"), box,
                                    d["rpc"])
    _tifs_equal(str(tmp_path / "jax.tif"), str(tmp_path / "port.tif"))
    with open(tmp_path / "jax.rpc.json") as a, \
            open(tmp_path / "port.rpc.json") as b:
        assert json.load(a) == json.load(b)


# ------------------------------------------------------- run_all_torch.sh


def test_run_all_torch_is_run_all_through_the_port(tmp_path):
    """The same seven runs with the same flags, each through
    `python -m satnerf_tpu_torch.cli.train` in place of train.py: a stub
    `python` on PATH records each command line of both scripts."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "calls.txt"
    (bindir / "python").write_text(f"#!/bin/sh\necho \"$@\" >> {log}\n")
    (bindir / "python").chmod(0o755)
    root = tmp_path / "root"
    (tmp_path / "root_noba").mkdir(parents=True)
    env = {**os.environ, "PATH": f"{bindir}{os.pathsep}{os.environ['PATH']}"}
    calls = {}
    for script in ("run_all.sh", "run_all_torch.sh"):
        log.write_text("")
        subprocess.run(["bash", os.path.join(REPO, script), "JAX_068",
                        str(root), "IMG", "GT", "CACHE", "--fc_layers", "4"],
                       env=env, check=True, capture_output=True)
        calls[script] = log.read_text().splitlines()
    assert len(calls["run_all.sh"]) == 7
    assert all(c.startswith("-m satnerf_tpu_torch.cli.train ")
               for c in calls["run_all_torch.sh"])
    assert [" ".join(c.split()[2:]) for c in calls["run_all_torch.sh"]] == \
        [" ".join(c.split()[1:]) for c in calls["run_all.sh"]]
    assert all("--fc_layers 4" in c for c in calls["run_all_torch.sh"])
