#!/usr/bin/env python
"""The classic multi-view-stereo baseline on the PyTorch port: eval_s2p.py
over the port's own geo/, ops/ and eval/ modules (no model, no device).
It picks stereo pairs, runs s2p on each pair as a subprocess, fuses the
pairwise point clouds into mean- and median-altitude DSMs on the lidar ROI
grid, and scores both against the GT.

  python -m satnerf_tpu_torch.cli.eval_s2p --aoi_id JAX_068 \
      --root_dir ROOT --dfc_dir DFC [--output_dir .] [--n_pairs 1] \
      [--resolution 0.5] [--crops] [--pan_dir ...] \
      [--heuristic_pairs_file ...]

s2p itself is an external C++/C stereo pipeline the reference also shells out
to (eval_s2p.py:145); this wrapper keeps that contract. All the geo plumbing
around it (UTM windows, fusion, registration, MAE) is in-house.

Both of the reference's stereo-source variants are supported:

- the RGB crop path (default), reading `{dfc_dir}/Track3-RGB[-crops]/{aoi}`;
- the PAN-band path (reference eval_s2p.py:100-114): `--pan_dir` swaps each
  pair's images for the full-resolution panchromatic frames, renaming
  `...RGB...tif -> ...PAN...tif`. The flag takes either a local directory or
  a GDAL-style remote prefix (`/vsicurl/http...`, `http...`) — the reference
  hardcodes the DFC2019 bucket (`/vsicurl/http://138.231.80.166:2332/
  grss-2019/track_3/Track3-MSI-{1,3}/`); pass it here explicitly. Remote
  prefixes skip the local existence check, exactly as the reference does.

Pair selection is random (`select_pairs`, reference eval_s2p.py:66-91) or
driven by a heuristic-pairs file (`--heuristic_pairs_file`, reference
eval_s2p.py:147-173): each line names two MSI products, matched to the RGB
crops through the NITF_IID2 tag embedded in each GeoTIFF.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import shutil
import subprocess

import numpy as np


def lonlat_from_utm(easts, norths, zone_number: int, northern: bool = True):
    """Inverse UTM via Newton iteration on our forward transverse Mercator
    (replaces pyproj at reference eval_s2p.py:37-44)."""
    from satnerf_tpu_torch.geo.utm import utm_from_latlon

    easts = np.atleast_1d(np.asarray(easts, np.float64))
    norths = np.atleast_1d(np.asarray(norths, np.float64))
    lon0 = (zone_number - 1) * 6.0 - 180.0 + 3.0
    lat = np.full_like(easts, 0.0 if northern else -10.0)
    lon = np.full_like(easts, lon0)
    for _ in range(50):
        e, n = utm_from_latlon(lat, lon, zone_number=zone_number)
        de, dn = easts - e, norths - n
        if np.max(np.abs(de)) < 1e-6 and np.max(np.abs(dn)) < 1e-6:
            break
        # local scale: ~111320 m/deg lat, scaled by cos(lat) for lon
        lat = lat + dn / 111132.0
        lon = lon + de / (111320.0 * np.cos(np.deg2rad(lat)))
    return lon, lat


def geojson_polygon(coords_array: np.ndarray) -> dict:
    pp = coords_array.tolist()
    x_c, y_c = coords_array[:, 0].mean(), coords_array[:, 1].mean()
    pp.sort(key=lambda p: np.arctan2(p[0] - x_c, p[1] - y_c))
    return {"coordinates": [pp], "type": "Polygon", "center": [x_c, y_c]}


def read_DFC2019_lonlat_aoi(aoi_id: str, dfc_dir: str) -> dict:
    if aoi_id[:3] != "JAX":
        raise ValueError(f"AOI not valid. Expected JAX_(3digits) but received {aoi_id}")
    roi = np.loadtxt(os.path.join(dfc_dir, "Track3-Truth", aoi_id + "_DSM.txt"))
    xoff, yoff, size, resolution = roi[0], roi[1], int(roi[2]), roi[3]
    ulx, uly = xoff, yoff + size * resolution
    lrx, lry = xoff + size * resolution, yoff
    easts = [ulx, ulx, lrx, lrx, ulx]
    norths = [lry, uly, uly, lry, lry]
    lons, lats = lonlat_from_utm(easts, norths, 17)
    return geojson_polygon(np.vstack((lons, lats)).T)


def select_pairs(root_dir: str, n_pairs: int = 1):
    json_paths = glob.glob(os.path.join(root_dir, "*.json"))
    n = len(json_paths)
    remaining = [(i, j) for i in range(n) for j in range(i + 1, n)]
    selected = []
    for _ in range(min(n_pairs, len(remaining))):
        pair = random.choice(remaining)
        remaining.remove(pair)
        selected.append((json_paths[pair[0]], json_paths[pair[1]]))
    return selected, n * (n - 1) // 2


def load_heuristic_pairs(root_dir: str, img_dir: str,
                         heuristic_pairs_file: str, n_pairs: int = 1):
    """Pair selection from a heuristic ranking file (eval_s2p.py:147-173).

    Each line of the file references two MSI products; an MSI id is the
    basename's leading `-`-separated token. Crops are matched to MSI ids
    through the NITF_IID2 tag embedded in each RGB GeoTIFF (the reference
    reads it via rasterio `tags()`; here via our own GDAL-metadata parser).
    """
    from satnerf_tpu_torch.geo.geotiff import read_geotiff

    msi_id_to_rgb_id = {}
    for p in sorted(glob.glob(os.path.join(img_dir, "*.tif"))):
        tags = getattr(read_geotiff(p), "tags", None) or {}
        iid2 = tags.get("NITF_IID2")
        if iid2:
            msi_id_to_rgb_id[iid2.split("-")[0]] = \
                os.path.splitext(os.path.basename(p))[0]

    selected = []
    with open(heuristic_pairs_file) as f:
        lines = [l for l in f.read().split("\n") if l.strip()]
    for line in lines:
        tok = line.split(" ")
        ml = os.path.basename(tok[0]).split("-")[0]
        mr = os.path.basename(tok[1]).split("-")[0]
        if ml in msi_id_to_rgb_id and mr in msi_id_to_rgb_id:
            selected.append(
                (os.path.join(root_dir, f"{msi_id_to_rgb_id[ml]}.json"),
                 os.path.join(root_dir, f"{msi_id_to_rgb_id[mr]}.json")))
        if len(selected) >= n_pairs:
            break
    return selected


def _is_remote(prefix: str) -> bool:
    return prefix.startswith(("/vsicurl", "http://", "https://"))


def _pan_image_path(pan_dir: str, rgb_name: str) -> str:
    """RGB crop filename -> panchromatic source path (eval_s2p.py:103-112)."""
    pan_name = os.path.basename(rgb_name).replace("RGB", "PAN")
    if _is_remote(pan_dir):
        return pan_dir.rstrip("/") + "/" + pan_name
    return os.path.join(pan_dir, pan_name)


def run_s2p(json_path_l: str, json_path_r: str, img_dir: str, out_dir: str,
            resolution: float, prefix: str = "", aoi=None,
            pan_dir: str | None = None):
    data = []
    for p in (json_path_l, json_path_r):
        with open(p) as f:
            data.append(json.load(f))
    if pan_dir:
        img_paths = [_pan_image_path(pan_dir, d["img"]) for d in data]
        if not _is_remote(pan_dir):
            for ip in img_paths:
                if not os.path.exists(ip):
                    raise FileNotFoundError(f"Could not find {ip}")
    else:
        img_paths = [os.path.join(img_dir, d["img"]) for d in data]
    config = {
        "images": [
            {"img": img_paths[0], "rpc": data[0]["rpc"]},
            {"img": img_paths[1], "rpc": data[1]["rpc"]},
        ],
        "out_dir": ".",
        "dsm_resolution": resolution,
        "rectification_method": "sift",
        "matching_algorithm": "mgm_multi",
    }
    if aoi is None:
        config["roi"] = {"x": 0, "y": 0, "w": data[0]["width"], "h": data[0]["height"]}
    else:
        config["roi_geojson"] = aoi

    img_id_l = os.path.splitext(os.path.basename(json_path_l))[0]
    img_id_r = os.path.splitext(os.path.basename(json_path_r))[0]
    s2p_out_dir = os.path.join(out_dir, f"{prefix}{img_id_l}_{img_id_r}")
    os.makedirs(s2p_out_dir, exist_ok=True)
    config_path = os.path.join(s2p_out_dir, "config.json")
    with open(config_path, "w") as f:
        json.dump(config, f, indent=2)

    log_file = os.path.join(s2p_out_dir, "log.txt")
    if not os.path.exists(os.path.join(s2p_out_dir, "dsm.tif")):
        with open(log_file, "w") as outfile:
            subprocess.run(["s2p", config_path], stdout=outfile, stderr=outfile)


def read_ply_xyz(path: str) -> np.ndarray:
    """Minimal PLY reader (ascii or binary_little_endian) -> (N, 3) xyz."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n = int(next(l.split()[2] for l in header if l.startswith("element vertex")))
        props = [l.split() for l in header if l.startswith("property")
                 and "list" not in l]
        type_map = {"float": "f4", "float32": "f4", "double": "f8",
                    "float64": "f8", "uchar": "u1", "uint8": "u1", "int": "i4",
                    "uint": "u4", "short": "i2", "ushort": "u2", "char": "i1"}
        names = [p[2] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            xyz_cols = [names.index(c) for c in ("x", "y", "z")]
            return data[:, xyz_cols]
        endian = "<" if "little" in fmt else ">"
        dt = np.dtype([(p[2], endian + type_map[p[1]]) for p in props])
        arr = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
        return np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float64)


def project_cloud_into_utm_grid(xyz, bb, definition, mode: str = "med"):
    """Fuse a cloud into a grid by min/max/avg/median altitude
    (eval_s2p.py:175-226), vectorized with np.unique grouping."""
    origin = np.array([bb[0], bb[2]])
    w, h = bb[1] - bb[0], bb[3] - bb[2]
    map_w = int(round(w / definition)) + 1
    map_h = int(round(h / definition)) + 1
    grid = np.full((map_h, map_w), np.nan)

    coords = np.round((xyz[:, :2] - origin) / definition).astype(int)
    valid = ((coords[:, 1] >= 0) & (coords[:, 1] < map_h)
             & (coords[:, 0] >= 0) & (coords[:, 0] < map_w))
    coords, z = coords[valid], xyz[valid, 2]

    if mode in ("min", "max"):
        order = np.argsort(z)[::-1] if mode == "min" else np.argsort(z)
        c, zz = coords[order], z[order]
        grid[c[:, 1], c[:, 0]] = zz
    else:
        flat = coords[:, 1] * map_w + coords[:, 0]
        order = np.argsort(flat, kind="stable")
        flat, z = flat[order], z[order]
        uniq, starts = np.unique(flat, return_index=True)
        splits = np.split(z, starts[1:])
        agg = np.array([np.mean(s) if mode == "avg" else np.median(s)
                        for s in splits])
        grid[uniq // map_w, uniq % map_w] = agg

    if np.sum(np.isfinite(grid)) < 3:
        print("There are less than 3 points.")
    return np.flipud(grid)


def eval_s2p(aoi_id: str, root_dir: str, dfc_dir: str, output_dir: str = ".",
             n_pairs: int = 1, resolution: float = 0.5, crops: bool = False,
             pan_dir: str | None = None,
             heuristic_pairs_file: str | None = None):
    from satnerf_tpu_torch.eval.dsm_metrics import compute_mae_and_save_dsm_diff
    from satnerf_tpu_torch.geo.geotiff import Affine, Profile, read_geotiff, write_geotiff
    from satnerf_tpu_torch.ops.dsm_raster import raster_dsm

    out_dir = os.path.join(output_dir, "s2p_dsms", aoi_id)
    print("Output dir:", out_dir)
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    sub = "Track3-RGB-crops" if crops else "Track3-RGB"
    img_dir = os.path.join(dfc_dir, f"{sub}/{aoi_id}")
    if crops:
        out_dir += "_crops"

    if heuristic_pairs_file:
        selected = load_heuristic_pairs(root_dir, img_dir,
                                        heuristic_pairs_file, n_pairs=n_pairs)
        print(f"{len(selected)} pairs selected from {heuristic_pairs_file}")
    else:
        selected, n_possible = select_pairs(root_dir, n_pairs=n_pairs)
        print(f"{len(selected)} random pairs selected from {n_possible} possible")
    lonlat_aoi = read_DFC2019_lonlat_aoi(aoi_id, dfc_dir)

    for t, (jl, jr) in enumerate(selected):
        print(f"Running s2p ! Pair {t + 1} of {len(selected)}...")
        run_s2p(jl, jr, img_dir, out_dir, resolution, aoi=lonlat_aoi,
                prefix=f"{t:02}_", pan_dir=pan_dir)
        print("...done")

    ply_paths = glob.glob(os.path.join(out_dir, "*/*/*/*/cloud.ply"))
    if os.path.exists("s2p_tmp"):
        shutil.rmtree("s2p_tmp")
    if not ply_paths:
        print("no s2p point clouds produced (is `s2p` installed?)")
        return None

    xyz = np.vstack([read_ply_xyz(p) for p in ply_paths])
    gt_dir = os.path.join(dfc_dir, "Track3-Truth")
    meta = np.loadtxt(os.path.join(gt_dir, f"{aoi_id}_DSM.txt"))
    xoff, yoff, size, res_gt = meta[0], meta[1], int(meta[2]), meta[3]
    uly = yoff + size * res_gt

    # mean-altitude fusion via the plyflatten-equivalent rasterizer
    xsize = int(round(size * res_gt / resolution))
    avg = raster_dsm(xyz, xoff, uly, resolution, xsize, xsize, radius=2)
    prof = Profile(xsize, xsize, 1, "float64", 32617,
                   Affine(resolution, 0, xoff, 0, -resolution, uly), float("nan"))
    mvs_dsm_avg_path = os.path.join(out_dir, f"{aoi_id}_mvs_dsm_{n_pairs}_pairs_avg.tif")
    write_geotiff(mvs_dsm_avg_path, avg[:, :, 0][None], prof)
    mae_avg = compute_mae_and_save_dsm_diff(mvs_dsm_avg_path, aoi_id, gt_dir,
                                            out_dir, "")
    print(f"Path to output S2P MVS DSM: {mvs_dsm_avg_path}")
    print(f"Altitude MAE (mean alt fusion): {mae_avg}")

    # median-altitude fusion on the GT ROI grid
    bb = [xoff, xoff + size * res_gt, yoff, uly]
    med = project_cloud_into_utm_grid(xyz, bb, resolution, "med")
    prof_med = Profile(med.shape[1], med.shape[0], 1, "float64", 32617,
                       Affine(resolution, 0, xoff, 0, -resolution, uly),
                       float("nan"))
    mvs_dsm_med_path = os.path.join(out_dir, f"mvs_dsm_{n_pairs}_pairs_med.tif")
    write_geotiff(mvs_dsm_med_path, med[None], prof_med)
    mae_med = compute_mae_and_save_dsm_diff(mvs_dsm_med_path, aoi_id, gt_dir,
                                            out_dir, "")
    print(f"Altitude MAE (median alt fusion): {mae_med}")
    return {"mae_avg": mae_avg, "mae_med": mae_med,
            "dsm_avg": mvs_dsm_avg_path, "dsm_med": mvs_dsm_med_path,
            "n_clouds": len(ply_paths)}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--aoi_id", required=True)
    ap.add_argument("--root_dir", required=True)
    ap.add_argument("--dfc_dir", required=True)
    ap.add_argument("--output_dir", default=".")
    ap.add_argument("--n_pairs", type=int, default=1)
    ap.add_argument("--resolution", type=float, default=0.5)
    ap.add_argument("--crops", action="store_true")
    ap.add_argument("--pan_dir", default=None,
                    help="local dir or /vsicurl|http(s) prefix holding the "
                         "full-resolution PAN frames; enables the PAN-band "
                         "stereo variant (reference eval_s2p.py:100-114)")
    ap.add_argument("--heuristic_pairs_file", default=None,
                    help="select pairs from this ranking file instead of "
                         "randomly (reference eval_s2p.py:147-173)")
    eval_s2p(**vars(ap.parse_args()))


if __name__ == "__main__":
    main()
