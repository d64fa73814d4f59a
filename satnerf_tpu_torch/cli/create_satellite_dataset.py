#!/usr/bin/env python
"""Dataset creation from DFC2019-style inputs on the PyTorch port:
create_satellite_dataset.py over the port's own geo/ modules (no model, no
device). It crops the RGB GeoTIFFs to the lidar AOI, optionally runs
bundle adjustment (external `bundle_adjust` package, kept as an optional
import exactly like the reference), and emits one metadata json per image plus
random train/test splits.

Differences from the reference forced by environment: sun angles and the
acquisition date come from NITF tags of MSI files served over HTTP in the
reference (create_satellite_dataset.py:88-117) — here they are read, in
priority order, from NITF-style GDAL metadata tags embedded in the image
itself (NITF_USE00A_SUN_EL / _SUN_AZ / NITF_STDIDC_ACQUISITION_DATE), a
local `{img_id}.sun.json` sidecar, a `--sun_meta` table, or default to a
mid-latitude sun if unavailable (documented in the output json). The geojson
footprint altitude comes from the lidar GT DSM median (`--ground_alt`
overrides) instead of the reference's srtm4 web lookup
(create_satellite_dataset.py:21-30).

  python -m satnerf_tpu_torch.cli.create_satellite_dataset --aoi_id JAX_068 \
      --dfc_dir DFC --output_dir OUT [--no-ba] [--splits] [--sun_meta ...] \
      [--ground_alt ALT]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil

import numpy as np


def get_file_id(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def get_image_lonlat_aoi(rpc, h: int, w: int, z: float = 0.0) -> dict:
    """Geojson footprint of an image at ground altitude z
    (create_satellite_dataset.py:21-30; srtm4 altitude replaced by --ground_alt)."""
    cols = np.array([0, w, w, 0], float)
    rows = np.array([0, 0, h, h], float)
    lons, lats = rpc.localization(cols, rows, np.full(4, z))
    coords = np.stack([lons, lats], -1)
    return {
        "coordinates": [coords.tolist()],
        "type": "Polygon",
        "center": [float(lons.min() + (lons.max() - lons.min()) / 2),
                   float(lats.min() + (lats.max() - lats.min()) / 2)],
    }


def run_ba(img_dir: str, output_dir: str):
    """Bundle adjustment via the external package (create_satellite_dataset.py:32-78).
    Optional: raises ImportError with guidance when the package is absent."""
    try:
        from bundle_adjust import loader
        from bundle_adjust.ba_pipeline import BundleAdjustmentPipeline
        from bundle_adjust.cam_utils import SatelliteImage
    except ImportError as e:
        raise ImportError(
            "bundle_adjust is not installed; run with --no-ba or provide "
            "precomputed ba_files (rpcs_adj/, ba_params/)"
        ) from e
    import rpcm  # external, only present alongside bundle_adjust

    os.makedirs(output_dir, exist_ok=True)
    myimages = sorted(glob.glob(img_dir + "/*.tif"))
    myrpcs = [rpcm.rpc_from_geotiff(p) for p in myimages]
    input_images = [SatelliteImage(fn, rpc) for fn, rpc in zip(myimages, myrpcs)]
    ba_input_data = {
        "in_dir": img_dir,
        "out_dir": os.path.join(output_dir, "ba_files"),
        "images": input_images,
    }
    os.makedirs(ba_input_data["out_dir"], exist_ok=True)
    tracks_config = {"FT_reset": False, "FT_save": True,
                     "FT_sift_detection": "s2p",
                     "FT_sift_matching": "epipolar_based"}
    ba_pipeline = BundleAdjustmentPipeline(
        ba_input_data, tracks_config=tracks_config,
        extra_ba_config={"cam_model": "rpc"},
    )
    ba_pipeline.run()

    ba_params_dir = os.path.join(ba_pipeline.out_dir, "ba_params")
    os.makedirs(ba_params_dir, exist_ok=True)
    np.save(os.path.join(ba_params_dir, "pts_ind.npy"), ba_pipeline.ba_params.pts_ind)
    np.save(os.path.join(ba_params_dir, "cam_ind.npy"), ba_pipeline.ba_params.cam_ind)
    np.save(os.path.join(ba_params_dir, "pts3d.npy"),
            ba_pipeline.ba_params.pts3d_ba - ba_pipeline.global_transform)
    np.save(os.path.join(ba_params_dir, "pts2d.npy"), ba_pipeline.ba_params.pts2d)
    fnames = [ba_pipeline.images[idx].geotiff_path
              for idx in ba_pipeline.ba_params.cam_prev_indices]
    loader.save_list_of_paths(
        os.path.join(ba_params_dir, "geotiff_paths.txt"), fnames)


def _load_sun_metadata(img_id: str, img_dir: str, sun_meta: str | None,
                       image_tags: dict | None = None):
    """Sun elevation/azimuth + acquisition date for an image.

    Priority: NITF-style GDAL metadata tags embedded in the image itself
    (what the reference reads via rasterio src.tags() from the remote MSI
    files, the reference's create_satellite_dataset.py:104-123 — our GeoTIFF
    stack parses tag 42112), then a `{img_id}.sun.json` sidecar, then a
    shared `--sun_meta` table, then a documented default."""
    if image_tags:
        el = image_tags.get("NITF_USE00A_SUN_EL")
        az = image_tags.get("NITF_USE00A_SUN_AZ")
        if el is not None and az is not None:
            out = {"sun_elevation": float(el), "sun_azimuth": float(az),
                   "sun_metadata_source": "image_tags"}
            date = image_tags.get("NITF_STDIDC_ACQUISITION_DATE")
            if date is not None:
                out["acquisition_date"] = str(date)
            return out
    sidecar = os.path.join(img_dir, img_id + ".sun.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    if sun_meta and os.path.exists(sun_meta):
        with open(sun_meta) as f:
            table = json.load(f)
        if img_id in table:
            return table[img_id]
    return {"sun_elevation": 60.0, "sun_azimuth": 180.0,
            "acquisition_date": "20141001120000",
            "sun_metadata_source": "default"}


def create_dataset_from_DFC2019_data(aoi_id: str, img_dir: str, dfc_dir: str,
                                     output_dir: str, use_ba: bool = False,
                                     sun_meta: str | None = None,
                                     ground_alt: float | None = None):
    from satnerf_tpu_torch.geo.geotiff import read_geotiff
    from satnerf_tpu_torch.geo.rpc import RPCModel

    os.makedirs(output_dir, exist_ok=True)
    path_to_dsm = os.path.join(dfc_dir, f"Track3-Truth/{aoi_id}_DSM.tif")

    if use_ba:
        with open(os.path.join(output_dir,
                               "ba_files/ba_params/geotiff_paths.txt")) as f:
            geotiff_paths = [s for s in f.read().split("\n") if s.strip()]
        geotiff_paths = [p.replace("/pan_crops/", "/crops/")
                          .replace("PAN.tif", "RGB.tif") for p in geotiff_paths]
        ba_basenames = [os.path.basename(x) for x in geotiff_paths]
        kps_pts3d_ind = np.load(os.path.join(output_dir, "ba_files/ba_params/pts_ind.npy"))
        kps_cam_ind = np.load(os.path.join(output_dir, "ba_files/ba_params/cam_ind.npy"))
        kps_pts2d = np.load(os.path.join(output_dir, "ba_files/ba_params/pts2d.npy"))
    else:
        geotiff_paths = sorted(glob.glob(img_dir + "/*.tif"))

    dsm = read_geotiff(path_to_dsm).data[0]
    min_alt = int(np.round(np.nanmin(dsm) - 1))
    max_alt = int(np.round(np.nanmax(dsm) + 1))
    if ground_alt is None:
        # the reference anchors the geojson footprint at the srtm4 altitude
        # of the scene center (the reference's create_satellite_dataset.py:
        # 21-30, needs network + the srtm4 package); the lidar GT DSM is
        # already in hand here, and its median altitude is the ground level
        # over the AOI. --ground_alt stays as the explicit override.
        ground_alt = float(np.nanmedian(dsm))

    for rgb_p in geotiff_paths:
        img_id = get_file_id(rgb_p)
        d = {"img": os.path.basename(rgb_p)}
        g = read_geotiff(os.path.join(img_dir, d["img"])
                         if not os.path.isabs(rgb_p) else rgb_p)
        d["height"] = int(g.data.shape[1])
        d["width"] = int(g.data.shape[2])

        sun = _load_sun_metadata(img_id, img_dir, sun_meta,
                                 image_tags=g.tags)
        d.update({k: sun[k] for k in ("sun_elevation", "sun_azimuth",
                                      "acquisition_date") if k in sun})
        if "sun_metadata_source" in sun:
            d["sun_metadata_source"] = sun["sun_metadata_source"]

        if use_ba:
            rpc_path = os.path.join(output_dir,
                                    f"ba_files/rpcs_adj/{img_id}.rpc_adj")
            d["rpc"] = _read_rpc_file(rpc_path)
            shutil.copyfile(
                os.path.join(output_dir, "ba_files/ba_params/pts3d.npy"),
                os.path.join(output_dir, "pts3d.npy"),
            )
            cam_idx = ba_basenames.index(d["img"])
            d["keypoints"] = {
                "2d_coordinates": kps_pts2d[kps_cam_ind == cam_idx, :].tolist(),
                "pts3d_indices": kps_pts3d_ind[kps_cam_ind == cam_idx].tolist(),
            }
        else:
            if g.rpc is not None:  # embedded TIFF RPCCoefficient tag
                d["rpc"] = g.rpc
            else:
                sidecar = os.path.splitext(rgb_p)[0] + ".rpc.json"
                if not os.path.exists(sidecar):
                    raise FileNotFoundError(
                        f"no RPC in {rgb_p} (no RPCCoefficient TIFF tag) and "
                        f"no sidecar {sidecar}"
                    )
                with open(sidecar) as f:
                    d["rpc"] = json.load(f)

        rpc = RPCModel.from_dict(d["rpc"])
        d["geojson"] = get_image_lonlat_aoi(rpc, d["height"], d["width"],
                                            z=ground_alt)
        d["min_alt"] = min_alt
        d["max_alt"] = max_alt

        with open(os.path.join(output_dir, f"{img_id}.json"), "w") as f:
            json.dump(d, f, indent=2)


def _read_rpc_file(path: str) -> dict:
    """Parse an rpcm .rpc_adj text file into our rpc dict layout."""
    vals = {}
    lists = {"LINE_NUM_COEFF": [], "LINE_DEN_COEFF": [],
             "SAMP_NUM_COEFF": [], "SAMP_DEN_COEFF": []}
    with open(path) as f:
        for line in f:
            parts = line.replace(":", " ").split()
            if len(parts) < 2:
                continue
            key = parts[0]
            for lk in lists:
                if key.startswith(lk):
                    lists[lk].append(float(parts[-1]))
                    break
            else:
                try:
                    vals[key] = float(parts[-1])
                except ValueError:
                    pass
    return {
        "row_offset": vals.get("LINE_OFF", 0.0),
        "col_offset": vals.get("SAMP_OFF", 0.0),
        "lat_offset": vals.get("LAT_OFF", 0.0),
        "lon_offset": vals.get("LONG_OFF", 0.0),
        "alt_offset": vals.get("HEIGHT_OFF", 0.0),
        "row_scale": vals.get("LINE_SCALE", 1.0),
        "col_scale": vals.get("SAMP_SCALE", 1.0),
        "lat_scale": vals.get("LAT_SCALE", 1.0),
        "lon_scale": vals.get("LONG_SCALE", 1.0),
        "alt_scale": vals.get("HEIGHT_SCALE", 1.0),
        "row_num": lists["LINE_NUM_COEFF"],
        "row_den": lists["LINE_DEN_COEFF"],
        "col_num": lists["SAMP_NUM_COEFF"],
        "col_den": lists["SAMP_DEN_COEFF"],
    }


def create_train_test_splits(input_sample_ids, test_percent: float = 0.15,
                             min_test_samples: int = 2, seed=None):
    """Random 85/15 split with a test-set floor
    (create_satellite_dataset.py:144-164)."""
    import random as _random

    ids = list(input_sample_ids)
    rng = _random.Random(seed)
    rng.shuffle(ids)
    n_test = max(min_test_samples, int(test_percent * len(ids)))
    return ids[: len(ids) - n_test], ids[len(ids) - n_test:]


def crop_geotiff_lonlat_aoi(geotiff_path: str, output_path: str, lonlat_aoi,
                            rpc_dict: dict):
    """Crop a GeoTIFF to a lon/lat AOI and shift the RPC offsets by the crop
    origin (create_satellite_dataset.py:182-204). Writes a .rpc.json sidecar."""
    from satnerf_tpu_torch.geo.geotiff import read_geotiff, write_geotiff
    from satnerf_tpu_torch.geo.rpc import RPCModel

    rpc = RPCModel.from_dict(rpc_dict)
    coords = np.array(lonlat_aoi["coordinates"][0])
    lons, lats = coords[:, 0], coords[:, 1]
    cols, rows = rpc.projection(lons, lats, np.zeros_like(lons))
    x0, y0 = int(np.floor(cols.min())), int(np.floor(rows.min()))
    x1, y1 = int(np.ceil(cols.max())), int(np.ceil(rows.max()))

    g = read_geotiff(geotiff_path)
    h, w = g.data.shape[1:]
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, w), min(y1, h)
    crop = g.data[:, y0:y1, x0:x1]
    prof = g.profile.copy()
    prof.width, prof.height = crop.shape[2], crop.shape[1]

    out_rpc = rpc.to_dict()
    out_rpc["row_offset"] -= y0
    out_rpc["col_offset"] -= x0
    # embed the shifted RPC as a TIFF tag and keep a json sidecar; carry the
    # source's GDAL metadata (NITF sun angles / acquisition date) along
    write_geotiff(output_path, crop, prof, rpc=out_rpc, tags=g.tags)
    with open(os.path.splitext(output_path)[0] + ".rpc.json", "w") as f:
        json.dump(out_rpc, f, indent=2)


def create_satellite_dataset(aoi_id: str, dfc_dir: str, output_dir: str,
                             ba: bool = True, splits: bool = False,
                             sun_meta: str | None = None,
                             ground_alt: float | None = None):
    img_dir = os.path.join(dfc_dir, f"Track3-RGB/{aoi_id}")
    if ba:
        run_ba(img_dir, output_dir)
    create_dataset_from_DFC2019_data(aoi_id, img_dir, dfc_dir, output_dir,
                                     use_ba=ba, sun_meta=sun_meta,
                                     ground_alt=ground_alt)
    if splits:
        json_files = [os.path.basename(p)
                      for p in glob.glob(os.path.join(output_dir, "*.json"))
                      if not p.endswith("scene.loc")]
        train_samples, test_samples = create_train_test_splits(json_files)
        with open(os.path.join(output_dir, "train.txt"), "w") as f:
            f.write("\n".join(train_samples))
        with open(os.path.join(output_dir, "test.txt"), "w") as f:
            f.write("\n".join(test_samples))
    print("done")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--aoi_id", required=True)
    ap.add_argument("--dfc_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--no-ba", dest="ba", action="store_false")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--sun_meta", default=None)
    ap.add_argument("--ground_alt", type=float, default=None,
                    help="footprint ground altitude (m); default: median of "
                         "the lidar GT DSM (replaces the reference's srtm4 "
                         "lookup)")
    args = ap.parse_args()
    create_satellite_dataset(args.aoi_id, args.dfc_dir, args.output_dir,
                             ba=args.ba, splits=args.splits,
                             sun_meta=args.sun_meta,
                             ground_alt=args.ground_alt)


if __name__ == "__main__":
    main()
