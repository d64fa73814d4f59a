"""A synthetic satellite AOI that needs no DFC2019 data.

The scene is a height field (a 40 m box on a 10 m plane, or smooth hills)
with a checkered albedo; cameras are slightly off-nadir parallel projections
expressed as fitted RPCs; images are exact ray-marched renders of the height
field, so geometry and pixels agree well enough to train on. Beside the
images go the lidar-style ground truth rasters the DSM evaluation reads.

Counterpart of the JAX package's recipe (tests/fixtures.py
`build_synthetic_dataset` + tools/make_synthetic_aoi.py): the same seed gives
the same cameras, images, key points and rasters. The painted transients
and the RPC mis-registration of that recipe wait for the slices that train
on them.

  python -m satnerf_tpu_torch.data.synthetic OUT_DIR [--size 32] [--n_train 3]
      [--n_test 2] [--terrain box|smooth] [--shading] [--keypoints N]
      [--seed 0]

writes OUT_DIR/data (json + tif + train.txt/test.txt) and OUT_DIR/gt
(SYN_000_DSM.tif/.txt, SYN_000_CLS.tif).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from satnerf_tpu_torch.geo.ellipsoid import ecef_from_latlon
from satnerf_tpu_torch.geo.geotiff import Affine, Profile, write_geotiff
from satnerf_tpu_torch.geo.rpc import fit_rpc_from_projection
from satnerf_tpu_torch.geo.utm import utm_from_latlon
from satnerf_tpu_torch.ops.dsm_raster import raster_dsm

AOI_LON, AOI_LAT = -81.66, 30.35  # Jacksonville-ish
ALT_MIN, ALT_MAX = -20.0, 80.0
HALF_EXTENT_DEG = 0.002
M_PER_DEG_LAT = 111_320.0  # WGS84 meridian arc at this scale
AMBIENT_SKY = (0.14, 0.16, 0.25)  # bluish skylight under full shadow


def make_camera(view_dx: float, view_dy: float, w: int, h: int):
    """Parallel projection with a per-altitude shift (view_dx, view_dy) in
    pixels per meter of altitude: a linear pushbroom-style camera."""
    e = HALF_EXTENT_DEG

    def project(lon, lat, alt):
        col = (lon - (AOI_LON - e)) / (2 * e) * (w - 1) + view_dx * alt
        row = ((AOI_LAT + e) - lat) / (2 * e) * (h - 1) + view_dy * alt
        return col, row

    return project, (AOI_LON - e, AOI_LON + e), (AOI_LAT - e, AOI_LAT + e)


def height_field(lon, lat):
    """Plane at 10 m with a 40 m box in the middle."""
    u = (lon - AOI_LON) / HALF_EXTENT_DEG
    v = (lat - AOI_LAT) / HALF_EXTENT_DEG
    box = (np.abs(u) < 0.3) & (np.abs(v) < 0.3)
    return np.where(box, 50.0, 10.0)


def smooth_height_field(lon, lat):
    """Continuous terrain: two hills and a ridge on a 10 m plane."""
    u = (lon - AOI_LON) / HALF_EXTENT_DEG
    v = (lat - AOI_LAT) / HALF_EXTENT_DEG
    z = 10.0 + 35.0 * np.exp(-((u - 0.25) ** 2 + (v - 0.2) ** 2)
                             / (2 * 0.18 ** 2))
    z = z + 25.0 * np.exp(-((u + 0.35) ** 2 + (v + 0.3) ** 2)
                          / (2 * 0.25 ** 2))
    return z + 12.0 * np.exp(-((u + v) ** 2) / (2 * 0.3 ** 2))


HEIGHT_FIELDS = {"box": height_field, "smooth": smooth_height_field}


def scaled_height_field(terrain: str, relief: float = 1.0):
    """The terrain with its deviation from the 10 m plane scaled by `relief`."""
    hf = HEIGHT_FIELDS[terrain]
    if relief == 1.0:
        return hf
    return lambda lon, lat: 10.0 + relief * (hf(lon, lat) - 10.0)


def albedo_field(lon, lat, checker: int = 4):
    u = (lon - AOI_LON) / HALF_EXTENT_DEG
    v = (lat - AOI_LAT) / HALF_EXTENT_DEG
    ck = (np.floor(u * checker) + np.floor(v * checker)) % 2
    return 0.3 + 0.5 * ck.astype(np.float64)


def sun_vector(el_deg: float, az_deg: float) -> np.ndarray:
    """Unit vector toward the sun in the local ENU frame, the convention of
    data/rays.py sun_direction."""
    el, az = np.radians(el_deg), np.radians(az_deg)
    return np.array([np.sin(az) * np.cos(el), np.cos(az) * np.cos(el),
                     np.sin(el)])


def surface_normal(hf, lon, lat, delta_deg: float = 2e-6):
    """Unit upward normal of the height field (ENU), by central differences."""
    m_lon = M_PER_DEG_LAT * np.cos(np.radians(AOI_LAT))
    dz_de = (hf(lon + delta_deg, lat) - hf(lon - delta_deg, lat)) / (
        2 * delta_deg * m_lon)
    dz_dn = (hf(lon, lat + delta_deg) - hf(lon, lat - delta_deg)) / (
        2 * delta_deg * M_PER_DEG_LAT)
    n = np.stack([-dz_de, -dz_dn, np.ones_like(dz_de)], axis=0)
    return n / np.linalg.norm(n, axis=0, keepdims=True)


def cast_shadow_lit(hf, lon, lat, alt, el_deg, az_deg, terrain_max,
                    step_m: float = 1.0, lift_m: float = 0.1):
    """1.0 where the surface point sees the sun, 0.0 where terrain occludes
    it: a fixed-step march along the sun vector up to the terrain's maximum."""
    s = sun_vector(el_deg, az_deg)
    if s[2] <= 1e-6:
        return np.zeros_like(alt)
    m_lon = M_PER_DEG_LAT * np.cos(np.radians(AOI_LAT))
    n_steps = int(np.ceil((terrain_max - float(np.min(alt))) /
                          (step_m * s[2]))) + 1
    lit = np.ones_like(alt, dtype=bool)
    for k in range(1, n_steps + 1):
        t = k * step_m
        a = alt + lift_m + s[2] * t
        lit &= ~(a < hf(lon + s[0] * t / m_lon, lat + s[1] * t / M_PER_DEG_LAT))
    return lit.astype(np.float64)


def analytic_sun_term(hf, lon, lat, el_deg, az_deg, terrain_max):
    """Lambert cosine x cast-shadow visibility: the quantity the sun_v head
    models (irradiance = sun_v + (1 - sun_v) * sky)."""
    alt = hf(lon, lat)
    s = sun_vector(el_deg, az_deg)
    n = surface_normal(hf, lon, lat)
    lambert = np.clip(n[0] * s[0] + n[1] * s[1] + n[2] * s[2], 0.0, 1.0)
    return lambert * cast_shadow_lit(hf, lon, lat, alt, el_deg, az_deg,
                                     terrain_max)


def _surface_hits(rpc, hf, w: int, h: int):
    """Per pixel, the altitude where its line of sight meets the height
    field: march down to bracket the crossing, then bisect (< 1 mm)."""
    cols, rows = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))
    fc, fr = cols.ravel(), rows.ravel()
    hit_lo = np.full(w * h, ALT_MIN)  # highest level known below the surface
    hit_hi = np.full(w * h, ALT_MAX)  # lowest level known above it
    done = np.zeros(w * h, bool)
    for alt in np.linspace(ALT_MAX, ALT_MIN, 120):
        lon, lat = rpc.localization(fc, fr, np.full(w * h, alt))
        below = (~done) & (alt <= hf(lon, lat))
        hit_lo = np.where(below, alt, hit_lo)
        hit_hi = np.where(done | below, hit_hi, alt)
        done |= below
    lo, hi = hit_lo.copy(), hit_hi.copy()
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        lon, lat = rpc.localization(fc, fr, mid)
        below = mid <= hf(lon, lat)
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return rpc.localization(fc, fr, 0.5 * (lo + hi))


def build_synthetic_dataset(root: str, n_train: int = 3, n_test: int = 2,
                            w: int = 32, h: int = 32, seed: int = 0,
                            with_keypoints: bool = False, n_kp: int = 40,
                            view_spread: float = 0.05, terrain: str = "box",
                            checker: int = 4, alt_bounds: str = "rpc",
                            relief: float = 1.0, shading: bool = False,
                            sun_el_range: tuple = (35.0, 70.0),
                            sun_az_range: tuple = (90.0, 270.0)) -> str:
    """Write a reference-format dataset: per-image json + tif, train.txt and
    test.txt.

    with_keypoints adds the depth-supervision data a bundle adjustment
    leaves behind (reference create_satellite_dataset.py:125-136): pts3d.npy,
    n_kp ECEF tie points on the true surface, and per image the "keypoints"
    {2d_coordinates, pts3d_indices} of the tie points it sees, with 0.05 px
    of reprojection noise.

    alt_bounds picks the per-image min_alt/max_alt (the rays' near/far):
    "rpc" is the full RPC fit range [ALT_MIN, ALT_MAX]; "terrain" is the
    terrain's own range +-2 m, as the reference derives it from the lidar
    DSM. shading=True draws a sun direction per image and lights the pixels
    with sun_term + (1 - sun_term) * AMBIENT_SKY; each image's analytic sun
    map is saved as {name}_SUN.npy. Without it the sun is fixed at 60/180 and
    the pixels are pure albedo.
    """
    hf = scaled_height_field(terrain, relief)
    grid = np.linspace(-HALF_EXTENT_DEG, HALF_EXTENT_DEG, 241)
    glon, glat = np.meshgrid(AOI_LON + grid, AOI_LAT + grid)
    z = hf(glon.ravel(), glat.ravel())
    terrain_max = float(z.max())
    if alt_bounds == "terrain":
        min_alt, max_alt = float(z.min() - 2.0), float(z.max() + 2.0)
    else:
        min_alt, max_alt = ALT_MIN, ALT_MAX
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []

    if with_keypoints:
        tie_lons = rng.uniform(AOI_LON - 0.0015, AOI_LON + 0.0015, n_kp)
        tie_lats = rng.uniform(AOI_LAT - 0.0015, AOI_LAT + 0.0015, n_kp)
        tie_alts = hf(tie_lons, tie_lats)
        np.save(os.path.join(root, "pts3d.npy"),
                np.stack(ecef_from_latlon(tie_lats, tie_lons, tie_alts), -1))

    for i in range(n_train + n_test):
        dx = rng.uniform(-view_spread, view_spread)
        dy = rng.uniform(-view_spread, view_spread)
        if shading:
            sun_el = float(rng.uniform(*sun_el_range))
            sun_az = float(rng.uniform(*sun_az_range))
        else:
            sun_el, sun_az = 60.0, 180.0
        project, lon_r, lat_r = make_camera(dx, dy, w, h)
        rpc = fit_rpc_from_projection(project, lon_r, lat_r,
                                      (ALT_MIN, ALT_MAX), w, h)
        lon, lat = _surface_hits(rpc, hf, w, h)
        img = albedo_field(lon, lat, checker).reshape(h, w)
        name = f"SYN_000_{i:03d}_RGB"
        if shading:
            sun_term = analytic_sun_term(hf, lon, lat, sun_el, sun_az,
                                         terrain_max).reshape(h, w)
            np.save(os.path.join(root, name + "_SUN.npy"),
                    sun_term.astype(np.float32))
            rgb = np.stack([img * (sun_term + (1.0 - sun_term) * a)
                            for a in AMBIENT_SKY], 0)
        else:
            rgb = np.stack([img, img, img], 0)
        rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        write_geotiff(
            os.path.join(root, name + ".tif"), rgb8,
            Profile(w, h, 3, "uint8", 32617, Affine(0.5, 0, 0, 0, -0.5, 0)))
        meta = {
            "img": name + ".tif",
            "height": h,
            "width": w,
            "sun_elevation": sun_el,
            "sun_azimuth": sun_az,
            "acquisition_date": f"2014100{i}120000",
            "geojson": {"center": [AOI_LON, AOI_LAT],
                        "coordinates": [[[lon_r[0], lat_r[0]], [lon_r[1], lat_r[0]],
                                         [lon_r[1], lat_r[1]], [lon_r[0], lat_r[1]],
                                         [lon_r[0], lat_r[0]]]]},
            "min_alt": min_alt,
            "max_alt": max_alt,
            "rpc": rpc.to_dict(),
        }
        if with_keypoints:
            kp_cols, kp_rows = rpc.projection(tie_lons, tie_lats, tie_alts)
            idx = np.nonzero((kp_cols >= 0) & (kp_cols <= w - 1)
                             & (kp_rows >= 0) & (kp_rows <= h - 1))[0]
            noise = rng.normal(0, 0.05, (idx.size, 2))
            meta["keypoints"] = {
                "2d_coordinates": np.stack(
                    [kp_cols[idx] + noise[:, 0], kp_rows[idx] + noise[:, 1]],
                    -1).tolist(),
                "pts3d_indices": idx.tolist(),
            }
        with open(os.path.join(root, name + ".json"), "w") as f:
            json.dump(meta, f)
        names.append(name + ".json")

    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names[:n_train]))
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(names[n_train:]))
    return root


def write_ground_truth(gt_dir: str, terrain: str = "box",
                       relief: float = 1.0) -> int:
    """Lidar-style GT on a 2 m UTM grid: SYN_000_DSM.tif with its .txt
    (xoff, yoff, size, resolution) and an all-zero SYN_000_CLS.tif mask.
    Returns the raster's side in cells."""
    hf = scaled_height_field(terrain, relief)
    os.makedirs(gt_dir, exist_ok=True)
    lons = np.linspace(AOI_LON - HALF_EXTENT_DEG, AOI_LON + HALF_EXTENT_DEG, 400)
    lats = np.linspace(AOI_LAT - HALF_EXTENT_DEG, AOI_LAT + HALF_EXTENT_DEG, 400)
    glon, glat = np.meshgrid(lons, lats)
    east, north = utm_from_latlon(glat.ravel(), glon.ravel())
    alt = hf(glon.ravel(), glat.ravel())
    res = 2.0
    xoff = np.floor(east.min() / res) * res
    yoff = np.floor(north.min() / res) * res
    size = int(min((east.max() - xoff) // res, (north.max() - yoff) // res))
    top = yoff + size * res
    dsm = raster_dsm(np.stack([east, north, alt], -1), xoff, top, res, size,
                     size, radius=1)
    geo = Affine(res, 0, xoff, 0, -res, top)
    write_geotiff(os.path.join(gt_dir, "SYN_000_DSM.tif"),
                  dsm[:, :, 0][None].astype(np.float32),
                  Profile(size, size, 1, "float32", 32617, geo, float("nan")))
    np.savetxt(os.path.join(gt_dir, "SYN_000_DSM.txt"),
               np.array([xoff, yoff, size, res]))
    write_geotiff(os.path.join(gt_dir, "SYN_000_CLS.tif"),
                  np.zeros((1, size, size), np.uint8),
                  Profile(size, size, 1, "uint8", 32617, geo))
    return size


def make_synthetic_aoi(out_dir: str, size: int = 32, terrain: str = "box",
                       relief: float = 1.0, **dataset_kw):
    """Dataset under out_dir/data and ground truth under out_dir/gt.
    Returns (data_dir, gt_dir)."""
    data_dir = os.path.join(out_dir, "data")
    gt_dir = os.path.join(out_dir, "gt")
    build_synthetic_dataset(data_dir, w=size, h=size, terrain=terrain,
                            relief=relief, **dataset_kw)
    write_ground_truth(gt_dir, terrain, relief)
    return data_dir, gt_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--n_train", type=int, default=3)
    ap.add_argument("--n_test", type=int, default=2)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--view_spread", type=float, default=0.05,
                    help="off-nadir parallax in px per meter of altitude")
    ap.add_argument("--terrain", default="box", choices=tuple(HEIGHT_FIELDS))
    ap.add_argument("--checker", type=int, default=4,
                    help="albedo checker frequency")
    ap.add_argument("--alt_bounds", default="rpc", choices=("rpc", "terrain"))
    ap.add_argument("--relief", type=float, default=1.0)
    ap.add_argument("--shading", action="store_true",
                    help="sun-lit images with a sun direction per image")
    ap.add_argument("--keypoints", type=int, default=0, metavar="N",
                    help="N tie points (pts3d.npy and per-image key points) "
                         "for --ds_lambda training")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    data_dir, gt_dir = make_synthetic_aoi(
        a.out_dir, size=a.size, terrain=a.terrain, relief=a.relief,
        n_train=a.n_train, n_test=a.n_test, seed=a.seed,
        view_spread=a.view_spread, checker=a.checker,
        alt_bounds=a.alt_bounds, shading=a.shading,
        with_keypoints=a.keypoints > 0, n_kp=a.keypoints or 40)
    print(f"synthetic AOI ready: {data_dir} + {gt_dir}")


if __name__ == "__main__":
    main()
