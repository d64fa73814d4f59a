"""Ray construction from RPC cameras and sun geometry.

Vectorized float64 host stage (the reference's per-pixel hot loop,
datasets/satellite.py:18-65): each pixel is localized at the scene's max and
min altitude; the ray runs from the high point (origin) to the low point.
"""

from __future__ import annotations

import numpy as np

from satnerf_tpu_torch.geo.ellipsoid import ecef_from_latlon
from satnerf_tpu_torch.geo.rpc import RPCModel


def rays_from_rpc(cols, rows, rpc: RPCModel, min_alt: float, max_alt: float
                  ) -> np.ndarray:
    """Build (N, 8) rays [origin(3), unit dir(3), near=0, far=|far-near|] for
    pixel coordinate arrays cols/rows (datasets/satellite.py:18-65).

    The origin sits at max_alt (nearest to the satellite), the direction
    points down toward min_alt; near/far bound the Euclidean span.
    """
    cols = np.asarray(cols, np.float64).ravel()
    rows = np.asarray(rows, np.float64).ravel()
    max_alts = np.full_like(cols, float(max_alt))
    min_alts = np.full_like(cols, float(min_alt))

    lons, lats = rpc.localization(cols, rows, max_alts)
    xyz_near = np.stack(ecef_from_latlon(lats, lons, max_alts), axis=-1)

    lons, lats = rpc.localization(cols, rows, min_alts)
    xyz_far = np.stack(ecef_from_latlon(lats, lons, min_alts), axis=-1)

    d = xyz_far - xyz_near
    fars = np.linalg.norm(d, axis=1)
    rays_d = d / fars[:, None]
    nears = np.zeros_like(fars)

    return np.hstack(
        [xyz_near, rays_d, nears[:, None], fars[:, None]]
    )


def image_ray_grid(rpc: RPCModel, h: int, w: int, min_alt: float, max_alt: float
                   ) -> np.ndarray:
    """(h*w, 8) rays for every pixel, row-major (matches np.meshgrid usage at
    datasets/satellite.py:145-146: row-major over (rows, cols))."""
    cols, rows = np.meshgrid(np.arange(w), np.arange(h))
    return rays_from_rpc(cols.ravel(), rows.ravel(), rpc, min_alt, max_alt)


def sun_direction(sun_elevation_deg: float, sun_azimuth_deg: float) -> np.ndarray:
    """Unit sun direction in the local ENU-ish frame the reference uses
    (datasets/satellite.py:229-244): x=east, y=north, z=up."""
    el = np.radians(float(sun_elevation_deg))
    az = np.radians(float(sun_azimuth_deg))
    return np.array(
        [np.sin(az) * np.cos(el), np.cos(az) * np.cos(el), np.sin(el)],
        dtype=np.float64,
    )


def solar_incidence_angle_deg(sun_elevation_deg: float, sun_azimuth_deg: float
                              ) -> float:
    """Angle between the sun direction and the vertical (sat_utils.py:237-251)."""
    d = sun_direction(sun_elevation_deg, sun_azimuth_deg)
    return float(np.degrees(np.arccos(np.clip(d[2], -1.0, 1.0))))
