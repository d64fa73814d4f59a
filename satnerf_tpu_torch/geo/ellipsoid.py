"""WGS84 ellipsoid conversions between geodetic (lat, lon, alt) and ECEF (x, y, z).

Vectorized float64 numpy. Matches the closed-form math used by the reference
(sat_utils.py:59-95 in centreborelli/satnerf): the forward transform is exact;
the inverse uses the Bowring single-iteration approximation, which the
reference also uses — we reproduce it exactly so depth->DSM products agree to
sub-millimeter with the reference pipeline.
"""

from __future__ import annotations

import numpy as np

# WGS84 defining constants
WGS84_A = 6378137.0  # semi-major axis [m]
WGS84_FINV = 298.257223563  # inverse flattening
WGS84_F = 1.0 / WGS84_FINV
WGS84_E2 = 1.0 - (1.0 - WGS84_F) ** 2  # first eccentricity squared
# The reference's inverse uses a rounded literal for e; keep it for bit parity
# with sat_utils.py:81 (ecef_to_latlon_custom).
_REF_E = 8.1819190842622e-2


def ecef_from_latlon(lat, lon, alt):
    """Geodetic (deg, deg, m) -> ECEF (m). Vectorized, float64.

    Mirrors sat_utils.py:59-74 (latlon_to_ecef_custom).
    """
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    alt = np.asarray(alt, dtype=np.float64)
    rad_lat = np.deg2rad(lat)
    rad_lon = np.deg2rad(lon)
    sin_lat = np.sin(rad_lat)
    v = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    x = (v + alt) * np.cos(rad_lat) * np.cos(rad_lon)
    y = (v + alt) * np.cos(rad_lat) * np.sin(rad_lon)
    z = (v * (1.0 - WGS84_E2) + alt) * sin_lat
    return x, y, z


def latlon_from_ecef(x, y, z):
    """ECEF (m) -> geodetic (deg, deg, m) via Bowring's approximation.

    Mirrors sat_utils.py:76-95 (ecef_to_latlon_custom), including its rounded
    eccentricity literal, so outputs are bitwise-comparable to the reference.
    Error < 1e-9 deg for terrestrial altitudes — far below pixel scale.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    a = WGS84_A
    e = _REF_E
    asq = a * a
    esq = e * e
    b = np.sqrt(asq * (1.0 - esq))
    bsq = b * b
    ep = np.sqrt((asq - bsq) / bsq)
    p = np.sqrt(x * x + y * y)
    th = np.arctan2(a * z, b * p)
    lon = np.arctan2(y, x)
    sin_th = np.sin(th)
    cos_th = np.cos(th)
    lat = np.arctan2(z + ep * ep * b * sin_th**3, p - esq * a * cos_th**3)
    n = a / np.sqrt(1.0 - esq * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n
    return np.rad2deg(lat), np.rad2deg(lon), alt
