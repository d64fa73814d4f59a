"""UTM projection (WGS84), closed-form Karney/Krüger 6th-order series.

Replaces the reference's pyproj/utm bindings (sat_utils.py:97-112). The series
is accurate to nanometers inside a zone — far beyond the 0.5 m DSM grid, so
DSM products are numerically interchangeable with the reference's.
"""

from __future__ import annotations

import numpy as np

from satnerf_tpu_torch.geo.ellipsoid import WGS84_A, WGS84_F

_K0 = 0.9996
_E0 = 500000.0
_N0_SOUTH = 10000000.0

_N = WGS84_F / (2.0 - WGS84_F)  # third flattening
_A_CAP = WGS84_A / (1.0 + _N) * (1.0 + _N**2 / 4.0 + _N**4 / 64.0 + _N**6 / 256.0)

# Forward Krüger series coefficients (Karney 2011, eq. 35), order n^6
_ALPHA = np.array(
    [
        _N / 2 - 2 * _N**2 / 3 + 5 * _N**3 / 16 + 41 * _N**4 / 180
        - 127 * _N**5 / 288 + 7891 * _N**6 / 37800,
        13 * _N**2 / 48 - 3 * _N**3 / 5 + 557 * _N**4 / 1440 + 281 * _N**5 / 630
        - 1983433 * _N**6 / 1935360,
        61 * _N**3 / 240 - 103 * _N**4 / 140 + 15061 * _N**5 / 26880
        + 167603 * _N**6 / 181440,
        49561 * _N**4 / 161280 - 179 * _N**5 / 168 + 6601661 * _N**6 / 7257600,
        34729 * _N**5 / 80640 - 3418889 * _N**6 / 1995840,
        212378941 * _N**6 / 319334400,
    ]
)

_ZONE_LETTERS = "CDEFGHJKLMNPQRSTUVWX"


def utm_zone_number(lat: float, lon: float) -> int:
    """UTM zone for a point, with the Norway/Svalbard exceptions."""
    lon = ((lon + 180.0) % 360.0) - 180.0
    if 56.0 <= lat < 64.0 and 3.0 <= lon < 12.0:
        return 32
    if 72.0 <= lat <= 84.0 and lon >= 0.0:
        if lon < 9.0:
            return 31
        if lon < 21.0:
            return 33
        if lon < 33.0:
            return 35
        if lon < 42.0:
            return 37
    return int((lon + 180.0) / 6.0) + 1


def utm_zone_letter(lat: float) -> str:
    """MGRS latitude band letter (C..X, no I/O)."""
    if -80.0 <= lat <= 84.0:
        return _ZONE_LETTERS[min(int((lat + 80.0) / 8.0), len(_ZONE_LETTERS) - 1)]
    raise ValueError(f"latitude {lat} outside UTM bands")


def utm_zone(lat: float, lon: float) -> str:
    return f"{utm_zone_number(lat, lon)}{utm_zone_letter(lat)}"


def utm_epsg(lat: float, lon: float) -> int:
    """EPSG code of the UTM CRS containing the point."""
    zone = utm_zone_number(lat, lon)
    return (32600 if lat >= 0 else 32700) + zone


def transverse_mercator(lat, lon, lon0_deg):
    """Core forward transverse Mercator about central meridian lon0_deg.

    Returns un-offset (easting', northing') in meters (no false easting,
    no k0 already applied — caller applies both).
    """
    lat = np.deg2rad(np.asarray(lat, np.float64))
    dlon = np.deg2rad(np.asarray(lon, np.float64) - lon0_deg)

    sin_lat = np.sin(lat)
    # conformal latitude
    es = 2.0 * np.sqrt(_N) / (1.0 + _N)
    t = np.sinh(np.arctanh(sin_lat) - es * np.arctanh(es * sin_lat))
    xi = np.arctan2(t, np.cos(dlon))
    eta = np.arcsinh(np.sin(dlon) / np.sqrt(t * t + np.cos(dlon) ** 2))

    xi_s = xi.copy()
    eta_s = eta.copy()
    for j, a in enumerate(_ALPHA, start=1):
        xi_s += a * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_s += a * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    return _A_CAP * eta_s, _A_CAP * xi_s


def utm_from_latlon(lats, lons, zone_number: int | None = None):
    """(lat, lon) arrays -> (easting, northing) in the UTM zone of the first
    point (or an explicit `zone_number`).

    Mirrors sat_utils.py:97-112 (utm_from_latlon): the zone is chosen once
    from the first point, as the reference does for an AOI-sized cloud.
    """
    lats = np.atleast_1d(np.asarray(lats, np.float64))
    lons = np.atleast_1d(np.asarray(lons, np.float64))
    if zone_number is None:
        zone_number = utm_zone_number(float(lats.flat[0]), float(lons.flat[0]))
    lon0 = (zone_number - 1) * 6.0 - 180.0 + 3.0
    x, y = transverse_mercator(lats, lons, lon0)
    easts = _K0 * x + _E0
    norths = _K0 * y
    norths = np.where(lats < 0, norths + _N0_SOUTH, norths)
    return easts, norths
