"""Metadata sorters over a dataset root's per-image json files.

Used for reference-view selection in the DSM tool and the solar study
(reference sat_utils.py:225-271): order images by view incidence angle, solar
incidence angle, or acquisition date.
"""

from __future__ import annotations

import datetime
import glob
import json
import os

import numpy as np

from satnerf_tpu_torch.data.rays import solar_incidence_angle_deg
from satnerf_tpu_torch.geo.rpc import RPCModel


def _jsons(root_dir: str):
    return sorted(glob.glob(os.path.join(root_dir, "*.json")))


def sort_by_increasing_view_incidence_angle(root_dir: str):
    """Most-nadir view first (sat_utils.py:225-235)."""
    angles = []
    paths = _jsons(root_dir)
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        rpc = RPCModel.from_dict(d["rpc"])
        c_lon, c_lat = d["geojson"]["center"][0], d["geojson"]["center"][1]
        alpha, _ = rpc.incidence_angles(c_lon, c_lat, z=0)
        angles.append(alpha)
    return [x for _, x in sorted(zip(angles, paths))]


def sort_by_increasing_solar_incidence_angle(root_dir: str):
    """Most-nadir sun first (sat_utils.py:237-251)."""
    angles = []
    paths = _jsons(root_dir)
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        angles.append(
            solar_incidence_angle_deg(float(d["sun_elevation"]),
                                      float(d["sun_azimuth"]))
        )
    return [x for _, x in sorted(zip(angles, paths))]


def _dates(paths):
    out = []
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        out.append(datetime.datetime.strptime(d["acquisition_date"], "%Y%m%d%H%M%S"))
    return out


def sort_by_acquisition_date(root_dir: str):
    paths = _jsons(root_dir)
    return [x for _, x in sorted(zip(_dates(paths), paths))]


def sort_by_day_of_the_year(root_dir: str):
    paths = _jsons(root_dir)
    return [x for _, x in sorted(zip(_dates(paths), paths),
                                 key=lambda t: t[0].timetuple().tm_yday)]
