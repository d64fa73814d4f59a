"""Host-side geodesy layer (float64 numpy).

Everything here runs on the host in double precision: ECEF coordinates are
~6.4e6 m, so float32 would lose ~0.5 m of resolution. Device code only ever
sees scene-normalized float32 coordinates (see data/scene.py).
"""

from satnerf_tpu_torch.geo.ellipsoid import ecef_from_latlon, latlon_from_ecef
from satnerf_tpu_torch.geo.rpc import RPCModel, rescale_rpc, scaling_params
from satnerf_tpu_torch.geo.utm import utm_from_latlon, utm_zone, utm_epsg

__all__ = [
    "ecef_from_latlon",
    "latlon_from_ecef",
    "RPCModel",
    "rescale_rpc",
    "scaling_params",
    "utm_from_latlon",
    "utm_zone",
    "utm_epsg",
]
