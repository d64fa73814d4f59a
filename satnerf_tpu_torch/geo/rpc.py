"""Rational Polynomial Camera (RPC) model, fully vectorized.

The reference (centreborelli/satnerf) leans on the external `rpcm` package,
whose localization is an iterative per-call solver (datasets/satellite.py:41-47
calls `rpc.localization` on flattened pixel grids). Here both directions are
vectorized float64 numpy:

  * projection  — (lon, lat, alt) -> (col, row): one (N, 20) monomial-matrix
    product per rational polynomial (RPC00B term ordering).
  * localization — (col, row, alt) -> (lon, lat): damped 2x2 Newton solve with
    *analytic* Jacobians of the rational polynomials, converging quadratically
    (typ. <6 iterations to 1e-12 in normalized units, i.e. sub-micrometer).

This is the host preprocessing hot loop of the data pipeline: building the
ray grid for a 2000x2000 image is two batched localizations of 4M pixels.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

# RPC00B cubic term ordering in L = normalized lon, P = normalized lat,
# H = normalized alt:
#   1, L, P, H, LP, LH, PH, L2, P2, H2, LPH, L3, LP2, LH2, L2P, P3, PH2,
#   L2H, P2H, H3


def _monomials(L, P, H):
    """Stack the 20 RPC00B monomials -> (..., 20)."""
    one = np.ones_like(L)
    return np.stack(
        [
            one, L, P, H,
            L * P, L * H, P * H,
            L * L, P * P, H * H,
            L * P * H,
            L**3, L * P * P, L * H * H, L * L * P,
            P**3, P * H * H, L * L * H, P * P * H, H**3,
        ],
        axis=-1,
    )


def _monomials_dL(L, P, H):
    """d(monomials)/dL -> (..., 20)."""
    zero = np.zeros_like(L)
    one = np.ones_like(L)
    return np.stack(
        [
            zero, one, zero, zero,
            P, H, zero,
            2 * L, zero, zero,
            P * H,
            3 * L * L, P * P, H * H, 2 * L * P,
            zero, zero, 2 * L * H, zero, zero,
        ],
        axis=-1,
    )


def _monomials_dP(L, P, H):
    """d(monomials)/dP -> (..., 20)."""
    zero = np.zeros_like(L)
    one = np.ones_like(L)
    return np.stack(
        [
            zero, zero, one, zero,
            L, zero, H,
            zero, 2 * P, zero,
            L * H,
            zero, 2 * L * P, zero, L * L,
            3 * P * P, H * H, zero, 2 * P * H, zero,
        ],
        axis=-1,
    )


@dataclass
class RPCModel:
    """An RPC00B rational polynomial camera.

    Scale/offset pairs normalize image coords (row, col) and ground coords
    (lat, lon, alt) to [-1, 1]; four 20-coefficient cubic polynomials map
    normalized ground coords to normalized image coords.
    """

    row_offset: float
    col_offset: float
    lat_offset: float
    lon_offset: float
    alt_offset: float
    row_scale: float
    col_scale: float
    lat_scale: float
    lon_scale: float
    alt_scale: float
    row_num: np.ndarray = field(default_factory=lambda: np.zeros(20))
    row_den: np.ndarray = field(default_factory=lambda: np.zeros(20))
    col_num: np.ndarray = field(default_factory=lambda: np.zeros(20))
    col_den: np.ndarray = field(default_factory=lambda: np.zeros(20))

    def __post_init__(self):
        for k in ("row_num", "row_den", "col_num", "col_den"):
            v = np.asarray(getattr(self, k), dtype=np.float64).reshape(20)
            setattr(self, k, v)

    # ------------------------------------------------------------------ IO

    @classmethod
    def from_dict(cls, d: dict) -> "RPCModel":
        """Build from the json metadata 'rpc' entry (rpcm dict layout)."""
        return cls(
            row_offset=float(d["row_offset"]),
            col_offset=float(d["col_offset"]),
            lat_offset=float(d["lat_offset"]),
            lon_offset=float(d["lon_offset"]),
            alt_offset=float(d["alt_offset"]),
            row_scale=float(d["row_scale"]),
            col_scale=float(d["col_scale"]),
            lat_scale=float(d["lat_scale"]),
            lon_scale=float(d["lon_scale"]),
            alt_scale=float(d["alt_scale"]),
            row_num=d["row_num"],
            row_den=d["row_den"],
            col_num=d["col_num"],
            col_den=d["col_den"],
        )

    def to_dict(self) -> dict:
        return {
            "row_offset": self.row_offset,
            "col_offset": self.col_offset,
            "lat_offset": self.lat_offset,
            "lon_offset": self.lon_offset,
            "alt_offset": self.alt_offset,
            "row_scale": self.row_scale,
            "col_scale": self.col_scale,
            "lat_scale": self.lat_scale,
            "lon_scale": self.lon_scale,
            "alt_scale": self.alt_scale,
            "row_num": self.row_num.tolist(),
            "row_den": self.row_den.tolist(),
            "col_num": self.col_num.tolist(),
            "col_den": self.col_den.tolist(),
        }

    # ------------------------------------------------------------ projection

    def projection(self, lon, lat, alt):
        """(lon, lat, alt) -> (col, row). Vectorized, float64."""
        L = (np.asarray(lon, np.float64) - self.lon_offset) / self.lon_scale
        P = (np.asarray(lat, np.float64) - self.lat_offset) / self.lat_scale
        H = (np.asarray(alt, np.float64) - self.alt_offset) / self.alt_scale
        m = _monomials(L, P, H)
        col_n = (m @ self.col_num) / (m @ self.col_den)
        row_n = (m @ self.row_num) / (m @ self.row_den)
        col = col_n * self.col_scale + self.col_offset
        row = row_n * self.row_scale + self.row_offset
        return col, row

    # ---------------------------------------------------------- localization

    def localization(self, col, row, alt, max_iter=30, tol=1e-12):
        """(col, row, alt) -> (lon, lat): invert the projection at fixed alt.

        Vectorized damped Newton on normalized coords with analytic Jacobians.
        `tol` is in normalized image units (1e-12 ~ sub-nanometer on ground).
        """
        c = (np.asarray(col, np.float64) - self.col_offset) / self.col_scale
        r = (np.asarray(row, np.float64) - self.row_offset) / self.row_scale
        H = (np.asarray(alt, np.float64) - self.alt_offset) / self.alt_scale
        c, r, H = np.broadcast_arrays(c, r, H)
        orig_shape = c.shape
        c, r, H = c.ravel(), r.ravel(), H.ravel()

        L = np.zeros_like(c)
        P = np.zeros_like(c)

        for _ in range(max_iter):
            m = _monomials(L, P, H)
            cn_num = m @ self.col_num
            cn_den = m @ self.col_den
            rn_num = m @ self.row_num
            rn_den = m @ self.row_den
            f1 = cn_num / cn_den - c
            f2 = rn_num / rn_den - r
            if np.all(f1 * f1 + f2 * f2 < tol * tol):
                break
            mL = _monomials_dL(L, P, H)
            mP = _monomials_dP(L, P, H)
            # d(num/den) = (num' * den - num * den') / den^2
            j11 = ((mL @ self.col_num) * cn_den - cn_num * (mL @ self.col_den)) / (cn_den * cn_den)
            j12 = ((mP @ self.col_num) * cn_den - cn_num * (mP @ self.col_den)) / (cn_den * cn_den)
            j21 = ((mL @ self.row_num) * rn_den - rn_num * (mL @ self.row_den)) / (rn_den * rn_den)
            j22 = ((mP @ self.row_num) * rn_den - rn_num * (mP @ self.row_den)) / (rn_den * rn_den)
            det = j11 * j22 - j12 * j21
            det = np.where(np.abs(det) < 1e-300, 1e-300, det)
            dL = (j22 * f1 - j12 * f2) / det
            dP = (-j21 * f1 + j11 * f2) / det
            # clip step to stay inside the polynomial's region of validity
            dL = np.clip(dL, -1.0, 1.0)
            dP = np.clip(dP, -1.0, 1.0)
            L -= dL
            P -= dP

        lon = (L * self.lon_scale + self.lon_offset).reshape(orig_shape)
        lat = (P * self.lat_scale + self.lat_offset).reshape(orig_shape)
        return lon, lat

    # ------------------------------------------------------------- incidence

    def incidence_angles(self, lon, lat, z=0.0):
        """(view zenith angle deg, azimuth deg) of the viewing ray at a point.

        Reproduces the quantity the reference uses to pick the most-nadir view
        (sat_utils.py:225-235 via rpcm's incidence_angles): the angle between
        the local vertical and the viewing direction.
        """
        from satnerf_tpu_torch.geo.ellipsoid import ecef_from_latlon

        # viewing ray through (lon, lat, z): localize the same pixel at two
        # altitudes and take the chord direction
        col, row = self.projection(np.atleast_1d(lon), np.atleast_1d(lat), np.atleast_1d(z))
        z_lo, z_hi = float(z), float(z) + 200.0
        lon_lo, lat_lo = self.localization(col, row, np.full_like(col, z_lo))
        lon_hi, lat_hi = self.localization(col, row, np.full_like(col, z_hi))
        p_lo = np.stack(ecef_from_latlon(lat_lo, lon_lo, np.full_like(col, z_lo)), -1)
        p_hi = np.stack(ecef_from_latlon(lat_hi, lon_hi, np.full_like(col, z_hi)), -1)
        view = p_hi - p_lo  # points toward the satellite
        view = view / np.linalg.norm(view, axis=-1, keepdims=True)

        # local ENU frame at the ground point
        lat_r, lon_r = np.deg2rad(lat_lo), np.deg2rad(lon_lo)
        up = np.stack(
            [np.cos(lat_r) * np.cos(lon_r), np.cos(lat_r) * np.sin(lon_r), np.sin(lat_r)], -1
        )
        east = np.stack([-np.sin(lon_r), np.cos(lon_r), np.zeros_like(lon_r)], -1)
        north = np.cross(up, east)

        zenith = np.rad2deg(np.arccos(np.clip(np.sum(view * up, -1), -1, 1)))
        azimuth = np.rad2deg(
            np.arctan2(np.sum(view * east, -1), np.sum(view * north, -1))
        ) % 360.0
        return float(zenith[0]) if zenith.size == 1 else zenith, (
            float(azimuth[0]) if azimuth.size == 1 else azimuth
        )


def rescale_rpc(rpc: RPCModel, alpha: float) -> RPCModel:
    """Scale an RPC to follow an image resize by factor `alpha`.

    Mirrors sat_utils.py:39-57: only the image-space scales/offsets change.
    """
    out = copy.copy(rpc)
    out.row_scale = rpc.row_scale * float(alpha)
    out.col_scale = rpc.col_scale * float(alpha)
    out.row_offset = rpc.row_offset * float(alpha)
    out.col_offset = rpc.col_offset * float(alpha)
    return out


def scaling_params(v):
    """(scale, offset) such that (v - offset) / scale maps v into [-1, 1].

    Mirrors sat_utils.py:30-37 (rpc_scaling_params).
    """
    vec = np.asarray(v, dtype=np.float64).ravel()
    scale = (vec.max() - vec.min()) / 2.0
    offset = vec.min() + scale
    return float(scale), float(offset)


def fit_rpc_from_projection(project_fn, lon_range, lat_range, alt_range,
                            img_w, img_h, n_grid=12) -> RPCModel:
    """Fit an RPCModel to an arbitrary camera `project_fn(lon, lat, alt) -> (col, row)`.

    Least-squares fit of the numerator coefficients on a 3D grid of ground
    points (denominators fixed to [1, 0, ..., 0]); exact for any camera whose
    image coords are cubic in normalized ground coords (affine/projective
    included). Used by the synthetic test fixtures and the dataset-creation
    tool to build 'fake RPCs' without any satellite imagery.
    """
    lon_s, lon_o = scaling_params(lon_range)
    lat_s, lat_o = scaling_params(lat_range)
    alt_s, alt_o = scaling_params(alt_range)

    g = np.linspace(-1.0, 1.0, n_grid)
    L, P, H = np.meshgrid(g, g, g, indexing="ij")
    L, P, H = L.ravel(), P.ravel(), H.ravel()
    lon = L * lon_s + lon_o
    lat = P * lat_s + lat_o
    alt = H * alt_s + alt_o
    col, row = project_fn(lon, lat, alt)

    col_s, col_o = (img_w - 1) / 2.0, (img_w - 1) / 2.0
    row_s, row_o = (img_h - 1) / 2.0, (img_h - 1) / 2.0
    cn = (np.asarray(col, np.float64) - col_o) / col_s
    rn = (np.asarray(row, np.float64) - row_o) / row_s

    m = _monomials(L, P, H)  # (N, 20)
    col_num, *_ = np.linalg.lstsq(m, cn, rcond=None)
    row_num, *_ = np.linalg.lstsq(m, rn, rcond=None)
    den = np.zeros(20)
    den[0] = 1.0
    return RPCModel(
        row_offset=row_o, col_offset=col_o,
        lat_offset=lat_o, lon_offset=lon_o, alt_offset=alt_o,
        row_scale=row_s, col_scale=col_s,
        lat_scale=lat_s, lon_scale=lon_s, alt_scale=alt_s,
        row_num=row_num, row_den=den.copy(),
        col_num=col_num, col_den=den.copy(),
    )
