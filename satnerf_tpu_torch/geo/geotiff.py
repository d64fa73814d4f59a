"""Self-contained GeoTIFF reader/writer (no GDAL/rasterio dependency).

The reference delegates all raster IO to rasterio/GDAL (datasets/satellite.py:68,
train_utils.py:74-93, sat_utils.py:137-139). This module provides the subset of
that functionality the pipeline needs, in pure Python + numpy:

  read : classic TIFF, stripped or tiled, chunky or planar layout,
         uint8/uint16/int16/uint32/float32/float64, compression none /
         deflate / LZW / PackBits, horizontal + floating-point predictors,
         GeoTIFF georeferencing (pixel-scale+tiepoint or model transformation),
         GDAL nodata tag.
  write: classic TIFF, stripped, chunky, optional deflate, with GeoTIFF keys
         for a projected CRS given as an EPSG code, affine transform, nodata.

A `Profile` mirrors rasterio's profile dict enough for the pipeline's
"copy the source profile to the output" pattern (train_utils.py:86-93).
"""

from __future__ import annotations

import re
import struct
import zlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# TIFF tag ids
_T_WIDTH = 256
_T_LENGTH = 257
_T_BITS = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_STRIP_OFFSETS = 273
_T_SPP = 277
_T_ROWS_PER_STRIP = 278
_T_STRIP_COUNTS = 279
_T_PLANAR = 284
_T_PREDICTOR = 317
_T_TILE_WIDTH = 322
_T_TILE_LENGTH = 323
_T_TILE_OFFSETS = 324
_T_TILE_COUNTS = 325
_T_SAMPLE_FORMAT = 339
_T_MODEL_PIXEL_SCALE = 33550
_T_MODEL_TIEPOINT = 33922
_T_MODEL_TRANSFORM = 34264
_T_GEO_KEYS = 34735
_T_GEO_DOUBLES = 34736
_T_GEO_ASCII = 34737
_T_GDAL_METADATA = 42112
_T_GDAL_NODATA = 42113
_T_RPC_COEFFICIENTS = 50844  # 92 doubles: RPC00B camera model

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}


@dataclass
class Affine:
    """Row-major 2D affine: (a, b, c, d, e, f) mapping (col, row) -> (x, y):
    x = a*col + b*row + c ; y = d*col + e*row + f  (rasterio convention)."""

    a: float = 1.0
    b: float = 0.0
    c: float = 0.0
    d: float = 0.0
    e: float = 1.0
    f: float = 0.0

    def __mul__(self, colrow):
        col, row = colrow
        return (
            self.a * col + self.b * row + self.c,
            self.d * col + self.e * row + self.f,
        )

    def as_tuple(self):
        return (self.a, self.b, self.c, self.d, self.e, self.f)


@dataclass
class Profile:
    width: int = 0
    height: int = 0
    count: int = 1
    dtype: str = "uint8"
    crs_epsg: Optional[int] = None
    transform: Affine = field(default_factory=Affine)
    nodata: Optional[float] = None

    def copy(self) -> "Profile":
        return Profile(
            self.width, self.height, self.count, self.dtype, self.crs_epsg,
            Affine(*self.transform.as_tuple()), self.nodata,
        )


# ------------------------------------------------------------------- decoding


def _lzw_decode(data: bytes, expected: int = 0) -> bytes:
    """TIFF-variant LZW (MSB-first codes, EarlyChange=1). Uses the native C++
    decoder (satnerf_tpu_torch/native.py) when available — ~100x the Python path."""
    from satnerf_tpu_torch import native

    if native.available():
        out = native.lzw_decode(data, expected)
        if out is not None:
            return out
    CLEAR, EOI = 256, 257
    out = bytearray()
    dict_base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(dict_base)
    bitbuf = 0
    bitcnt = 0
    width = 9
    prev = None
    pos = 0
    n = len(data)
    while True:
        while bitcnt < width:
            if pos >= n:
                return bytes(out)
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
        bitcnt -= width
        if code == CLEAR:
            table = list(dict_base)
            width = 9
            prev = None
            continue
        if code == EOI:
            return bytes(out)
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF uses EarlyChange: bump width one code early
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def _packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:
            out += bytes([data[i]]) * (257 - h)
            i += 1
    return bytes(out)


def _undo_predictor(arr: np.ndarray, predictor: int, bits: int):
    """Undo TIFF predictors in place on a (rows, cols, spp) block."""
    if predictor == 2:  # horizontal differencing on integer samples
        np.cumsum(arr, axis=1, dtype=arr.dtype, out=arr)
    elif predictor == 3:  # floating-point byte-shuffle + differencing
        rows, cols, spp = arr.shape
        nbytes = bits // 8
        raw = arr.view(np.uint8).reshape(rows, cols * spp * nbytes)
        raw = np.cumsum(raw, axis=1, dtype=np.uint8)
        # bytes of each value are split into planes: reassemble big-endian
        raw = raw.reshape(rows, nbytes, cols * spp)
        shuffled = np.moveaxis(raw, 1, 2)[..., ::-1]  # (rows, cols*spp, nbytes) LE
        flat = np.ascontiguousarray(shuffled).view(arr.dtype.newbyteorder("<"))
        arr[:] = flat.reshape(arr.shape)
    return arr


def _np_dtype(sample_format: int, bits: int) -> np.dtype:
    if sample_format == 3:
        return {16: np.float16, 32: np.float32, 64: np.float64}[bits]
    if sample_format == 2:
        return {8: np.int8, 16: np.int16, 32: np.int32}[bits]
    return {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]


class GeoTIFF:
    """Parsed GeoTIFF: `.data` is (count, height, width), `.profile` metadata,
    `.rpc` an rpc dict when the file carries an RPCCoefficient tag, `.tags`
    the GDAL metadata items (tag 42112) — the rasterio `src.tags()` surface
    the reference reads NITF sun angles from
    (reference create_satellite_dataset.py:104-123)."""

    def __init__(self, data: np.ndarray, profile: Profile):
        self.data = data
        self.profile = profile
        self.rpc = None
        self.tags: dict = {}

    def read(self) -> np.ndarray:
        return self.data


def _parse_gdal_metadata(xml: str) -> dict:
    """GDAL_METADATA XML payload -> {name: value}."""
    def unesc(v):
        return (v.replace("&lt;", "<").replace("&gt;", ">")
                .replace("&quot;", '"').replace("&amp;", "&"))

    out = {}
    for m in re.finditer(r'<Item\s+name="([^"]+)"[^>]*>(.*?)</Item>', xml,
                         re.S):
        out[unesc(m.group(1))] = unesc(m.group(2).strip())
    return out


def _gdal_metadata_xml(items: dict) -> str:
    """Inverse of _parse_gdal_metadata (GDAL's on-disk layout)."""

    def esc(v):
        # quote must be escaped too: the name sits inside an XML attribute
        # and the reader's regex stops at the first unescaped quote
        return (str(v).replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;").replace('"', "&quot;"))

    body = "".join(f'  <Item name="{esc(k)}">{esc(v)}</Item>\n'
                   for k, v in items.items())
    return "<GDALMetadata>\n" + body + "</GDALMetadata>\n"


def rpc_dict_from_tag(vals) -> dict:
    """TIFF RPCCoefficientTag (50844, 92 doubles) -> our rpc dict layout:
    [err_bias, err_rand, LINE_OFF, SAMP_OFF, LAT_OFF, LONG_OFF, HEIGHT_OFF,
     LINE_SCALE, SAMP_SCALE, LAT_SCALE, LONG_SCALE, HEIGHT_SCALE,
     LINE_NUM(20), LINE_DEN(20), SAMP_NUM(20), SAMP_DEN(20)]."""
    v = list(vals)
    return {
        "row_offset": v[2], "col_offset": v[3],
        "lat_offset": v[4], "lon_offset": v[5], "alt_offset": v[6],
        "row_scale": v[7], "col_scale": v[8],
        "lat_scale": v[9], "lon_scale": v[10], "alt_scale": v[11],
        "row_num": v[12:32], "row_den": v[32:52],
        "col_num": v[52:72], "col_den": v[72:92],
    }


def rpc_tag_from_dict(d: dict):
    """Inverse of rpc_dict_from_tag (err terms zeroed)."""
    return (
        [0.0, 0.0, float(d["row_offset"]), float(d["col_offset"]),
         float(d["lat_offset"]), float(d["lon_offset"]), float(d["alt_offset"]),
         float(d["row_scale"]), float(d["col_scale"]),
         float(d["lat_scale"]), float(d["lon_scale"]), float(d["alt_scale"])]
        + [float(x) for x in d["row_num"]] + [float(x) for x in d["row_den"]]
        + [float(x) for x in d["col_num"]] + [float(x) for x in d["col_den"]]
    )


def read_geotiff(path: str) -> GeoTIFF:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"II":
        bo = "<"
    elif buf[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    magic = struct.unpack(bo + "H", buf[2:4])[0]
    if magic != 42:
        raise ValueError(f"{path}: BigTIFF not supported (magic {magic})")
    ifd_off = struct.unpack(bo + "I", buf[4:8])[0]

    tags: dict[int, tuple] = {}
    n_entries = struct.unpack(bo + "H", buf[ifd_off : ifd_off + 2])[0]
    for i in range(n_entries):
        e = ifd_off + 2 + 12 * i
        tag, typ, cnt = struct.unpack(bo + "HHI", buf[e : e + 8])
        size = _TYPE_SIZES.get(typ, 1) * cnt
        if size <= 4:
            raw = buf[e + 8 : e + 8 + size]
        else:
            off = struct.unpack(bo + "I", buf[e + 8 : e + 12])[0]
            raw = buf[off : off + size]
        if typ in _TYPE_FMT:
            vals = struct.unpack(bo + str(cnt) + _TYPE_FMT[typ], raw)
        elif typ == 5 or typ == 10:  # RATIONAL
            ints = struct.unpack(bo + str(2 * cnt) + ("I" if typ == 5 else "i"), raw)
            vals = tuple(ints[2 * k] / max(ints[2 * k + 1], 1) for k in range(cnt))
        elif typ == 2:  # ASCII
            vals = (raw.rstrip(b"\x00").decode("ascii", "replace"),)
        else:
            vals = (raw,)
        tags[tag] = vals

    width = tags[_T_WIDTH][0]
    height = tags[_T_LENGTH][0]
    spp = tags.get(_T_SPP, (1,))[0]
    bits = tags.get(_T_BITS, (8,))[0]
    compression = tags.get(_T_COMPRESSION, (1,))[0]
    predictor = tags.get(_T_PREDICTOR, (1,))[0]
    planar = tags.get(_T_PLANAR, (1,))[0]
    sample_format = tags.get(_T_SAMPLE_FORMAT, (1,))[0]
    dt = np.dtype(_np_dtype(sample_format, bits)).newbyteorder(bo)

    tiled = _T_TILE_OFFSETS in tags
    if tiled:
        tw, th = tags[_T_TILE_WIDTH][0], tags[_T_TILE_LENGTH][0]
        offsets, counts = tags[_T_TILE_OFFSETS], tags[_T_TILE_COUNTS]
    else:
        tw, th = width, tags.get(_T_ROWS_PER_STRIP, (height,))[0]
        offsets, counts = tags[_T_STRIP_OFFSETS], tags[_T_STRIP_COUNTS]

    n_planes = spp if planar == 2 else 1
    chunk_spp = 1 if planar == 2 else spp
    tiles_x = (width + tw - 1) // tw
    tiles_y = (height + th - 1) // th

    img = np.zeros((height, width, spp), dtype=dt.newbyteorder("="))
    for idx, (off, cnt) in enumerate(zip(offsets, counts)):
        plane = idx // (tiles_x * tiles_y)
        t = idx % (tiles_x * tiles_y)
        ty, tx = divmod(t, tiles_x)
        raw = buf[off : off + cnt]
        if compression in (8, 32946):
            raw = zlib.decompress(raw)
        elif compression == 5:
            raw = _lzw_decode(raw, tw * th * chunk_spp * (bits // 8))
        elif compression == 32773:
            raw = _packbits_decode(raw, tw * th * chunk_spp * (bits // 8))
        elif compression != 1:
            raise ValueError(f"{path}: unsupported compression {compression}")

        rows = min(th, height - ty * th)
        cols = min(tw, width - tx * tw)
        need = tw * th * chunk_spp * dt.itemsize
        if len(raw) < need:
            raw = raw + b"\x00" * (need - len(raw))
        block = np.frombuffer(raw[:need], dtype=dt).reshape(th, tw, chunk_spp)
        block = block.astype(dt.newbyteorder("="))
        if predictor != 1:
            block = _undo_predictor(block.copy(), predictor, bits)
        if planar == 2:
            img[ty * th : ty * th + rows, tx * tw : tx * tw + cols, plane] = (
                block[:rows, :cols, 0]
            )
        else:
            img[ty * th : ty * th + rows, tx * tw : tx * tw + cols, :] = (
                block[:rows, :cols, :]
            )

    data = np.moveaxis(img, -1, 0)  # (count, H, W)

    profile = Profile(width=width, height=height, count=spp,
                      dtype=str(data.dtype))
    if _T_MODEL_PIXEL_SCALE in tags and _T_MODEL_TIEPOINT in tags:
        sx, sy = tags[_T_MODEL_PIXEL_SCALE][0], tags[_T_MODEL_PIXEL_SCALE][1]
        tp = tags[_T_MODEL_TIEPOINT]
        # tiepoint: (i, j, k, x, y, z): pixel (i,j) maps to model (x,y)
        i, j, x, y = tp[0], tp[1], tp[3], tp[4]
        profile.transform = Affine(sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)
    elif _T_MODEL_TRANSFORM in tags:
        m = tags[_T_MODEL_TRANSFORM]
        profile.transform = Affine(m[0], m[1], m[3], m[4], m[5], m[7])
    if _T_GEO_KEYS in tags:
        keys = tags[_T_GEO_KEYS]
        for k in range(4, len(keys), 4):
            key_id, loc, cnt, val = keys[k : k + 4]
            if key_id == 3072 and loc == 0:  # ProjectedCSTypeGeoKey
                profile.crs_epsg = int(val)
            elif key_id == 2048 and loc == 0 and profile.crs_epsg is None:
                profile.crs_epsg = int(val)  # GeographicTypeGeoKey
    if _T_GDAL_NODATA in tags:
        try:
            profile.nodata = float(tags[_T_GDAL_NODATA][0])
        except ValueError:
            profile.nodata = float("nan")
    out = GeoTIFF(data, profile)
    if _T_RPC_COEFFICIENTS in tags and len(tags[_T_RPC_COEFFICIENTS]) >= 92:
        out.rpc = rpc_dict_from_tag(tags[_T_RPC_COEFFICIENTS])
    if _T_GDAL_METADATA in tags:
        out.tags = _parse_gdal_metadata(tags[_T_GDAL_METADATA][0])
    return out


# -------------------------------------------------------------------- writing


def write_geotiff(path: str, data: np.ndarray, profile: Optional[Profile] = None,
                  compress: bool = True, rpc: Optional[dict] = None,
                  tags: Optional[dict] = None) -> None:
    """Write (count, H, W) or (H, W) array as a stripped chunky GeoTIFF."""
    if data.ndim == 2:
        data = data[None]
    count, height, width = data.shape
    if profile is None:
        profile = Profile()
    dt = data.dtype
    bits = dt.itemsize * 8
    if dt.kind == "f":
        sample_format = 3
    elif dt.kind == "i":
        sample_format = 2
    else:
        sample_format = 1

    chunky = np.ascontiguousarray(np.moveaxis(data, 0, -1))  # (H, W, C)
    # one strip per ~64 rows keeps memory bounded and files streamable
    rows_per_strip = max(1, min(height, (1 << 20) // max(1, width * count * dt.itemsize)))
    strips = []
    for r0 in range(0, height, rows_per_strip):
        raw = chunky[r0 : r0 + rows_per_strip].tobytes()
        strips.append(zlib.compress(raw, 6) if compress else raw)

    entries = []  # (tag, type, count, value-bytes or int)
    extra = bytearray()  # out-of-line data, offsets fixed later

    def add(tag, typ, values):
        if typ == 2:  # ascii
            payload = values.encode("ascii") + b"\x00"
            cnt = len(payload)
        else:
            fmt = _TYPE_FMT[typ]
            if not isinstance(values, (list, tuple)):
                values = [values]
            cnt = len(values)
            payload = struct.pack("<" + str(cnt) + fmt, *values)
        entries.append([tag, typ, cnt, payload])

    add(_T_WIDTH, 4, width)
    add(_T_LENGTH, 4, height)
    add(_T_BITS, 3, [bits] * count)
    add(_T_COMPRESSION, 3, 8 if compress else 1)
    add(_T_PHOTOMETRIC, 3, 2 if count == 3 and dt == np.uint8 else 1)
    add(_T_SPP, 3, count)
    add(_T_ROWS_PER_STRIP, 4, rows_per_strip)
    add(_T_PLANAR, 3, 1)
    add(_T_SAMPLE_FORMAT, 3, [sample_format] * count)

    t = profile.transform
    if t.as_tuple() != Affine().as_tuple():
        add(_T_MODEL_PIXEL_SCALE, 12, [abs(t.a), abs(t.e), 0.0])
        add(_T_MODEL_TIEPOINT, 12, [0.0, 0.0, 0.0, t.c, t.f, 0.0])
    if profile.crs_epsg is not None:
        epsg = int(profile.crs_epsg)
        geographic = 4000 <= epsg < 5000
        keys = [1, 1, 0, 3,
                1024, 0, 1, (2 if geographic else 1),  # GTModelTypeGeoKey
                1025, 0, 1, 1]  # RasterPixelIsArea
        if geographic:
            keys += [2048, 0, 1, epsg]
        else:
            keys += [3072, 0, 1, epsg]
        keys[3] = len(keys) // 4 - 1
        add(_T_GEO_KEYS, 3, keys)
    if profile.nodata is not None:
        nod = profile.nodata
        add(_T_GDAL_NODATA, 2, "nan" if (isinstance(nod, float) and np.isnan(nod)) else repr(nod))
    if rpc is not None:
        add(_T_RPC_COEFFICIENTS, 12, rpc_tag_from_dict(rpc))
    if tags:
        add(_T_GDAL_METADATA, 2, _gdal_metadata_xml(tags))

    # strip offsets/counts placeholders (patched after layout)
    add(_T_STRIP_OFFSETS, 4, [0] * len(strips))
    add(_T_STRIP_COUNTS, 4, [len(s) for s in strips])

    entries.sort(key=lambda e: e[0])

    header = struct.pack("<2sHI", b"II", 42, 8)
    ifd_off = 8
    n = len(entries)
    ifd_size = 2 + 12 * n + 4
    data_off = ifd_off + ifd_size

    # lay out out-of-line entry payloads
    for e in entries:
        if len(e[3]) > 4:
            e.append(data_off)  # offset of payload
            data_off += len(e[3])
            if data_off % 2:
                data_off += 1
        else:
            e.append(None)

    strip_off0 = data_off
    strip_offsets = []
    off = strip_off0
    for s in strips:
        strip_offsets.append(off)
        off += len(s)

    # patch strip offsets payload
    for e in entries:
        if e[0] == _T_STRIP_OFFSETS:
            e[3] = struct.pack("<" + str(len(strips)) + "I", *strip_offsets)

    out = bytearray()
    out += header
    out += struct.pack("<H", n)
    for tag, typ, cnt, payload, payload_off in entries:
        if payload_off is None:
            val = payload + b"\x00" * (4 - len(payload))
            out += struct.pack("<HHI", tag, typ, cnt) + val
        else:
            out += struct.pack("<HHII", tag, typ, cnt, payload_off)
    out += struct.pack("<I", 0)  # next IFD
    for e in entries:
        if e[4] is not None:
            while len(out) < e[4]:
                out += b"\x00"
            out += e[3]
    while len(out) < strip_off0:
        out += b"\x00"
    for s in strips:
        out += s

    with open(path, "wb") as f:
        f.write(bytes(out))


def crop_geotiff_to_window(src_path: str, dst_path: str, ulx: float, uly: float,
                           lrx: float, lry: float) -> None:
    """Crop a GeoTIFF to a projected window (gdal.Translate -projwin analog,
    sat_utils.py:134-139). Pixel-aligned to the source grid."""
    g = read_geotiff(src_path)
    t = g.profile.transform
    col0 = int(round((ulx - t.c) / t.a))
    row0 = int(round((uly - t.f) / t.e))
    col1 = int(round((lrx - t.c) / t.a))
    row1 = int(round((lry - t.f) / t.e))
    col0, col1 = sorted((col0, col1))
    row0, row1 = sorted((row0, row1))
    h, w = g.data.shape[1:]
    out = np.full((g.data.shape[0], row1 - row0, col1 - col0),
                  g.profile.nodata if g.profile.nodata is not None else 0,
                  dtype=g.data.dtype)
    r0, r1 = max(row0, 0), min(row1, h)
    c0, c1 = max(col0, 0), min(col1, w)
    out[:, r0 - row0 : r1 - row0, c0 - col0 : c1 - col0] = g.data[:, r0:r1, c0:c1]
    prof = g.profile.copy()
    prof.width = col1 - col0
    prof.height = row1 - row0
    prof.transform = Affine(t.a, t.b, t.c + col0 * t.a, t.d, t.e, t.f + row0 * t.e)
    write_geotiff(dst_path, out, prof)
