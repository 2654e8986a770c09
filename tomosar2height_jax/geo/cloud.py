"""Point-cloud file I/O (host, pure numpy — no laspy/open3d).

Capability parity with reference utils/io_cloud.py: ``load_pc`` (:8-31) for
las/npy/npz/xyz/pts/txt/ply, ``load_las_as_numpy`` (:34-50) via a native LAS
1.1-1.4 header/point parser, and ``save_pc_to_ply`` (:53-72) writing binary
little-endian PLY.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

# LAS point record: offset of x,y,z int32 triplet is always 0; record length varies.
_LAS_SUPPORTED_VERSIONS = {(1, 0), (1, 1), (1, 2), (1, 3), (1, 4)}


def load_las_as_numpy(las_path: str) -> np.ndarray:
    """Parse a .las file and return (N, 3) float64 world coordinates.

    Reads the public header block (LAS 1.0-1.4), applies scale/offset to the raw
    int32 x/y/z of each point record. Compressed .laz is not supported.
    Prefers the C++ reader (native ``ts_las_read``); this numpy path is the
    fallback and the parity oracle.
    """
    try:
        from tomosar2height_jax import native

        out = native.las_read(las_path)
        if out is not None:
            return out
    except ValueError:
        pass  # fall through to the numpy parser for a precise error message
    with open(las_path, "rb") as f:
        header = f.read(375)
        if header[:4] != b"LASF":
            raise ValueError(f"Not a LAS file: {las_path}")
        ver_major, ver_minor = header[24], header[25]
        if (ver_major, ver_minor) not in _LAS_SUPPORTED_VERSIONS:
            raise ValueError(f"Unsupported LAS version {ver_major}.{ver_minor}")
        offset_to_points = struct.unpack_from("<I", header, 96)[0]
        point_format = header[104]
        if point_format >= 128:
            raise ValueError("LAZ (compressed) point formats are not supported")
        record_len = struct.unpack_from("<H", header, 105)[0]
        n_points = struct.unpack_from("<I", header, 107)[0]
        sx, sy, sz = struct.unpack_from("<3d", header, 131)
        ox, oy, oz = struct.unpack_from("<3d", header, 155)
        if (ver_major, ver_minor) >= (1, 4) and n_points == 0:
            # extended point count lives at offset 247
            n_points = struct.unpack_from("<Q", header, 247)[0]

        f.seek(offset_to_points)
        raw = f.read(n_points * record_len)

    rec = np.frombuffer(raw, dtype=np.uint8)
    rec = rec[: n_points * record_len].reshape(n_points, record_len)
    xyz_raw = rec[:, :12].copy().view("<i4").reshape(n_points, 3).astype(np.float64)
    xyz = xyz_raw * np.array([sx, sy, sz]) + np.array([ox, oy, oz])
    return xyz


def save_las(las_path: str, points: np.ndarray, scale: float = 0.001) -> None:
    """Write a minimal LAS 1.2 point-format-0 file (for fixtures / interchange)."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    mins = pts.min(axis=0) if n else np.zeros(3)
    maxs = pts.max(axis=0) if n else np.zeros(3)
    offset = mins
    header_size = 227
    record_len = 20
    header = bytearray(header_size)
    header[0:4] = b"LASF"
    header[24] = 1
    header[25] = 2
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<I", header, 96, header_size)  # offset to point data
    struct.pack_into("<I", header, 100, 0)  # no VLRs
    header[104] = 0
    struct.pack_into("<H", header, 105, record_len)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, scale, scale, scale)
    struct.pack_into("<3d", header, 155, *offset)
    struct.pack_into("<6d", header, 179, maxs[0], mins[0], maxs[1], mins[1], maxs[2], mins[2])

    raw = np.zeros((n, record_len), dtype=np.uint8)
    xyz_int = np.round((pts - offset) / scale).astype("<i4")
    raw[:, :12] = xyz_int.view(np.uint8).reshape(n, 12)
    with open(las_path, "wb") as f:
        f.write(bytes(header))
        f.write(raw.tobytes())


def load_ply(ply_path: str) -> np.ndarray:
    """Read x/y/z vertex properties from ASCII or binary_little_endian PLY."""
    with open(ply_path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"Malformed PLY: {ply_path}")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    n_vertex = 0
    props = []  # (name, dtype) in order, for the vertex element
    in_vertex = False
    type_map = {
        "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
        "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
        "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
        "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    }
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n_vertex = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise NotImplementedError("list properties in vertex element")
            props.append((parts[2], type_map[parts[1]]))

    names = [p[0] for p in props]
    if fmt == "ascii":
        rows = np.loadtxt(
            [ln for ln in body.decode("ascii").splitlines() if ln.strip()][:n_vertex],
            dtype=np.float64, ndmin=2,
        )
        cols = {nm: rows[:, i] for i, nm in enumerate(names)}
    elif fmt == "binary_little_endian":
        dt = np.dtype([(nm, "<" + t) for nm, t in props])
        rows = np.frombuffer(body, dtype=dt, count=n_vertex)
        cols = {nm: rows[nm].astype(np.float64) for nm in names}
    else:
        raise NotImplementedError(f"PLY format {fmt}")
    return np.stack([cols["x"], cols["y"], cols["z"]], axis=1)


def save_pc_to_ply(pc_path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Write points (+ optional float colors in [0,1]) to binary little-endian PLY.

    Parity: reference utils/io_cloud.py:53-72 (open3d writer).
    """
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    if not pc_path.lower().endswith(".ply"):
        pc_path = pc_path + ".ply"

    fields = [("x", "<f8"), ("y", "<f8"), ("z", "<f8")]
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property double x",
        "property double y",
        "property double z",
    ]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    rec = np.zeros(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if colors is not None:
        cc = np.clip(np.asarray(colors, dtype=np.float64), 0.0, 1.0)
        rec["red"] = (cc[:, 0] * 255).astype(np.uint8)
        rec["green"] = (cc[:, 1] * 255).astype(np.uint8)
        rec["blue"] = (cc[:, 2] * 255).astype(np.uint8)

    with open(pc_path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def load_pc(pc_path: str) -> np.ndarray:
    """Load a point cloud from las/npy/npz/ply/xyz/pts/txt (io_cloud.py:8-31)."""
    ext = pc_path.split(".")[-1].lower()
    if ext == "las":
        return load_las_as_numpy(pc_path)
    if ext == "npy":
        return np.load(pc_path)
    if ext == "npz":
        with np.load(pc_path) as z:
            key = "pts" if "pts" in z else list(z.keys())[0]
            return z[key]
    if ext == "ply":
        return load_ply(pc_path)
    if ext in ("xyz", "pts", "txt", "xyzn", "xyzrgb"):
        arr = np.loadtxt(pc_path, dtype=np.float64, ndmin=2)
        return arr[:, :3]
    raise TypeError(f"Unknown point cloud file type: {ext}")
