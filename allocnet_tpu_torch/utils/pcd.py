"""Point-cloud IO + map segmentation (NumPy only, no open3d dependency).

The port's own copy of `allocnet_tpu/utils/pcd.py` (NumPy, unchanged).
Equivalent of the reference's pcd_segmentation.py (crop M3ED clouds into
training map segments, pcd_segmentation.py:27-74): read .pcd files (ASCII or
binary x/y/z), crop into fixed-extent segments with a minimum point count,
and hand them to train/datagen.generate(points=...).
"""

from __future__ import annotations

import numpy as np


def read_pcd(path: str) -> np.ndarray:
    """Minimal PCD reader: x/y/z fields, ascii or binary encoding."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header.get("FIELDS", "x y z").split()
        sizes = list(map(int, header.get("SIZE", "4 4 4").split()))
        types = header.get("TYPE", "F F F").split()
        count = int(header.get("POINTS", header.get("WIDTH", "0")))
        mode = header["DATA"].split()[0]

        if mode == "ascii":
            data = np.loadtxt(f, max_rows=count)
            data = np.atleast_2d(data)
        elif mode == "binary":
            fmt = {("F", 4): "f4", ("F", 8): "f8", ("U", 4): "u4",
                   ("U", 1): "u1", ("I", 4): "i4", ("U", 2): "u2",
                   ("I", 2): "i2", ("I", 1): "i1"}
            dtype = np.dtype([(name, fmt[(t, s)])
                              for name, t, s in zip(fields, types, sizes)])
            raw = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                count=count)
            data = np.stack([raw[n].astype(np.float64)
                             for n in fields], axis=1)
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

    ix = [fields.index(n) for n in ("x", "y", "z")]
    pts = np.asarray(data)[:, ix].astype(np.float64)
    return pts[np.isfinite(pts).all(axis=1)]


def write_pcd(path: str, points: np.ndarray) -> None:
    """ASCII x/y/z writer (for artifact dumps / round-trips)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n")
        f.write("COUNT 1 1 1\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {n}\nDATA ascii\n")
        np.savetxt(f, points, fmt="%.6f")


def crop_segments(
    points: np.ndarray,
    extent=(25.0, 25.0, 5.0),
    stride=(12.5, 12.5),
    min_points: int = 40_000,
) -> list[dict]:
    """Slide an extent-sized window over the cloud's xy footprint; keep crops
    with >= min_points (reference defaults: 25x25x5 m, >= 40k points,
    pcd_segmentation.py:27-74).  Returns dicts with 'points' re-centered to
    the crop origin and 'origin'."""
    if len(points) == 0:
        return []
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    out = []
    ex = np.asarray(extent)
    x = lo[0]
    while x + ex[0] <= hi[0] + 1e-9:
        y = lo[1]
        while y + ex[1] <= hi[1] + 1e-9:
            origin = np.array([x, y, lo[2]])
            inside = np.all((points >= origin) & (points <= origin + ex),
                            axis=1)
            if inside.sum() >= min_points:
                out.append({"points": points[inside] - origin,
                            "origin": origin})
            y += stride[1]
        x += stride[0]
    return out
