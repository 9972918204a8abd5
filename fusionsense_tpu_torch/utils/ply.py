"""Minimal PLY / PCD point-cloud and mesh I/O (numpy, no open3d).

Counterpart of fusionsense_tpu/utils/ply.py, kept as the port's own copy:
binary little-endian or ascii PLY (points, normals, colors, faces, extra
per-vertex float properties) and ascii or binary PCL .pcd files.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint8": "u1",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def write_ply(
    path, points: np.ndarray, colors: np.ndarray | None = None,
    normals: np.ndarray | None = None, faces: np.ndarray | None = None,
    extra: dict[str, np.ndarray] | None = None,
):
    """Write a binary-little-endian PLY. colors may be float [0,1] or uint8."""
    points = np.asarray(points, np.float32)
    n = len(points)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    cols = [points.astype(np.float32)]
    if normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        cols.append(np.asarray(normals, np.float32))
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols.append(colors)
    if extra:
        for name, arr in extra.items():
            arr = np.asarray(arr, np.float32)
            arr = arr.reshape(n, arr.size // n if n else 1)
            for j in range(arr.shape[1]):
                pname = name if arr.shape[1] == 1 else f"{name}_{j}"
                props.append((pname, "f4"))
            cols.append(arr)

    dtype = np.dtype([(p, t) for p, t in props])
    rec = np.empty(n, dtype=dtype)
    flat = np.concatenate(
        [c.reshape(n, -1).astype(np.float64) for c in cols], axis=1)
    for i, (pname, t) in enumerate(props):
        rec[pname] = flat[:, i].astype(t)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    inv = {"f4": "float", "u1": "uchar", "i4": "int"}
    header += [f"property {inv[t]} {pname}" for pname, t in props]
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())
        if faces is not None:
            faces = np.asarray(faces, np.int32)
            buf = np.empty((len(faces), 13), np.uint8)
            buf[:, 0] = 3
            buf[:, 1:] = faces.astype("<i4").view(np.uint8).reshape(len(faces), 12)
            f.write(buf.tobytes())


def read_ply(path) -> dict:
    """Read ascii or binary-LE PLY. Returns dict with 'points' plus any of
    'colors' (float [0,1]), 'normals', 'faces', and other per-vertex props."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", f"not a ply file: {path}"
        fmt = None
        elements = []  # (name, count, [(prop, dtype) or ('list', prop)])
        cur = None
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property":
                if parts[1] == "list":
                    cur[2].append(("__list__", parts[4], _PLY_DTYPES[parts[2]],
                                   _PLY_DTYPES[parts[3]]))
                else:
                    cur[2].append((parts[2], _PLY_DTYPES[parts[1]]))

        out = {}
        for name, count, props in elements:
            if any(p[0] == "__list__" for p in props):
                # face element: assume uniform triangle lists
                assert fmt.startswith("binary_little")
                cnt_t = np.dtype(props[0][2])
                idx_t = np.dtype(props[0][3])
                item = cnt_t.itemsize + 3 * idx_t.itemsize
                raw = f.read(count * item)
                arr = np.frombuffer(raw, np.uint8).reshape(count, item)
                idx = arr[:, cnt_t.itemsize:].copy().view(idx_t).reshape(count, 3)
                out["faces"] = idx.astype(np.int64)
            else:
                dtype = np.dtype([(p, t) for p, t in props])
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    data = np.array(rows, np.float64)
                    rec = np.empty(count, dtype)
                    for i, (p, t) in enumerate(props):
                        rec[p] = data[:, i]
                else:
                    rec = np.frombuffer(f.read(count * dtype.itemsize), dtype)
                if name == "vertex":
                    names = rec.dtype.names
                    out["points"] = np.stack(
                        [rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
                    if "nx" in names:
                        out["normals"] = np.stack(
                            [rec["nx"], rec["ny"], rec["nz"]], -1).astype(np.float32)
                    if "red" in names:
                        c = np.stack([rec["red"], rec["green"], rec["blue"]], -1)
                        out["colors"] = c.astype(np.float32) / (
                            255.0 if c.dtype != np.float32 else 1.0)
                    for extra_name in names:
                        if extra_name not in ("x", "y", "z", "nx", "ny", "nz",
                                              "red", "green", "blue"):
                            out[extra_name] = np.asarray(rec[extra_name])
    return out


def write_pcd(path, points: np.ndarray, colors: np.ndarray | None = None,
              extra: dict[str, np.ndarray] | None = None):
    """Write an ascii .pcd (PCL format) — the reference's touch/high-grad
    artifacts use .pcd files."""
    points = np.asarray(points, np.float32)
    n = len(points)
    fields, sizes, types, counts, cols = ["x", "y", "z"], ["4"] * 3, ["F"] * 3, ["1"] * 3, [points]
    if colors is not None:
        rgb = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint32)
        packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
        fields.append("rgb"); sizes.append("4"); types.append("U"); counts.append("1")
        cols.append(packed[:, None])
    if extra:
        for name, arr in extra.items():
            arr = np.asarray(arr, np.float32)
            width_ = arr.size // n if n else 1
            arr = arr.reshape(n, width_)
            for j in range(arr.shape[1]):
                fields.append(name if arr.shape[1] == 1 else f"{name}_{j}")
                sizes.append("4"); types.append("F"); counts.append("1")
            cols.append(arr)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        f.write(f"FIELDS {' '.join(fields)}\nSIZE {' '.join(sizes)}\n")
        f.write(f"TYPE {' '.join(types)}\nCOUNT {' '.join(counts)}\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {n}\nDATA ascii\n")
        for i in range(n):
            vals = []
            for c in cols:
                c2 = c.reshape(n, -1)
                for j in range(c2.shape[1]):
                    v = c2[i, j]
                    vals.append(str(int(v)) if c2.dtype.kind in "ui" else f"{v:.6f}")
            f.write(" ".join(vals) + "\n")


def read_pcd(path) -> dict:
    """Read ascii or binary .pcd."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode().strip()
            if line.startswith("#"):
                continue
            k, *v = line.split()
            header[k] = v
            if k == "DATA":
                break
        fields = header["FIELDS"]
        types = header["TYPE"]
        sizes = [int(s) for s in header["SIZE"]]
        n = int(header["POINTS"][0])
        tmap = {("F", 4): "f4", ("F", 8): "f8", ("U", 4): "u4",
                ("U", 1): "u1", ("I", 4): "i4"}
        dtype = np.dtype([(fld, tmap[(t, s)])
                          for fld, t, s in zip(fields, types, sizes)])
        mode = header["DATA"][0]
        if mode == "ascii":
            rows = [f.readline().split() for _ in range(n)]
            data = np.array(rows, np.float64).reshape(n, len(fields))
            rec = np.empty(n, dtype)
            for i, fld in enumerate(fields):
                rec[fld] = data[:, i]
        else:
            rec = np.frombuffer(f.read(n * dtype.itemsize), dtype)
    out = {"points": np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)}
    if "rgb" in fields:
        packed = rec["rgb"].astype(np.uint32)
        out["colors"] = np.stack(
            [(packed >> 16) & 255, (packed >> 8) & 255, packed & 255],
            -1).astype(np.float32) / 255.0
    for fld in fields:
        if fld not in ("x", "y", "z", "rgb"):
            out[fld] = np.asarray(rec[fld])
    return out
