"""PLY point-cloud / mesh I/O.

Port of `vslam_tpu/io/ply.py`: points (N, 3) with optional normals,
uint8 colors and faces, binary little-endian by default or ASCII, and a
reader for round trips. The writer produces the same bytes as the JAX
package's for the same arrays (the binary rows with colors are packed
through one structured array rather than row by row).
"""

from __future__ import annotations

import struct

import numpy as np


def _as_numpy(x, dtype=None):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def save_ply(path, points, colors=None, normals=None, faces=None, ascii=False):
    """Write points (N, 3) [+ colors (N, 3) uint8, or floats in [0, 1]]
    [+ normals (N, 3)] [+ faces]. Arrays may be numpy or tensors."""
    points = _as_numpy(points, np.float32)
    n = len(points)
    has_c = colors is not None
    has_n = normals is not None
    if has_c:
        colors = _as_numpy(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    if has_n:
        normals = _as_numpy(normals, np.float32)

    header = ["ply"]
    header.append("format ascii 1.0" if ascii else "format binary_little_endian 1.0")
    header.append(f"element vertex {n}")
    header += ["property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    if ascii:
        with open(path, "w") as f:
            f.write("\n".join(header) + "\n")
            for i in range(n):
                row = list(points[i])
                if has_n:
                    row += list(normals[i])
                line = " ".join(f"{v:.6f}" for v in row)
                if has_c:
                    line += " " + " ".join(str(int(v)) for v in colors[i])
                f.write(line + "\n")
            if faces is not None:
                for face in faces:
                    f.write(f"{len(face)} " + " ".join(str(int(v)) for v in face) + "\n")
        return
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        floats = np.concatenate([points] + ([normals] if has_n else []), axis=-1).astype("<f4")
        if has_c:
            rows = np.empty(n, dtype=[("f", "<f4", (floats.shape[1],)), ("c", "u1", (3,))])
            rows["f"] = floats
            rows["c"] = colors
            f.write(rows.tobytes())
        else:
            f.write(floats.tobytes())
        if faces is not None:
            for face in faces:
                f.write(struct.pack("<B", len(face)))
                f.write(np.asarray(face, dtype="<i4").tobytes())


def load_ply(path):
    """Minimal PLY reader (ascii + binary_le) -> dict with points/colors/
    normals/faces (whatever is present)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    body = data[head_end:]

    fmt = "ascii" if any("format ascii" in h for h in header) else "binary"
    n_vertex = n_face = 0
    props = []
    cur = None
    for h in header:
        t = h.split()
        if t[0] == "element":
            cur = t[1]
            if cur == "vertex":
                n_vertex = int(t[2])
            elif cur == "face":
                n_face = int(t[2])
        elif t[0] == "property" and cur == "vertex":
            props.append((t[-1], t[1]))

    out = {}
    if fmt == "ascii":
        lines = body.decode().splitlines()
        vals = np.array(
            [[float(x) for x in ln.split()] for ln in lines[:n_vertex]], dtype=np.float64
        )
        idx = {name: i for i, (name, _) in enumerate(props)}
        out["points"] = vals[:, [idx["x"], idx["y"], idx["z"]]].astype(np.float32)
        if "red" in idx:
            out["colors"] = vals[:, [idx["red"], idx["green"], idx["blue"]]].astype(np.uint8)
        if "nx" in idx:
            out["normals"] = vals[:, [idx["nx"], idx["ny"], idx["nz"]]].astype(np.float32)
        if n_face:
            out["faces"] = [
                [int(x) for x in ln.split()[1:]] for ln in lines[n_vertex : n_vertex + n_face]
            ]
    else:
        dtype_map = {"float": "<f4", "uchar": "u1", "int": "<i4", "double": "<f8"}
        np_dtype = np.dtype([(name, dtype_map[t]) for name, t in props])
        verts = np.frombuffer(body, dtype=np_dtype, count=n_vertex)
        out["points"] = np.stack([verts["x"], verts["y"], verts["z"]], -1)
        if "red" in np_dtype.names:
            out["colors"] = np.stack([verts["red"], verts["green"], verts["blue"]], -1)
        if "nx" in np_dtype.names:
            out["normals"] = np.stack([verts["nx"], verts["ny"], verts["nz"]], -1)
        if n_face:
            off = n_vertex * np_dtype.itemsize
            faces = []
            for _ in range(n_face):
                cnt = body[off]
                off += 1
                faces.append(np.frombuffer(body, dtype="<i4", count=cnt, offset=off).tolist())
                off += 4 * cnt
            out["faces"] = faces
    return out
