"""Mesh / point-cloud / image IO (the port's own copy of
``gaussian_garments_tpu/utils/io.py``, which it may not import).

OBJ read/write keeps the exact reference format (``utils/io_utils.py:7-62``,
including `f v/vt` faces). PLY is implemented natively (no plyfile in this
environment): binary_little_endian with arbitrary named float32/uint8 vertex
properties, which covers both the 3DGS splat PLYs and colored point clouds.
"""
from __future__ import annotations

import os
from typing import Dict, NamedTuple

import numpy as np


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

def write_obj(d: Dict[str, np.ndarray], filename) -> None:
    """Write {vertices, uvs, faces, texture_faces} to OBJ (reference format)."""
    with open(filename, "w") as f:
        if "vertices" in d:
            for vertex in d["vertices"]:
                f.write(f"v {vertex[0]} {vertex[1]} {vertex[2]}\n")
        if "uvs" in d and d["uvs"] is not None and len(d["uvs"]):
            for uv in d["uvs"]:
                f.write(f"vt {uv[0]} {uv[1]}\n")
        if "faces" in d:
            if "texture_faces" in d and d["texture_faces"] is not None and len(d["texture_faces"]):
                for i, face in enumerate(d["faces"]):
                    face = face + 1
                    t_face = d["texture_faces"][i] + 1
                    f.write(f"f {face[0]}/{t_face[0]} {face[1]}/{t_face[1]} {face[2]}/{t_face[2]}\n")
            else:
                for face in d["faces"]:
                    face = face + 1
                    f.write("f {} {} {}\n".format(face[0], face[1], face[2]))


def read_obj(filename) -> Dict[str, np.ndarray]:
    """Read an OBJ into {vertices, uvs, faces, texture_faces} (0-indexed)."""
    vertices, uvs, faces, texture_faces = [], [], [], []
    have_uv = False
    with open(filename, "r") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 0:
                continue
            if parts[0] == "v":
                vertices.append(tuple(map(float, parts[1:4])))
            elif parts[0] == "vt":
                have_uv = True
                uvs.append(tuple(map(float, parts[1:3])))
            elif parts[0] == "f":
                faces.append(tuple(int(p.split("/")[0]) for p in parts[1:]))
                if have_uv:
                    texture_faces.append(tuple(int(p.split("/")[1]) for p in parts[1:]))
    return {
        "vertices": np.array(vertices, dtype=np.float32),
        "uvs": np.array(uvs, dtype=np.float32),
        "faces": np.array(faces, dtype=np.int64) - 1,
        "texture_faces": np.array(texture_faces, dtype=np.int64) - 1,
    }


# ---------------------------------------------------------------------------
# PLY (native implementation)
# ---------------------------------------------------------------------------

_PLY_DTYPES = {
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "char": ("i1", 1), "int8": ("i1", 1),
    "short": ("i2", 2), "ushort": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
}
_NP_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i1": "char",
              "i2": "short", "u2": "ushort", "i4": "int", "u4": "uint"}


def read_ply(path) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element (and a triangular 'face' element if present)
    of a PLY file (ascii or binary_little_endian) into a dict of per-property
    arrays; faces are returned under key ``"faces"`` as (F,3) int64."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"invalid PLY file {path}")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    count = 0
    props = []  # (name, np dtype char) for the vertex element
    face_count = 0
    face_list_types = None  # (count dtype, index dtype)
    section = None
    for line in header:
        toks = line.strip().split()
        if not toks:
            continue
        if toks[0] == "format":
            fmt = toks[1]
        elif toks[0] == "element":
            section = toks[1]
            if section == "vertex":
                count = int(toks[2])
            elif section == "face":
                face_count = int(toks[2])
        elif toks[0] == "property" and section == "vertex":
            if toks[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((toks[2], _PLY_DTYPES[toks[1]][0]))
        elif toks[0] == "property" and section == "face" and toks[1] == "list":
            face_list_types = (_PLY_DTYPES[toks[2]][0], _PLY_DTYPES[toks[3]][0])

    if fmt == "ascii":
        lines = [l for l in body.decode("ascii").splitlines() if l.strip()]
        rows = np.loadtxt(lines[:count], ndmin=2)
        out = {name: rows[:, i].astype(dt) for i, (name, dt) in enumerate(props)}
        if face_count:
            faces = np.array([[int(x) for x in l.split()[1:4]] for l in lines[count:count + face_count]],
                             dtype=np.int64)
            out["faces"] = faces
        return out
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    dtype = np.dtype([(name, "<" + dt) for name, dt in props])
    arr = np.frombuffer(body, dtype=dtype, count=count)
    out = {name: np.ascontiguousarray(arr[name]) for name, _ in props}
    if face_count and face_list_types is not None:
        cdt, idt = face_list_types
        fdtype = np.dtype([("n", "<" + cdt), ("idx", "<" + idt, 3)])
        faces = np.frombuffer(body, dtype=fdtype, count=face_count,
                              offset=dtype.itemsize * count)
        if not (faces["n"] == 3).all():
            raise ValueError("only triangular PLY faces supported")
        out["faces"] = np.ascontiguousarray(faces["idx"]).astype(np.int64)
    return out


def write_ply(path, arrays: Dict[str, np.ndarray]) -> None:
    """Write named per-vertex property arrays to binary_little_endian PLY."""
    names = list(arrays.keys())
    n = len(next(iter(arrays.values())))
    dtype = np.dtype([(k, arrays[k].dtype.str.lstrip("<>=|")) for k in names])
    out = np.empty(n, dtype=dtype)
    for k in names:
        out[k] = arrays[k]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for k in names:
        header.append(f"property {_NP_TO_PLY[arrays[k].dtype.str.lstrip("<>=|")]} {k}")
    header.append("end_header")
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(out.tobytes())


def fetch_ply(path) -> BasicPointCloud:
    """Read a colored point cloud (reference ``io_utils.py:64-70``)."""
    v = read_ply(path)
    positions = np.vstack([v["x"], v["y"], v["z"]]).T
    colors = np.vstack([v["red"], v["green"], v["blue"]]).T / 255.0
    if "nx" in v:
        normals = np.vstack([v["nx"], v["ny"], v["nz"]]).T
    else:
        normals = np.zeros_like(positions)
    return BasicPointCloud(points=positions, colors=colors, normals=normals)


def store_ply(path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write a colored point cloud (reference ``io_utils.py:72-87``)."""
    normals = np.zeros_like(xyz)
    write_ply(
        path,
        {
            "x": xyz[:, 0].astype(np.float32), "y": xyz[:, 1].astype(np.float32), "z": xyz[:, 2].astype(np.float32),
            "nx": normals[:, 0].astype(np.float32), "ny": normals[:, 1].astype(np.float32), "nz": normals[:, 2].astype(np.float32),
            "red": rgb[:, 0].astype(np.uint8), "green": rgb[:, 1].astype(np.uint8), "blue": rgb[:, 2].astype(np.uint8),
        },
    )


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------

def load_masked_image(image_path, garment_mask_path, fg_mask_path, bg_color=None) -> Dict[str, np.ndarray]:
    """Composite the garment over bg_color and build the penalized mask
    (garment ∪ background); reference ``utils/io_utils.py:90-111``."""
    from PIL import Image

    if bg_color is None:
        bg_color = np.array([0, 1, 0])
    image = np.array(Image.open(image_path)) / 255
    garment_mask = np.array(Image.open(garment_mask_path)) / 255
    if str(garment_mask_path).endswith("jpg"):
        garment_mask = garment_mask[..., 0] > 0.5
    fg_mask = np.array(Image.open(fg_mask_path)) / 255
    bg_mask = 1 - fg_mask
    penalized_mask = (garment_mask + bg_mask).clip(0, 1)
    masked_img = image * garment_mask[..., None] + bg_color * (1 - garment_mask[..., None])
    masked_img = (masked_img * 255).astype(np.uint8)
    return {
        "image": image,
        "mask": garment_mask[..., None],
        "masked_img": masked_img,
        "penalized_mask": penalized_mask,
    }


def save_image(path, img: np.ndarray) -> None:
    """Save a (3,H,W) or (H,W,3) float [0,1] image as PNG."""
    from PIL import Image

    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3, 4) and img.shape[0] < img.shape[-1]:
        img = img.transpose(1, 2, 0)
    if img.shape[-1] == 1:
        img = img[..., 0]
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    if img.dtype != np.uint8:   # uint8 passes through (device-quantized rows)
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    Image.fromarray(img).save(path)
