"""Mesh IO: OBJ read/write, PLY meshes, minimal GLB (glTF-binary) reader.

The reference leans on trimesh/open3d (edit_utils.py, extract/,
blender/all_rendering.py:433-468 imports glb/fbx/ply/obj); this module
provides the needed subset natively: triangles + vertex colors + one
baseColor texture, enough for Objaverse assets and the pipeline's own
OBJ/PLY artifacts.
"""
from __future__ import annotations

import json
import os
import struct
from typing import NamedTuple, Optional

import numpy as np


class Mesh(NamedTuple):
    vertices: np.ndarray  # (V, 3) f32
    faces: np.ndarray  # (F, 3) int64
    vertex_colors: Optional[np.ndarray] = None  # (V, 3) f32 0..1
    uv: Optional[np.ndarray] = None  # (V, 2) f32
    texture: Optional[np.ndarray] = None  # (H, W, 3) uint8
    normals: Optional[np.ndarray] = None  # (V, 3)

    @property
    def bounds(self):
        return self.vertices.min(0), self.vertices.max(0)

    def bottom_center(self) -> np.ndarray:
        """get_bottom_center_of_mesh (gaussians_utils.py:15-35)."""
        lo, hi = self.bounds
        return np.array(
            [(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, lo[2]], np.float32
        )

    def center(self) -> np.ndarray:
        lo, hi = self.bounds
        return ((lo + hi) / 2).astype(np.float32)

    def extents(self) -> np.ndarray:
        lo, hi = self.bounds
        return (hi - lo).astype(np.float32)

    def normalized_to_unit_box(self) -> "Mesh":
        """Normalize to unit box about center (all_rendering.py:633-669
        insert normalization: merge->origin to center->unit box)."""
        lo, hi = self.bounds
        scale = 1.0 / max(float((hi - lo).max()), 1e-9)
        center = (lo + hi) / 2
        return self._replace(
            vertices=((self.vertices - center) * scale).astype(np.float32)
        )

    def face_normals(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)


# ---- OBJ ------------------------------------------------------------------------


def load_obj(path: str) -> Mesh:
    verts, faces, uvs, uv_faces = [], [], [], []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx = []
                tidx = []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    idx.append(int(parts[0]) - 1)
                    if len(parts) > 1 and parts[1]:
                        tidx.append(int(parts[1]) - 1)
                for i in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[i], idx[i + 1]])
                    if tidx:
                        uv_faces.append([tidx[0], tidx[i], tidx[i + 1]])
    v = np.asarray(verts, np.float32)
    uv = None
    if uvs and uv_faces:
        # re-index uv per vertex (approximate: last-wins)
        uv_arr = np.asarray(uvs, np.float32)
        uv = np.zeros((len(v), 2), np.float32)
        fa = np.asarray(faces, np.int64).reshape(-1)
        ta = np.asarray(uv_faces, np.int64).reshape(-1)
        uv[fa] = uv_arr[ta]
    return Mesh(
        vertices=v,
        faces=np.asarray(faces, np.int64),
        uv=uv,
        texture=_load_obj_texture(path),
    )


def _load_obj_texture(obj_path: str):
    mtl = obj_path[:-4] + ".mtl"
    if not os.path.exists(mtl):
        return None
    tex_file = None
    for line in open(mtl, errors="ignore"):
        if line.strip().startswith("map_Kd"):
            tex_file = line.split()[-1]
            break
    if tex_file is None:
        return None
    tex_path = os.path.join(os.path.dirname(obj_path), tex_file)
    if not os.path.exists(tex_path):
        return None
    from PIL import Image

    return np.asarray(Image.open(tex_path).convert("RGB"))


def save_obj(path: str, mesh: Mesh) -> None:
    with open(path, "w") as f:
        f.write("# autovfx_tpu\n")
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if mesh.uv is not None:
            for t in mesh.uv:
                f.write(f"vt {t[0]} {t[1]}\n")
            for face in mesh.faces + 1:
                f.write(
                    f"f {face[0]}/{face[0]} {face[1]}/{face[1]} "
                    f"{face[2]}/{face[2]}\n"
                )
        else:
            for face in mesh.faces + 1:
                f.write(f"f {face[0]} {face[1]} {face[2]}\n")


# ---- PLY (triangle meshes) -------------------------------------------------------


def load_ply_mesh(path: str) -> Mesh:
    with open(path, "rb") as f:
        raw = f.read()
    header_end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:header_end].decode("ascii", errors="ignore")
    lines = header.strip().split("\n")
    fmt = next(l for l in lines if l.startswith("format")).split()[1]
    counts = {}
    props = {"vertex": [], "face": []}
    cur = None
    for line in lines:
        if line.startswith("element"):
            _, name, cnt = line.split()
            counts[name] = int(cnt)
            cur = name
        elif line.startswith("property") and cur in props:
            props[cur].append(line.split()[1:])

    nv = counts.get("vertex", 0)
    nf = counts.get("face", 0)
    type_map = {
        "float": "<f4", "float32": "<f4", "double": "<f8",
        "uchar": "u1", "uint8": "u1", "char": "i1",
        "short": "<i2", "ushort": "<u2",
        "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    }
    if fmt == "ascii":
        body = raw[header_end:].decode("ascii").strip().split("\n")
        vdata = np.array(
            [[float(x) for x in body[i].split()] for i in range(nv)]
        )
        names = [p[-1] for p in props["vertex"]]
        vx = vdata[:, [names.index("x"), names.index("y"), names.index("z")]]
        colors = None
        if "red" in names:
            ci = [names.index(c) for c in ("red", "green", "blue")]
            colors = vdata[:, ci] / 255.0
        faces = np.array(
            [
                [int(x) for x in body[nv + i].split()[1:4]]
                for i in range(nf)
            ],
            np.int64,
        )
        return Mesh(vx.astype(np.float32), faces,
                    vertex_colors=None if colors is None else colors.astype(np.float32))

    vdt = np.dtype(
        [(p[-1], type_map[p[0]]) for p in props["vertex"]]
    )
    vdata = np.frombuffer(raw, vdt, count=nv, offset=header_end)
    vx = np.stack([vdata["x"], vdata["y"], vdata["z"]], 1).astype(np.float32)
    colors = None
    if "red" in vdt.names:
        colors = np.stack(
            [vdata["red"], vdata["green"], vdata["blue"]], 1
        ).astype(np.float32) / 255.0
    off = header_end + vdt.itemsize * nv
    # face lists: (count_type, index_type)
    fprop = props["face"][0]
    cnt_t = np.dtype(type_map[fprop[1]])
    idx_t = np.dtype(type_map[fprop[2]])
    faces = np.empty((nf, 3), np.int64)
    buf = raw
    for i in range(nf):
        c = int(np.frombuffer(buf, cnt_t, 1, off)[0])
        off += cnt_t.itemsize
        idx = np.frombuffer(buf, idx_t, c, off)
        off += idx_t.itemsize * c
        faces[i] = idx[:3]
    return Mesh(vx, faces, vertex_colors=colors)


def save_ply_mesh(path: str, mesh: Mesh) -> None:
    nv, nf = len(mesh.vertices), len(mesh.faces)
    has_c = mesh.vertex_colors is not None
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {nv}\n"
        "property float x\nproperty float y\nproperty float z\n"
        + ("property uchar red\nproperty uchar green\nproperty uchar blue\n"
           if has_c else "")
        + f"element face {nf}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if has_c:
            vdt = np.dtype(
                [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                 ("r", "u1"), ("g", "u1"), ("b", "u1")]
            )
            rec = np.zeros(nv, vdt)
            rec["x"], rec["y"], rec["z"] = mesh.vertices.T
            c = np.clip(mesh.vertex_colors * 255, 0, 255).astype(np.uint8)
            rec["r"], rec["g"], rec["b"] = c.T
            f.write(rec.tobytes())
        else:
            f.write(mesh.vertices.astype("<f4").tobytes())
        fdt = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
        rec = np.zeros(nf, fdt)
        rec["n"] = 3
        rec["i"] = mesh.faces.astype(np.int32)
        f.write(rec.tobytes())


# ---- GLB (binary glTF) ------------------------------------------------------------

_CTYPE = {5120: "i1", 5121: "u1", 5122: "<i2", 5123: "<u2",
          5125: "<u4", 5126: "<f4"}
_CSIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def load_glb(path: str) -> Mesh:
    """Minimal GLB reader: merged triangle primitives, baseColor
    texture/factor, vertex colors.  Node transforms are applied."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, version, _length = struct.unpack_from("<III", raw, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    off = 12
    gltf = None
    bin_chunk = b""
    while off < len(raw):
        clen, ctype = struct.unpack_from("<II", raw, off)
        data = raw[off + 8 : off + 8 + clen]
        if ctype == 0x4E4F534A:
            gltf = json.loads(data)
        elif ctype == 0x004E4942:
            bin_chunk = data
        off += 8 + clen

    def read_accessor(ai):
        acc = gltf["accessors"][ai]
        bv = gltf["bufferViews"][acc["bufferView"]]
        dtype = np.dtype(_CTYPE[acc["componentType"]])
        ncomp = _CSIZE[acc["type"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", dtype.itemsize * ncomp)
        n = acc["count"]
        if stride == dtype.itemsize * ncomp:
            arr = np.frombuffer(
                bin_chunk, dtype, n * ncomp, start
            ).reshape(n, ncomp)
        else:
            arr = np.stack(
                [
                    np.frombuffer(
                        bin_chunk, dtype, ncomp, start + i * stride
                    )
                    for i in range(n)
                ]
            )
        return arr

    def node_transform(node):
        if "matrix" in node:
            return np.array(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        s = node.get("scale", [1, 1, 1])
        r = node.get("rotation", [0, 0, 0, 1])  # xyzw!
        t = node.get("translation", [0, 0, 0])
        x, y, z, w = r
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = rot @ np.diag(s)
        m[:3, 3] = t
        return m

    all_v, all_f, all_c, all_uv = [], [], [], []
    tex_img = None
    base_color_factor = None
    vcount = 0

    def visit(ni, parent):
        nonlocal vcount, tex_img, base_color_factor
        node = gltf["nodes"][ni]
        m = parent @ node_transform(node)
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            for prim in mesh["primitives"]:
                if prim.get("mode", 4) != 4:
                    continue
                pos = read_accessor(prim["attributes"]["POSITION"]).astype(
                    np.float64
                )
                pos = pos @ m[:3, :3].T + m[:3, 3]
                if "indices" in prim:
                    idx = read_accessor(prim["indices"]).reshape(-1)
                else:
                    idx = np.arange(len(pos))
                faces = idx.reshape(-1, 3).astype(np.int64) + vcount
                all_v.append(pos.astype(np.float32))
                all_f.append(faces)
                if "COLOR_0" in prim["attributes"]:
                    c = read_accessor(prim["attributes"]["COLOR_0"]).astype(
                        np.float32
                    )
                    if c.max() > 2.0:
                        c = c / 255.0
                    all_c.append(c[:, :3])
                else:
                    all_c.append(None)
                if "TEXCOORD_0" in prim["attributes"]:
                    uv = read_accessor(
                        prim["attributes"]["TEXCOORD_0"]
                    ).astype(np.float32)
                    all_uv.append(uv)
                else:
                    all_uv.append(None)
                # material: first baseColor texture/factor wins
                mi = prim.get("material")
                if mi is not None and tex_img is None:
                    mat = gltf["materials"][mi]
                    pbr = mat.get("pbrMetallicRoughness", {})
                    if base_color_factor is None:
                        base_color_factor = pbr.get("baseColorFactor")
                    bct = pbr.get("baseColorTexture")
                    if bct is not None:
                        src = gltf["textures"][bct["index"]]["source"]
                        img = gltf["images"][src]
                        bv = gltf["bufferViews"][img["bufferView"]]
                        blob = bin_chunk[
                            bv.get("byteOffset", 0):
                            bv.get("byteOffset", 0) + bv["byteLength"]
                        ]
                        import io

                        from PIL import Image

                        tex_img = np.asarray(
                            Image.open(io.BytesIO(blob)).convert("RGB")
                        )
                vcount += len(pos)
        for ci in node.get("children", []):
            visit(ci, m)

    scene = gltf.get("scene", 0)
    # glTF is y-up; Blender/our world is z-up (all_rendering.py import
    # applies the same conversion)
    yup_to_zup = np.array(
        [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        np.float64,
    )
    for ni in gltf["scenes"][scene]["nodes"]:
        visit(ni, yup_to_zup)

    v = np.concatenate(all_v) if all_v else np.zeros((0, 3), np.float32)
    f = np.concatenate(all_f) if all_f else np.zeros((0, 3), np.int64)
    colors = None
    if all_c and all(c is not None for c in all_c):
        colors = np.concatenate(all_c)
    elif base_color_factor is not None:
        colors = np.tile(
            np.asarray(base_color_factor[:3], np.float32), (len(v), 1)
        )
    uv = None
    if all_uv and all(u is not None for u in all_uv):
        uv = np.concatenate(all_uv)
    return Mesh(v, f, vertex_colors=colors, uv=uv, texture=tex_img)


def load_mesh(path: str) -> Mesh:
    """Load any reference-supported asset format
    (all_rendering.py:433-468 imports glb/fbx/ply/obj/.blend)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        return load_ply_mesh(path)
    if ext in (".glb", ".gltf"):
        return load_glb(path)
    if ext == ".fbx":
        from autovfx_tpu_torch.edit.fbx_io import load_fbx

        return load_fbx(path)
    if ext == ".blend":
        # The reference itself sidesteps .blend outside Blender by
        # switching to a same-stem .glb (gaussians_utils.py:9-12); we
        # accept any sibling in a format we parse natively.
        stem = os.path.splitext(path)[0]
        for alt in (".glb", ".gltf", ".obj", ".ply", ".fbx"):
            if os.path.exists(stem + alt):
                return load_mesh(stem + alt)
        raise ValueError(
            f"native .blend parsing is unsupported; place a converted "
            f"sibling next to it (e.g. {stem}.glb)"
        )
    raise ValueError(f"unsupported mesh format: {path}")
