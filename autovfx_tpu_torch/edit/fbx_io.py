"""Native binary-FBX (7.x) mesh import.

Parity target: the reference imports retrieved assets in glb/fbx/ply/
obj/.blend via Blender's importers (``blender/all_rendering.py:433-468``
— ``bpy.ops.import_scene.fbx``).  This repo has no Blender, so FBX is
parsed natively: the binary node-record tree (32- and 64-bit layouts,
zlib-deflated property arrays), Geometry nodes (vertices, polygon
fans, per-polygon-vertex UV/color layers), Model local TRS composed
through OO connections, and GlobalSettings up-axis + unit scale.

Scope: static meshes (what ``insert_object`` consumes — the mesh is
normalized to a unit box right after import anyway, matching
``all_rendering.py:633-669``).  Skinned/animated FBX payloads load as
their bind-pose geometry; animated retrieval assets are glTF in
practice (wrapper_objaverse.py:29-36 checks glb animation channels).
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"


@dataclass
class FbxNode:
    name: str
    props: List
    children: List["FbxNode"] = field(default_factory=list)

    def find(self, name: str) -> Optional["FbxNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["FbxNode"]:
        return [c for c in self.children if c.name == name]


_ARRAY_TYPES = {
    b"f": ("<f4", 4), b"d": ("<f8", 8), b"l": ("<i8", 8),
    b"i": ("<i4", 4), b"b": ("<i1", 1),
}
_SCALAR_TYPES = {
    b"Y": ("<h", 2), b"C": ("<b", 1), b"I": ("<i", 4),
    b"F": ("<f", 4), b"D": ("<d", 8), b"L": ("<q", 8),
}


def _read_property(buf: memoryview, off: int) -> Tuple[object, int]:
    code = bytes(buf[off:off + 1])
    off += 1
    if code in _SCALAR_TYPES:
        fmt, size = _SCALAR_TYPES[code]
        (val,) = struct.unpack_from(fmt, buf, off)
        return val, off + size
    if code in _ARRAY_TYPES:
        dtype, itemsize = _ARRAY_TYPES[code]
        n, enc, comp_len = struct.unpack_from("<III", buf, off)
        off += 12
        if enc == 1:
            raw = zlib.decompress(bytes(buf[off:off + comp_len]))
            off += comp_len
        else:
            raw = bytes(buf[off:off + n * itemsize])
            off += n * itemsize
        return np.frombuffer(raw, dtype, count=n), off
    if code in (b"S", b"R"):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        raw = bytes(buf[off:off + n])
        return (raw.decode("utf-8", "replace") if code == b"S" else raw), off + n
    raise ValueError(f"unknown FBX property type {code!r} at {off}")


def _read_node(buf: memoryview, off: int, big: bool) -> Tuple[Optional[FbxNode], int]:
    if big:  # version >= 7500: 64-bit offsets, 25-byte null sentinel
        end, nprops, _plen = struct.unpack_from("<QQQ", buf, off)
        off += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", buf, off)
        off += 12
    (name_len,) = struct.unpack_from("<B", buf, off)
    off += 1
    if end == 0 and nprops == 0 and name_len == 0:
        return None, off  # null sentinel terminating a child list
    name = bytes(buf[off:off + name_len]).decode("utf-8", "replace")
    off += name_len
    props = []
    for _ in range(nprops):
        val, off = _read_property(buf, off)
        props.append(val)
    children: List[FbxNode] = []
    while off < end:
        child, off = _read_node(buf, off, big)
        if child is None:
            break
        children.append(child)
    return FbxNode(name, props, children), end


def parse_fbx(path: str) -> Tuple[List[FbxNode], int]:
    """Parse the top-level node list of a binary FBX file."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise ValueError(f"not a binary FBX file: {path}")
    (version,) = struct.unpack_from("<I", data, len(MAGIC))
    big = version >= 7500
    buf = memoryview(data)
    off = len(MAGIC) + 4
    nodes: List[FbxNode] = []
    try:
        while off < len(data):
            node, off = _read_node(buf, off, big)
            if node is None:
                break
            nodes.append(node)
    except (struct.error, zlib.error) as e:
        raise ValueError(f"corrupt/truncated FBX file {path}: {e}") from e
    return nodes, version


# --------------------------------------------------------- scene assembly
def _prop70(node: FbxNode, name: str) -> Optional[List]:
    p70 = node.find("Properties70")
    if p70 is None:
        return None
    for p in p70.find_all("P"):
        if p.props and p.props[0] == name:
            return p.props
    return None


def _euler_xyz_deg(rx: float, ry: float, rz: float) -> np.ndarray:
    """FBX Lcl Rotation (default order XYZ, applied R = Rz @ Ry @ Rx)."""
    cx, sx = np.cos(np.radians(rx)), np.sin(np.radians(rx))
    cy, sy = np.cos(np.radians(ry)), np.sin(np.radians(ry))
    cz, sz = np.cos(np.radians(rz)), np.sin(np.radians(rz))
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def _model_matrix(model: FbxNode) -> np.ndarray:
    t = _prop70(model, "Lcl Translation")
    r = _prop70(model, "Lcl Rotation")
    pre = _prop70(model, "PreRotation")
    s = _prop70(model, "Lcl Scaling")
    m = np.eye(4)
    rot = np.eye(3)
    if pre is not None:
        rot = _euler_xyz_deg(*[float(v) for v in pre[-3:]]) @ rot
    if r is not None:
        rot = rot @ _euler_xyz_deg(*[float(v) for v in r[-3:]])
    scale = np.ones(3) if s is None else np.asarray(
        [float(v) for v in s[-3:]]
    )
    m[:3, :3] = rot * scale[None, :]
    if t is not None:
        m[:3, 3] = [float(v) for v in t[-3:]]
    return m


def _triangulate(poly_idx: np.ndarray) -> np.ndarray:
    """FBX PolygonVertexIndex → (T, 3) triangle fan indices.  The last
    index of each polygon is bit-inverted (~i) as the terminator."""
    tris = []
    poly: List[int] = []
    for raw in poly_idx:
        i = int(raw)
        if i < 0:
            poly.append(~i)
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
            poly = []
        else:
            poly.append(i)
    return np.asarray(tris, np.int64).reshape(-1, 3)


def _layer_to_vertex(
    geom: FbxNode, layer_name: str, data_name: str, index_name: str,
    poly_idx: np.ndarray, n_verts: int, width: int,
) -> Optional[np.ndarray]:
    """Resolve a ByPolygonVertex/ByVertex layer to per-vertex values
    (last polygon-vertex write wins — the asset import contract only
    needs a per-vertex attribute, matching our glb loader)."""
    layer = geom.find(layer_name)
    if layer is None:
        return None
    data_node = layer.find(data_name)
    if data_node is None or not len(data_node.props):
        return None
    flat = np.asarray(data_node.props[0], np.float64)
    if flat.size % width:
        # some exporters write RGB (3-wide) color arrays; adapt rather
        # than aborting the whole mesh import on the reshape
        if width == 4 and flat.size % 3 == 0:
            rgb = flat.reshape(-1, 3)
            flat = np.concatenate(
                [rgb, np.ones((len(rgb), 1), np.float64)], axis=1
            ).reshape(-1)
        else:
            return None
    data = flat.reshape(-1, width)
    mapping_node = layer.find("MappingInformationType")
    mapping = mapping_node.props[0] if mapping_node else "ByPolygonVertex"
    ref_node = layer.find("ReferenceInformationType")
    ref = ref_node.props[0] if ref_node else "Direct"
    idx_node = layer.find(index_name)
    if ref == "IndexToDirect" and idx_node is not None:
        data = data[np.asarray(idx_node.props[0], np.int64)]
    if mapping == "ByVertice" or mapping == "ByVertex":
        return data[:n_verts].astype(np.float32)
    # ByPolygonVertex: scatter to vertices via the polygon index stream
    vert_of_pv = np.where(poly_idx < 0, ~poly_idx, poly_idx)
    out = np.zeros((n_verts, width), np.float64)
    m = min(len(vert_of_pv), len(data))
    out[vert_of_pv[:m]] = data[:m]
    return out.astype(np.float32)


def load_fbx(path: str):
    """Load a binary FBX as a single merged ``mesh_io.Mesh`` in z-up
    meters (the same convention ``load_glb`` produces)."""
    from autovfx_tpu_torch.edit.mesh_io import Mesh

    nodes, _version = parse_fbx(path)
    root = {n.name: n for n in nodes}
    objects = root.get("Objects")
    if objects is None:
        raise ValueError(f"FBX file has no Objects section: {path}")

    # GlobalSettings: up axis + unit scale (FBX native unit is cm)
    up_axis, unit = 1, 1.0
    gs = root.get("GlobalSettings")
    if gs is not None:
        p = _prop70(gs, "UpAxis")
        if p is not None:
            up_axis = int(p[-1])
        p = _prop70(gs, "UnitScaleFactor")
        if p is not None:
            unit = float(p[-1])
    unit_to_m = unit / 100.0

    geoms: Dict[int, FbxNode] = {}
    models: Dict[int, FbxNode] = {}
    for o in objects.children:
        if o.name == "Geometry" and o.props:
            geoms[int(o.props[0])] = o
        elif o.name == "Model" and o.props:
            models[int(o.props[0])] = o

    # OO connections: child -> parent (geometry -> model, model -> model)
    parents: Dict[int, int] = {}
    conns = root.get("Connections")
    if conns is not None:
        for c in conns.find_all("C"):
            if len(c.props) >= 3 and c.props[0] == "OO":
                parents[int(c.props[1])] = int(c.props[2])

    def world_matrix(gid: int) -> np.ndarray:
        m = np.eye(4)
        node_id = parents.get(gid, 0)
        depth = 0
        while node_id in models and depth < 64:
            m = _model_matrix(models[node_id]) @ m
            node_id = parents.get(node_id, 0)
            depth += 1
        return m

    all_v, all_f, all_c, all_uv = [], [], [], []
    vcount = 0
    for gid, geom in geoms.items():
        v_node = geom.find("Vertices")
        i_node = geom.find("PolygonVertexIndex")
        if v_node is None or i_node is None or not len(v_node.props):
            continue
        v = np.asarray(v_node.props[0], np.float64).reshape(-1, 3)
        poly_idx = np.asarray(i_node.props[0], np.int64)
        f = _triangulate(poly_idx)
        m = world_matrix(gid)
        v = v @ m[:3, :3].T + m[:3, 3]
        colors = _layer_to_vertex(
            geom, "LayerElementColor", "Colors", "ColorIndex",
            poly_idx, len(v), 4,
        )
        uv = _layer_to_vertex(
            geom, "LayerElementUV", "UV", "UVIndex", poly_idx, len(v), 2,
        )
        all_v.append(v)
        all_f.append(f + vcount)
        all_c.append(None if colors is None else colors[:, :3])
        all_uv.append(uv)
        vcount += len(v)

    if not all_v:
        raise ValueError(f"FBX file has no mesh geometry: {path}")
    v = np.concatenate(all_v) * unit_to_m
    f = np.concatenate(all_f)
    # up-axis: FBX UpAxis 1 = Y-up (convert to our z-up), 2 = already z-up
    if up_axis == 1:  # (x, y, z)_yup -> (x, -z, y)_zup, same as load_glb
        v = v @ np.array(
            [[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64
        ).T
    colors = (
        np.concatenate([c for c in all_c])
        if all(c is not None for c in all_c) and all_c else None
    )
    uv = (
        np.concatenate([u for u in all_uv])
        if all(u is not None for u in all_uv) and all_uv else None
    )
    return Mesh(
        v.astype(np.float32), f,
        vertex_colors=colors, uv=uv,
    )
