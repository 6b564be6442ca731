"""Animated glTF (GLB) playback: node-TRS channels + skinning.

Parity target: ``blender/all_rendering.py:672-698`` (glTF animation
import + cyclic fcurve repeat so short clips loop over the edit video)
and the animated-asset playback path (:867-927).

TPU-first design: instead of Blender's armature evaluation per frame,
the clip is parsed once into flat numpy tables (node hierarchy in
topological order, per-channel keyframes, skin joints + inverse bind
matrices, per-vertex joint/weight tables); ``vertices_at(t)`` evaluates
linear-interpolated TRS → global transforms → linear-blend skinning as
pure vectorized array math.  Surfels carry (triangle, barycentric)
associations so the renderer replays the animation by repositioning
surfels on the deformed mesh each frame.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional

import numpy as np

from autovfx_tpu_torch.edit.mesh_io import _CSIZE, _CTYPE, Mesh

_YUP_TO_ZUP = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    np.float64,
)


def _parse_glb(path: str):
    with open(path, "rb") as f:
        raw = f.read()
    magic, _version, _length = struct.unpack_from("<III", raw, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    off = 12
    gltf, bin_chunk = None, b""
    while off < len(raw):
        clen, ctype = struct.unpack_from("<II", raw, off)
        data = raw[off + 8 : off + 8 + clen]
        if ctype == 0x4E4F534A:
            gltf = json.loads(data)
        elif ctype == 0x004E4942:
            bin_chunk = data
        off += 8 + clen
    return gltf, bin_chunk


def _accessor(gltf, bin_chunk, ai):
    acc = gltf["accessors"][ai]
    bv = gltf["bufferViews"][acc["bufferView"]]
    dtype = np.dtype(_CTYPE[acc["componentType"]])
    ncomp = _CSIZE[acc["type"]]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride", dtype.itemsize * ncomp)
    n = acc["count"]
    if stride == dtype.itemsize * ncomp:
        arr = np.frombuffer(bin_chunk, dtype, n * ncomp, start).reshape(
            n, ncomp
        )
    else:
        arr = np.stack(
            [
                np.frombuffer(bin_chunk, dtype, ncomp, start + i * stride)
                for i in range(n)
            ]
        )
    return arr


def _quat_to_mat(q_xyzw: np.ndarray) -> np.ndarray:
    """(..., 4) xyzw quaternions → (..., 3, 3) rotation matrices."""
    x, y, z, w = (q_xyzw[..., i] for i in range(4))
    n = np.maximum(np.sqrt(x * x + y * y + z * z + w * w), 1e-12)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.stack(
        [
            np.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)], -1),
            np.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)], -1),
            np.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


class AnimatedGLB:
    """Rest mesh + clip evaluator (``vertices_at(t)``, cyclic)."""

    def __init__(self, path: str):
        gltf, bin_chunk = _parse_glb(path)
        self._gltf = gltf
        acc = lambda ai: _accessor(gltf, bin_chunk, ai)

        nodes = gltf.get("nodes", [])
        n_nodes = len(nodes)
        self.parents = np.full(n_nodes, -1, np.int64)
        for i, nd in enumerate(nodes):
            for c in nd.get("children", []):
                self.parents[c] = i
        # topological order (parents before children)
        order, seen = [], set()

        def visit(i):
            if i in seen:
                return
            if self.parents[i] >= 0 and self.parents[i] not in seen:
                visit(self.parents[i])
            seen.add(i)
            order.append(i)

        for i in range(n_nodes):
            visit(i)
        self.order = order

        # static TRS (matrix nodes decomposed implicitly via T·R·S form
        # is not attempted: matrix nodes keep their matrix, unanimated)
        self.static_mat = [None] * n_nodes
        self.t0 = np.zeros((n_nodes, 3))
        self.r0 = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (n_nodes, 1))
        self.s0 = np.ones((n_nodes, 3))
        for i, nd in enumerate(nodes):
            if "matrix" in nd:
                self.static_mat[i] = (
                    np.array(nd["matrix"], np.float64).reshape(4, 4).T
                )
            self.t0[i] = nd.get("translation", [0, 0, 0])
            self.r0[i] = nd.get("rotation", [0, 0, 0, 1])
            self.s0[i] = nd.get("scale", [1, 1, 1])

        # animation channels (first animation; LINEAR/STEP interp)
        self.channels: Dict[int, Dict[str, tuple]] = {}
        self.duration = 0.0
        anims = gltf.get("animations", [])
        if anims:
            anim = anims[0]
            for ch in anim["channels"]:
                tgt = ch["target"]
                node = tgt.get("node")
                if node is None:
                    continue
                smp = anim["samplers"][ch["sampler"]]
                times = acc(smp["input"]).astype(np.float64).reshape(-1)
                vals = acc(smp["output"]).astype(np.float64)
                interp = smp.get("interpolation", "LINEAR")
                if interp == "CUBICSPLINE":  # use the value keys only
                    vals = vals.reshape(len(times), 3, -1)[:, 1]
                self.channels.setdefault(node, {})[tgt["path"]] = (
                    times, vals
                )
                self.duration = max(self.duration, float(times[-1]))

        # skins
        self.skins = []
        for sk in gltf.get("skins", []):
            ibm = (
                acc(sk["inverseBindMatrices"])
                .astype(np.float64)
                .reshape(-1, 4, 4)
                .transpose(0, 2, 1)
                if "inverseBindMatrices" in sk
                else np.tile(np.eye(4), (len(sk["joints"]), 1, 1))
            )
            self.skins.append(
                {"joints": np.asarray(sk["joints"]), "ibm": ibm}
            )

        # primitives: positions + skin bindings + owning node
        self.prims = []
        verts, faces, vcount = [], [], 0
        all_c, all_uv = [], []
        self._texture = None
        base_color = None
        for ni, nd in enumerate(nodes):
            if "mesh" not in nd:
                continue
            for prim in gltf["meshes"][nd["mesh"]]["primitives"]:
                if prim.get("mode", 4) != 4:
                    continue
                pos = acc(prim["attributes"]["POSITION"]).astype(
                    np.float64
                )
                if "COLOR_0" in prim["attributes"]:
                    c = acc(prim["attributes"]["COLOR_0"]).astype(
                        np.float32
                    )
                    if c.max() > 2.0:
                        c = c / 255.0
                    all_c.append(c[:, :3])
                else:
                    all_c.append(None)
                if "TEXCOORD_0" in prim["attributes"]:
                    all_uv.append(
                        acc(prim["attributes"]["TEXCOORD_0"]).astype(
                            np.float32
                        )
                    )
                else:
                    all_uv.append(None)
                mi = prim.get("material")
                if mi is not None and self._texture is None:
                    mat = gltf["materials"][mi]
                    pbr = mat.get("pbrMetallicRoughness", {})
                    if base_color is None:
                        base_color = pbr.get("baseColorFactor")
                    bct = pbr.get("baseColorTexture")
                    if bct is not None:
                        src = gltf["textures"][bct["index"]]["source"]
                        img = gltf["images"][src]
                        if "bufferView" in img:
                            bv = gltf["bufferViews"][img["bufferView"]]
                            blob = bin_chunk[
                                bv.get("byteOffset", 0):
                                bv.get("byteOffset", 0) + bv["byteLength"]
                            ]
                            import io

                            from PIL import Image

                            self._texture = np.asarray(
                                Image.open(io.BytesIO(blob)).convert(
                                    "RGB"
                                )
                            )
                idx = (
                    acc(prim["indices"]).reshape(-1)
                    if "indices" in prim
                    else np.arange(len(pos))
                )
                p = {
                    "node": ni,
                    "skin": nd.get("skin"),
                    "pos": pos,
                    "joints": None,
                    "weights": None,
                    "offset": vcount,
                }
                if (
                    nd.get("skin") is not None
                    and "JOINTS_0" in prim["attributes"]
                    and "WEIGHTS_0" in prim["attributes"]
                ):
                    p["joints"] = acc(
                        prim["attributes"]["JOINTS_0"]
                    ).astype(np.int64)
                    w = acc(prim["attributes"]["WEIGHTS_0"]).astype(
                        np.float64
                    )
                    p["weights"] = w / np.maximum(
                        w.sum(1, keepdims=True), 1e-9
                    )
                self.prims.append(p)
                verts.append(pos)
                faces.append(idx.reshape(-1, 3).astype(np.int64) + vcount)
                vcount += len(pos)
        self._n_verts = vcount
        self.faces = (
            np.concatenate(faces) if faces else np.zeros((0, 3), np.int64)
        )
        self.vertex_colors = None
        if all_c and all(c is not None for c in all_c):
            self.vertex_colors = np.concatenate(all_c)
        elif base_color is not None:
            self.vertex_colors = np.tile(
                np.asarray(base_color[:3], np.float32), (vcount, 1)
            )
        self.uv = (
            np.concatenate(all_uv)
            if all_uv and all(u is not None for u in all_uv)
            else None
        )

    @property
    def animated(self) -> bool:
        return bool(self.channels) and self.duration > 0

    def _globals_at(self, t: float) -> np.ndarray:
        """(N, 4, 4) global node transforms at time t (cyclic repeat —
        the fcurve cycles modifier, all_rendering.py:692-698)."""
        if self.duration > 0:
            t = float(t) % self.duration
        n = len(self.parents)
        tr, ro, sc = self.t0.copy(), self.r0.copy(), self.s0.copy()
        for ni, paths in self.channels.items():
            for path, (times, vals) in paths.items():
                i = np.searchsorted(times, t, side="right") - 1
                i = np.clip(i, 0, len(times) - 2) if len(times) > 1 else 0
                if len(times) == 1:
                    v = vals[0]
                else:
                    t0, t1 = times[i], times[i + 1]
                    w = 0.0 if t1 == t0 else np.clip(
                        (t - t0) / (t1 - t0), 0.0, 1.0
                    )
                    if path == "rotation":  # slerp-lite (nlerp)
                        q0, q1 = vals[i], vals[i + 1]
                        if np.dot(q0, q1) < 0:
                            q1 = -q1
                        v = (1 - w) * q0 + w * q1
                    else:
                        v = (1 - w) * vals[i] + w * vals[i + 1]
                if path == "translation":
                    tr[ni] = v
                elif path == "rotation":
                    ro[ni] = v
                elif path == "scale":
                    sc[ni] = v

        local = np.tile(np.eye(4), (n, 1, 1))
        rot = _quat_to_mat(ro)
        local[:, :3, :3] = rot * sc[:, None, :]
        local[:, :3, 3] = tr
        for i in range(n):
            if self.static_mat[i] is not None and i not in self.channels:
                local[i] = self.static_mat[i]
        glob = np.empty_like(local)
        for i in self.order:
            p = self.parents[i]
            glob[i] = local[i] if p < 0 else glob[p] @ local[i]
        return glob

    def vertices_at(self, t: float) -> np.ndarray:
        """(V, 3) z-up deformed vertices at clip time t (seconds)."""
        glob = self._globals_at(t)
        out = np.empty((self._n_verts, 3))
        for p in self.prims:
            pos = p["pos"]
            if p["joints"] is not None:
                skin = self.skins[p["skin"]]
                jmats = (
                    glob[skin["joints"]] @ skin["ibm"]
                )  # (J, 4, 4)
                m = np.einsum(
                    "vk,vkab->vab", p["weights"],
                    jmats[p["joints"]],
                )  # (V, 4, 4)
                v = (
                    np.einsum("vab,vb->va", m[:, :3, :3], pos)
                    + m[:, :3, 3]
                )
            else:
                m = glob[p["node"]]
                v = pos @ m[:3, :3].T + m[:3, 3]
            out[p["offset"] : p["offset"] + len(pos)] = v
        return (out @ _YUP_TO_ZUP[:3, :3].T).astype(np.float32)

    def rest_mesh(self) -> Mesh:
        """Rest-pose mesh (t=0 evaluation keeps bind pose for skins)."""
        return Mesh(
            vertices=self.vertices_at(0.0),
            faces=self.faces,
            vertex_colors=self.vertex_colors,
            uv=self.uv,
            texture=self._texture,
        )


def load_animated_glb(path: str) -> Optional[AnimatedGLB]:
    """AnimatedGLB if the file has an animation clip, else None."""
    try:
        a = AnimatedGLB(path)
    except (ValueError, KeyError, struct.error):
        return None
    return a if a.animated else None


def surfels_on_deformed(
    surf: dict, verts: np.ndarray, faces: np.ndarray
) -> dict:
    """Reposition surfels (with tri/bary associations) on deformed
    vertices; normals recomputed from the deformed triangles."""
    tri = surf["tri"]
    bary = surf["bary"]  # (S, 3)
    f = faces[tri]
    a, b, c = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    pts = bary[:, 0:1] * a + bary[:, 1:2] * b + bary[:, 2:3] * c
    n = np.cross(b - a, c - a)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    out = dict(surf)
    out["points"] = pts.astype(np.float32)
    out["normals"] = n.astype(np.float32)
    return out
