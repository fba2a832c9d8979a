"""Triangle-mesh extraction from the dense TSDF volume: the port's own
copy of kbslam/mapping/mesh.py, equal to it below this docstring but for
the package name of its imports (it is numpy only; pass it a volume of
numpy arrays, ``convert.tsdf_to_numpy``).

Extends the dense-mapping capability (mapping/dense.py) from a surface
POINT CLOUD to a connected triangle MESH — the artifact downstream
consumers (collision checking, rendering, CAD export) actually want.
The reference has no dense world model at all (its Map.cpp landmarks
are sparse points), so this whole subsystem is an extension; the mesh
step is offline/host-side by design, like ``surface_points``: it runs
on demand (end of run, checkpoint, CLI ``--save-mesh``), never in the
per-frame hot path, so clarity beats device residency here.

Algorithm: **marching tetrahedra** over the voxel grid — each cube is
split into 6 tetrahedra around the (c0, c6) main diagonal and each
tetrahedron emits 0/1/2 triangles where the TSDF changes sign along
its edges. Chosen over classic marching cubes deliberately:

  - no 256-entry topology tables to get wrong (a tet has 16 trivially
    enumerable sign cases), and no ambiguous-face/hole cases — the mesh
    is watertight on a consistently decomposed grid by construction;
  - the whole extraction vectorizes as numpy: one pass builds all
    candidate tets, then 3 case families (1-inside, 2-inside,
    3-inside) emit their triangles in bulk.

Vertices are welded on exact tet-edge identity (edge = ordered pair of
global corner ids), so shared edges across neighboring tets/cubes
produce ONE vertex and the topology is connected, not triangle soup.
Winding is normalized so triangle normals point toward positive TSDF
(free space / the observed side), matching the sign convention of
``integrate`` (sdf = measured_depth − voxel_z).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from kbslam_torch.config import DenseMapConfig
from kbslam_torch.mapping.dense import TSDFState

# cube corner offsets (x, y, z), corner id = index into this list
_CORNERS = np.array([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
], np.int64)

# 6-tet decomposition sharing the c0-c6 diagonal. Every cube face is
# split along the same diagonal direction as its neighbor's opposing
# face (the decomposition is translation-invariant), so faces of
# adjacent cubes tile identically and the surface is crack-free.
_TETS = np.array([
    (0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
    (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6),
], np.int64)


class TriangleMesh(NamedTuple):
    vertices: np.ndarray   # [V, 3] f32 world positions
    faces: np.ndarray      # [F, 3] int32 vertex indices, CCW toward +tsdf


def _edge_vertex(key_a, key_b, s_a, s_b, p_a, p_b):
    """Zero-crossing position on the (a, b) edges + canonical edge keys.

    Keys are global corner ids; (min, max) ordering makes the key — and
    the interpolation below, which is symmetric in (a, b) — identical
    no matter which tet of which cube visits the edge, so welding on
    the key is exact (no coordinate-rounding epsilon games)."""
    lo = np.minimum(key_a, key_b)
    hi = np.maximum(key_a, key_b)
    swap = key_a > key_b
    s0 = np.where(swap, s_b, s_a)
    s1 = np.where(swap, s_a, s_b)
    p0 = np.where(swap[:, None], p_b, p_a)
    p1 = np.where(swap[:, None], p_a, p_b)
    t = s0 / (s0 - s1)          # s0, s1 strictly opposite signs here
    return np.stack([lo, hi], 1), p0 + t[:, None] * (p1 - p0)


def marching_tetrahedra(state: TSDFState, cfg: DenseMapConfig,
                        min_weight: float = 1.0) -> TriangleMesh:
    """Extract the TSDF zero-isosurface as a welded triangle mesh.

    Only cells whose 8 corners are all observed (weight >= min_weight)
    participate — same observability rule as ``surface_points``. tsdf
    values of exactly 0 are treated as inside (< 0 side); sign-free
    cells emit nothing.
    """
    t = np.asarray(state.tsdf, np.float64)
    w = np.asarray(state.weight)
    nx, ny, nz = t.shape

    # --- candidate cells: fully observed and sign-crossing ---------------
    def corners(a):  # [8, X, Y, Z] corner view of cell array
        return np.stack([a[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
                         for dx, dy, dz in _CORNERS])

    cw = corners(w) >= min_weight
    ct = corners(t)
    neg = ct <= 0.0
    live = cw.all(0) & ~(neg.all(0) | (~neg).all(0))
    cell = np.argwhere(live)                               # [C, 3]
    if cell.shape[0] == 0:
        return TriangleMesh(np.zeros((0, 3), np.float32),
                            np.zeros((0, 3), np.int32))

    # global corner ids + per-corner sdf for the live cells
    gx = cell[:, 0][:, None] + _CORNERS[None, :, 0]        # [C, 8]
    gy = cell[:, 1][:, None] + _CORNERS[None, :, 1]
    gz = cell[:, 2][:, None] + _CORNERS[None, :, 2]
    gid = (gx * ny + gy) * nz + gz                         # global corner id
    sdf = t[gx, gy, gz]                                    # [C, 8]
    # exact zeros join the inside set so s0 - s1 never divides by zero
    sdf = np.where(sdf == 0.0, -1e-12, sdf)

    # voxel CENTERS (+0.5 like dense._voxel_centers) — the tsdf value
    # lives at the center, so interpolation must too
    origin = np.asarray(cfg.origin, np.float64)
    pos = origin + ((np.stack([gx, gy, gz], -1).astype(np.float64) + 0.5)
                    * cfg.voxel_size)                      # [C, 8, 3]

    # --- flatten to tets --------------------------------------------------
    tid = gid[:, _TETS].reshape(-1, 4)                     # [C*6, 4]
    ts = sdf[:, _TETS].reshape(-1, 4)
    tp = pos[:, _TETS].reshape(-1, 4, 3)
    inside = ts < 0.0
    count = inside.sum(1)

    keys, verts, faces = [], [], []

    def emit(tri_edges, sel, flip_to):
        """Emit one triangle per selected tet.

        tri_edges: three (a, b) local corner-index pairs, where each
        pair crosses the surface; flip_to: per-tet vector the normal
        must align with (inside -> outside)."""
        base = sum(len(v) for v in verts)
        k3, v3 = [], []
        for a, b in tri_edges:
            k, v = _edge_vertex(tid[sel, a], tid[sel, b],
                                ts[sel, a], ts[sel, b],
                                tp[sel, a], tp[sel, b])
            k3.append(k)
            v3.append(v)
        v0, v1, v2 = v3
        n = np.cross(v1 - v0, v2 - v0)
        flip = (n * flip_to).sum(1) < 0.0
        i0 = base + np.arange(len(v0))
        i1, i2 = i0 + len(v0), i0 + 2 * len(v0)
        f = np.stack([i0, np.where(flip, i2, i1),
                      np.where(flip, i1, i2)], 1)
        keys.extend(k3)
        verts.extend(v3)
        faces.append(f)

    # case family A: exactly one corner on one side -> one triangle.
    # Handles count==1 (one inside) and count==3 (one outside) at once.
    for lone_inside in (True, False):
        cnt = 1 if lone_inside else 3
        for a in range(4):
            rest = [b for b in range(4) if b != a]
            sel = (count == cnt) & (inside[:, a] == lone_inside)
            if not sel.any():
                continue
            out_c = (tp[sel][:, rest].mean(1) if lone_inside
                     else tp[sel, a])
            in_c = (tp[sel, a] if lone_inside
                    else tp[sel][:, rest].mean(1))
            emit([(a, rest[0]), (a, rest[1]), (a, rest[2])],
                 sel, out_c - in_c)

    # case family B: two inside / two outside -> quad -> two triangles
    for ia, ib in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
        oc = [b for b in range(4) if b not in (ia, ib)]
        sel = (count == 2) & inside[:, ia] & inside[:, ib]
        if not sel.any():
            continue
        d = tp[sel][:, oc].mean(1) - tp[sel][:, [ia, ib]].mean(1)
        # quad corners in cyclic order: (ia,oc0) (ia,oc1) (ib,oc1) (ib,oc0)
        emit([(ia, oc[0]), (ia, oc[1]), (ib, oc[1])], sel, d)
        emit([(ia, oc[0]), (ib, oc[1]), (ib, oc[0])], sel, d)

    if not faces:
        return TriangleMesh(np.zeros((0, 3), np.float32),
                            np.zeros((0, 3), np.int32))

    key = np.concatenate(keys, 0)                          # [3F, 2]
    vert = np.concatenate(verts, 0)                        # [3F, 3]
    face = np.concatenate(faces, 0)                        # [F, 3]

    # --- weld: one vertex per unique global edge --------------------------
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    welded = np.zeros((len(uniq), 3), np.float64)
    welded[inv] = vert                                     # any writer wins; all equal
    face = inv[face]
    # drop degenerate triangles (a tet corner sitting numerically ON the
    # surface can collapse an edge)
    ok = ((face[:, 0] != face[:, 1]) & (face[:, 1] != face[:, 2])
          & (face[:, 0] != face[:, 2]))
    return TriangleMesh(welded.astype(np.float32),
                        face[ok].astype(np.int32))


def vertex_normals(mesh: TriangleMesh) -> np.ndarray:
    """Area-weighted per-vertex normals (unit, [V, 3] f32)."""
    v, f = mesh.vertices.astype(np.float64), mesh.faces
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    out = np.zeros_like(v)
    for k in range(3):
        np.add.at(out, f[:, k], n)
    out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
    return out.astype(np.float32)


def save_ply(path: str, mesh: TriangleMesh,
             normals: np.ndarray | None = None) -> None:
    """Write a binary little-endian PLY (the standard interchange the
    reference ecosystem's tooling — MeshLab/Open3D/CloudCompare — reads)."""
    v = np.ascontiguousarray(mesh.vertices, np.float32)
    f = np.ascontiguousarray(mesh.faces, np.int32)
    props = ["property float x", "property float y", "property float z"]
    cols = [v]
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(np.ascontiguousarray(normals, np.float32))
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(v)}", *props,
        f"element face {len(f)}",
        "property list uchar int vertex_indices", "end_header", ""])
    vdata = np.concatenate(cols, axis=1).astype("<f4")
    fdata = np.empty(len(f), dtype=[("n", "u1"), ("i", "<i4", (3,))])
    fdata["n"] = 3
    fdata["i"] = f
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(vdata.tobytes())
        fh.write(fdata.tobytes())


def load_ply(path: str) -> Tuple[TriangleMesh, np.ndarray | None]:
    """Read back meshes written by ``save_ply`` (roundtrip/testing;
    not a general PLY parser)."""
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        nv = nf = 0
        has_n = any(p.endswith(" nx") for p in header)
        for line in header:
            if line.startswith("element vertex"):
                nv = int(line.split()[-1])
            elif line.startswith("element face"):
                nf = int(line.split()[-1])
        width = 6 if has_n else 3
        vdata = np.frombuffer(fh.read(4 * width * nv),
                              dtype="<f4").reshape(nv, width)
        fdata = np.frombuffer(
            fh.read(13 * nf), dtype=[("n", "u1"), ("i", "<i4", (3,))])
    mesh = TriangleMesh(vdata[:, :3].copy(),
                        fdata["i"].astype(np.int32))
    normals = vdata[:, 3:].copy() if has_n else None
    return mesh, normals
