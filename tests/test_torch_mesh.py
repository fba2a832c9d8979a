"""The port's copy of kbslam/mapping/mesh.py on the port's volumes.

The cases of tests/test_mesh.py: the sphere's geometry and topology, the
mesh of a fused plane against its surface points, empty and sign-free
volumes, the PLY round trip and the CLI's ``--save-mesh``. Each mesh the
port makes is bit-equal to the one ``kbslam.mapping.mesh`` makes from
the same numpy volume, and the PLY files the two write are equal byte
for byte.
"""
import json
import sys
from io import StringIO

import numpy as np
import pytest
import torch

from kbslam.config import DenseMapConfig
from kbslam.io.synthetic import render_sequence
from kbslam.mapping import mesh as jmesh
from kbslam_torch import convert
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.mapping import dense as tdense
from kbslam_torch.mapping import mesh as tmesh
from test_torch_raycast import sphere_state

torch.set_num_threads(1)


def both_meshes(vol, cfg):
    """The port's mesh of ``vol`` (numpy arrays), after asserting it
    bit-equal to the JAX package's."""
    t = tmesh.marching_tetrahedra(tdense.TSDFState(*vol), cfg)
    j = jmesh.marching_tetrahedra(vol, cfg)
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_array_equal(tmesh.vertex_normals(t),
                                  jmesh.vertex_normals(j))
    return t


def _areas(m):
    v, f = m.vertices.astype(np.float64), m.faces
    return 0.5 * np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]],
                                         v[f[:, 2]] - v[f[:, 0]]), axis=1)


def test_sphere_mesh_geometry_and_topology():
    cfg = DenseMapConfig(dims=(48, 48, 48), voxel_size=0.05,
                         origin=(-1.2, -1.2, -1.2), truncation=0.15)
    R = 0.8
    m = both_meshes(sphere_state(cfg, (0, 0, 0), R), cfg)
    assert len(m.faces) > 1000
    r = np.linalg.norm(m.vertices, axis=1)
    assert np.max(np.abs(r - R)) < 0.35 * cfg.voxel_size
    assert abs(_areas(m).sum() - 4 * np.pi * R * R) < 0.05 * 4 * np.pi * R * R
    f = m.faces
    de = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    assert np.unique(de, axis=0, return_counts=True)[1].max() == 1
    und = np.unique(np.sort(de, axis=1), axis=0)
    assert len(und) * 2 == len(de)
    assert len(m.vertices) - len(und) + len(f) == 2
    n = tmesh.vertex_normals(m)
    assert np.all((n * (m.vertices / r[:, None])).sum(1) > 0.7)


def test_mesh_of_port_fused_plane():
    seq = render_sequence(num_frames=10, height=240, width=320)
    cfg = DenseMapConfig(origin=(-4.08, -4.08, -1.36))
    st = tdense.integrate_sequence(seq.depth.astype(np.float32) * 0.001,
                                   seq.poses, Intrinsics.from_matrix(seq.K),
                                   cfg, device="cpu")
    m = both_meshes(convert.tsdf_to_numpy(st), cfg)
    assert len(m.faces) > 2000
    err = np.abs(m.vertices[:, 2])
    assert np.median(err) < 0.005 and np.percentile(err, 90) < 0.02
    assert np.mean(tmesh.vertex_normals(m)[:, 2] < 0) > 0.99
    assert np.all(_areas(m) > 0)
    pts, _ = tdense.surface_points(st, cfg)
    assert np.median(np.abs(pts[:, 2])) < 0.005


def test_empty_and_signfree_volume_mesh():
    cfg = DenseMapConfig(dims=(8, 8, 8), voxel_size=0.1,
                         origin=(0.0, 0.0, 0.0))
    empty = convert.tsdf_to_numpy(tdense.empty_tsdf(cfg, "cpu"))
    m = both_meshes(empty, cfg)
    assert len(m.vertices) == 0 and len(m.faces) == 0
    ones = tdense.TSDFState(np.ones(cfg.dims, np.float32),
                            np.ones(cfg.dims, np.float32))
    assert len(both_meshes(ones, cfg).faces) == 0


def test_ply_roundtrip_equals_reference_bytes(tmp_path):
    cfg = DenseMapConfig(dims=(24, 24, 24), voxel_size=0.1,
                         origin=(-1.2, -1.2, -1.2), truncation=0.3)
    m = both_meshes(sphere_state(cfg, (0, 0, 0), 0.7), cfg)
    n = tmesh.vertex_normals(m)
    for normals in (n, None):
        p, q = tmp_path / "t.ply", tmp_path / "j.ply"
        tmesh.save_ply(str(p), m, normals)
        jmesh.save_ply(str(q), m, normals)
        assert p.read_bytes() == q.read_bytes()
        got, gn = tmesh.load_ply(str(p))
        np.testing.assert_allclose(got.vertices, m.vertices)
        np.testing.assert_array_equal(got.faces, m.faces)
        if normals is None:
            assert gn is None
        else:
            np.testing.assert_allclose(gn, n)


def test_cli_save_mesh(tmp_path):
    from kbslam_torch.cli import main

    out = tmp_path / "mesh.ply"
    cap, old = StringIO(), sys.stdout
    sys.stdout = cap
    try:
        main(["--device", "cpu", "--frames", "16", "--width", "160",
              "--height", "120", "--ba", "off", "--dense", "--save-mesh",
              str(out)])
    finally:
        sys.stdout = old
    summary = json.loads(cap.getvalue().strip().splitlines()[-1])
    assert summary["mesh_vertices"] > 0 and summary["mesh_faces"] > 0
    m, n = tmesh.load_ply(str(out))
    assert len(m.vertices) == summary["mesh_vertices"]
    assert len(m.faces) == summary["mesh_faces"]
    assert n is not None and n.shape == m.vertices.shape
    with pytest.raises(SystemExit):
        sys.stdout, sys.stderr = StringIO(), StringIO()
        try:
            main(["--device", "cpu", "--frames", "4", "--save-mesh",
                  str(out)])
        finally:
            sys.stdout, sys.stderr = old, sys.__stderr__
