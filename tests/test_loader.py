"""OBJ/MTL loader tests (reference loadMesh semantics, mesh.cpp:58-166)."""
import numpy as np
import pytest

from cg_raytracer.scene.loader import load_mtl, load_obj
from cg_raytracer.scene.presets import default_data_dir

DATA = default_data_dir()


def test_triangle_obj():
    meshes = load_obj(f"{DATA}/triangle.obj")
    assert len(meshes) == 1
    m = meshes[0]
    assert m["triangles"].shape == (1, 3)
    assert m["vertices"].shape == (3, 3)
    # triangle.obj's faces are `f v/vt` — the vn line is *unreferenced* — so normals
    # are generated flat face normals (aiProcess_GenNormals): cross(v1-v0, v2-v0)
    # = (-1, 0, 0) for this winding.
    np.testing.assert_allclose(m["normals"], [[-1, 0, 0]] * 3)


def test_cube_obj_materials_and_counts():
    meshes = load_obj(f"{DATA}/cube.obj")
    # 6 face groups sharing 4 distinct materials -> one mesh per material.
    assert len(meshes) == 4
    total_tris = sum(m["triangles"].shape[0] for m in meshes)
    assert total_tris == 12  # 6 quads fan-triangulated
    # Materials parsed from cube.mtl (Kd lines).
    kds = sorted(tuple(np.round(m["material"]["kd"], 2)) for m in meshes)
    assert (0.8, 0.0, 0.0) in kds  # buffy-red
    assert (0.0, 0.8, 0.0) in kds  # buffy-green


def test_cornell_box_normalized():
    meshes = load_obj(f"{DATA}/CornellBox-Mirror-Rotated.obj", normalize=True)
    all_v = np.concatenate([m["vertices"] for m in meshes])
    center = all_v.mean(axis=0)
    # centerAndScaleToUnitMesh: mean at origin, max radius 1 (mesh.cpp:143-166).
    np.testing.assert_allclose(center, 0.0, atol=1e-5)
    assert np.isclose(np.linalg.norm(all_v, axis=1).max(), 1.0, atol=1e-5)
    # 8 materials -> 8 meshes; mirror material has nonzero ks.
    assert len(meshes) == 8
    assert any(np.asarray(m["material"]["ks"]).max() > 0.5 for m in meshes)


def test_generated_flat_normals():
    # Cornell OBJ has no vn lines -> flat face normals (aiProcess_GenNormals).
    meshes = load_obj(f"{DATA}/CornellBox-Mirror-Rotated.obj")
    for m in meshes:
        tris = m["triangles"]
        v = m["vertices"]
        n = m["normals"]
        p0, p1, p2 = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
        face_n = np.cross(p1 - p0, p2 - p0)
        face_n /= np.maximum(np.linalg.norm(face_n, axis=1, keepdims=True), 1e-20)
        for k in range(3):
            dots = np.abs(np.sum(face_n * n[tris[:, k]], axis=1))
            np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def test_negative_indices_and_missing_file(tmp_path):
    p = tmp_path / "neg.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    meshes = load_obj(str(p))
    assert meshes[0]["triangles"].shape == (1, 3)
    with pytest.raises(FileNotFoundError):
        load_obj(str(tmp_path / "nope.obj"))


def test_quad_fan_triangulation(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    meshes = load_obj(str(p))
    assert meshes[0]["triangles"].shape == (2, 3)


def test_mtl_parsing():
    mats = load_mtl(f"{DATA}/CornellBox-Mirror-Rotated.mtl")
    assert "leftWall" in mats and "light" in mats
    np.testing.assert_allclose(mats["leftWall"]["kd"], (0.63, 0.065, 0.05), atol=1e-6)
    assert mats["backWall"]["shininess"] == pytest.approx(10.000002)
