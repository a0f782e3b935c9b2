"""Native C++ BVH builder vs the numpy fallback."""
import numpy as np
import pytest

import cg_raytracer as cgrt
from cg_raytracer import native
from cg_raytracer.ops import camera as cam_ops
from cg_raytracer.ops.bvh import build_bvh, intersect_bvh
from cg_raytracer.ops.intersect import intersect_brute

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="libcgrt.so not built / no toolchain")


@needs_native
def test_native_build_valid_tree(scenes):
    scene = scenes("monkey")
    bvh = build_bvh(scene, use_native=True)
    T = scene.num_triangles
    order = np.asarray(bvh.tri_order)
    assert sorted(order.tolist()) == list(range(T))
    count = np.asarray(bvh.count)
    first = np.asarray(bvh.first)
    leaves = count > 0
    spans = sorted((int(f), int(f + c)) for f, c in zip(first[leaves], count[leaves]))
    assert spans[0][0] == 0 and spans[-1][1] == T
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 == b0


@needs_native
def test_native_matches_numpy_hits(scenes):
    scene = scenes("monkey")
    cam = cgrt.Camera.default()
    o, d = cam_ops.generate_rays(cam, 32, 32)
    hb = intersect_brute(scene, o, d)
    hn = intersect_bvh(scene, build_bvh(scene, use_native=True), o, d)
    tb = np.where(np.isinf(np.asarray(hb.t)), 1e9, np.asarray(hb.t))
    tn = np.where(np.isinf(np.asarray(hn.t)), 1e9, np.asarray(hn.t))
    assert np.isclose(tb, tn, atol=1e-4, rtol=1e-5).mean() > 0.998


@needs_native
def test_native_rejects_bad_input():
    with pytest.raises(Exception):
        native.native_build_bvh(
            np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.float32), 20, 4,
        )


@needs_native
def test_native_obj_loader_matches_python():
    # The C++ parser (native/obj_loader.cpp) must reproduce the Python loader
    # array-for-array on every reference data file (positions/triangles exact;
    # generated flat normals to f32 summation-order tolerance).
    import glob
    import os

    from cg_raytracer.scene.loader import load_obj
    from cg_raytracer.scene.presets import default_data_dir

    paths = sorted(glob.glob(os.path.join(default_data_dir(), "*.obj")))
    assert paths, "no data files found"
    for path in paths:
        py = load_obj(path, use_native=False)
        nat = load_obj(path, use_native=True)
        assert len(py) == len(nat), path
        for a, b in zip(py, nat):
            np.testing.assert_array_equal(a["triangles"], b["triangles"], err_msg=path)
            np.testing.assert_array_equal(a["vertices"], b["vertices"], err_msg=path)
            np.testing.assert_allclose(a["normals"], b["normals"], atol=1e-5,
                                       err_msg=path)
            for k in a["material"]:
                np.testing.assert_allclose(np.ravel(a["material"][k]),
                                           np.ravel(b["material"][k]),
                                           err_msg=(path, k))
