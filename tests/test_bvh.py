"""BVH build invariants + traversal vs brute-force oracle (bvh.cpp capability)."""
import jax.numpy as jnp
import numpy as np
import pytest

from cg_raytracer.ops import camera as cam_ops
from cg_raytracer.ops.bvh import (build_bvh, bvh_num_levels, intersect_bvh,
                                      occluded_bvh, traverse_closest)
from cg_raytracer.ops.intersect import intersect_brute, occluded_brute

import cg_raytracer as cgrt


@pytest.fixture(scope="module", params=["cube", "cornell_box", "monkey"])
def scene_and_bvh(request):
    scene = cgrt.load_scene(request.param)
    return request.param, scene, build_bvh(scene, use_native=False)


def test_build_invariants(scene_and_bvh):
    name, scene, bvh = scene_and_bvh
    T = scene.num_triangles
    order = np.asarray(bvh.tri_order)
    # Permutation covering every triangle exactly once.
    assert sorted(order.tolist()) == list(range(T))
    first = np.asarray(bvh.first)
    count = np.asarray(bvh.count)
    left = np.asarray(bvh.left)
    lo = np.asarray(bvh.node_lo)
    hi = np.asarray(bvh.node_hi)
    # Leaves partition [0, T).
    leaves = count > 0
    spans = sorted((int(f), int(f + c)) for f, c in zip(first[leaves], count[leaves]))
    assert spans[0][0] == 0 and spans[-1][1] == T
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 == b0
    # Node AABBs contain their triangles.
    verts = np.asarray(scene.vertices)
    tris = np.asarray(scene.triangles)
    for ni in np.where(leaves)[0]:
        ids = order[first[ni]:first[ni] + count[ni]]
        pts = verts[tris[ids]].reshape(-1, 3)
        assert (pts >= lo[ni] - 1e-5).all() and (pts <= hi[ni] + 1e-5).all()
    # Internal nodes contain their children boxes.
    right = np.asarray(bvh.right)
    for ni in np.where(~leaves)[0]:
        for c in (left[ni], right[ni]):
            assert c >= 0
            assert (lo[c] >= lo[ni] - 1e-5).all() and (hi[c] <= hi[ni] + 1e-5).all()
    assert bvh_num_levels(bvh) >= 1


def test_traversal_matches_brute_camera_rays(scene_and_bvh):
    name, scene, bvh = scene_and_bvh
    cam = cgrt.Camera.default()
    o, d = cam_ops.generate_rays(cam, 48, 48)
    hb = intersect_brute(scene, o, d)
    hv = intersect_bvh(scene, bvh, o, d)
    tb = np.where(np.isinf(np.asarray(hb.t)), 1e9, np.asarray(hb.t))
    tv = np.where(np.isinf(np.asarray(hv.t)), 1e9, np.asarray(hv.t))
    bad = ~np.isclose(tb, tv, atol=1e-4, rtol=1e-5)
    assert bad.mean() < 0.002, f"{name}: {bad.sum()} rays disagree"


def test_traversal_matches_brute_random_rays(scene_and_bvh):
    name, scene, bvh = scene_and_bvh
    rng = np.random.default_rng(0)
    n = 512
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    hb = intersect_brute(scene, o, d)
    hv = intersect_bvh(scene, bvh, o, d)
    tb = np.where(np.isinf(np.asarray(hb.t)), 1e9, np.asarray(hb.t))
    tv = np.where(np.isinf(np.asarray(hv.t)), 1e9, np.asarray(hv.t))
    bad = ~np.isclose(tb, tv, atol=1e-4, rtol=1e-5)
    assert bad.mean() < 0.002, f"{name}: {bad.sum()} rays disagree"


def test_any_hit_matches_brute(scene_and_bvh):
    name, scene, bvh = scene_and_bvh
    rng = np.random.default_rng(1)
    n = 512
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    tm = jnp.asarray(rng.uniform(0.5, 5.0, (n,)), jnp.float32)
    bb = np.asarray(occluded_brute(scene, o, d, tm))
    bv = np.asarray(occluded_bvh(scene, bvh, o, d, tm))
    assert (bb != bv).mean() < 0.005, f"{name}: any-hit disagreement"


def test_oversized_leaf_chunking():
    # Depth cap forces leaves larger than max_leaf; the cursored re-push must still
    # test every triangle (parity with the reference's depth-capped leaves,
    # bvh.cpp:320-322).
    scene = cgrt.load_scene("monkey")
    bvh = build_bvh(scene, max_depth=3, max_leaf=4, use_native=False)
    assert int(np.asarray(bvh.count).max()) > 4
    cam = cgrt.Camera.default()
    o, d = cam_ops.generate_rays(cam, 32, 32)
    hb = intersect_brute(scene, o, d)
    hv, _ = traverse_closest(bvh, o, d)
    tb = np.where(np.isinf(np.asarray(hb.t)), 1e9, np.asarray(hb.t))
    tv = np.where(np.isinf(np.asarray(hv.t)), 1e9, np.asarray(hv.t))
    assert np.isclose(tb, tv, atol=1e-4, rtol=1e-5).all()


def test_sah_builder_invariants_and_render_parity():
    """builder='sah' honors the oracle contract (ADVICE r2): structural
    invariants hold and renders match the median build to <0.5% of pixels on
    the jnp 'bvh' backend (tie-breaks on coincident-t edges may differ, per
    the module contract)."""
    scene = cgrt.load_scene("monkey")
    sah = build_bvh(scene, builder="sah")
    T = scene.num_triangles
    order = np.asarray(sah.tri_order)
    assert sorted(order.tolist()) == list(range(T))
    first, count = np.asarray(sah.first), np.asarray(sah.count)
    leaves = count > 0
    spans = sorted((int(f), int(f + c)) for f, c in zip(first[leaves], count[leaves]))
    assert spans[0][0] == 0 and spans[-1][1] == T
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 == b0

    import dataclasses

    from cg_raytracer.models.whitted import render

    cam = cgrt.Camera.default()
    cfg_m = cgrt.RenderConfig(width=48, height=48, backend="bvh",
                              bvh_builder="median")
    cfg_s = dataclasses.replace(cfg_m, bvh_builder="sah")
    img_m = np.asarray(render(scene, cam, cfg_m))
    img_s = np.asarray(render(scene, cam, cfg_s))
    mismatch = (np.abs(img_m - img_s).max(axis=-1) > 1e-4).mean()
    assert mismatch < 0.005, f"{mismatch:.2%} pixels differ"


def test_sah_builder_denormal_extent_does_not_crash():
    """Centroid extents in the float32-denormal range used to overflow the
    SAH binning to inf -> NaN -> negative bincount indices (ADVICE r2)."""
    import dataclasses

    scene = cgrt.load_scene("cube")
    verts = np.asarray(scene.vertices).copy()
    # Collapse one axis to a denormal span so centroid extent ~ 1e-40.
    verts[:, 0] = verts[:, 0] * 1e-40
    scene = dataclasses.replace(scene, vertices=jnp.asarray(verts))
    bvh = build_bvh(scene, builder="sah", use_native=False)
    order = np.asarray(bvh.tri_order)
    assert sorted(order.tolist()) == list(range(scene.num_triangles))


def test_spheres_combined_with_bvh():
    # bvh::intersect handles meshes via the tree and spheres brute-force
    # (bvh.cpp:850-881); a sphere in front of the mesh must win.
    import dataclasses

    from cg_raytracer.scene.types import Spheres

    scene = cgrt.load_scene("cube")
    spheres = Spheres(
        center=jnp.asarray([[0.5, 0.5, -2.0]], jnp.float32),
        radius=jnp.asarray([0.25], jnp.float32),
        kd=jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32),
        ks=jnp.zeros((1, 3), jnp.float32),
        shininess=jnp.ones((1,), jnp.float32),
    )
    scene = dataclasses.replace(scene, spheres=spheres)
    bvh = build_bvh(scene, use_native=False)
    o = jnp.asarray([[0.5, 0.5, -5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    hit = intersect_bvh(scene, bvh, o, d)
    assert int(hit.prim_id[0]) == scene.num_triangles  # sphere id offset
    assert np.isclose(float(hit.t[0]), 2.75, atol=1e-5)
