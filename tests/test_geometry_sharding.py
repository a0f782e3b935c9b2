"""Geometry-sharded ("TP"-analogue) rendering tests (parallel/geometry.py).

SURVEY §5: "geometry replicated (small scenes) or primitive-sharded with
all-gather (dragon-scale)" (SURVEY.md:289) — these tests prove the sharded
path preserves the single-device oracle and that a donut-scale scene
renders and matches the replicated render.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import cg_raytracer as cgrt
from cg_raytracer.ops import camera as cam_ops
from cg_raytracer.parallel.geometry import (PRIM_AXIS,
                                                build_geometry_shards,
                                                geometry_sharded_intersect,
                                                geometry_sharded_render)


def _mesh(n, axes=(PRIM_AXIS,)):
    devs = np.asarray(jax.devices()[:n])
    if len(axes) == 2:
        return Mesh(devs.reshape(2, n // 2), axes)
    return Mesh(devs, axes)


CFG = cgrt.RenderConfig(width=32, height=32, backend="bvh")


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_oracle_matches_brute(n_shards):
    scene = cgrt.load_scene("monkey")
    mesh = _mesh(n_shards)
    shards = build_geometry_shards(scene, n_shards, CFG)
    o, d = cam_ops.generate_rays(cgrt.Camera.default(), 32, 32)
    hit = geometry_sharded_intersect(scene, CFG, mesh, shards, o, d)

    from cg_raytracer.ops.intersect import intersect_brute

    hb = intersect_brute(scene, o, d)
    tb = np.where(np.isinf(np.asarray(hb.t)), 1e9, np.asarray(hb.t))
    tv = np.where(np.isinf(np.asarray(hit.t)), 1e9, np.asarray(hit.t))
    bad = ~np.isclose(tb, tv, atol=1e-4, rtol=1e-5)
    assert bad.mean() < 0.005
    # Global prim ids agree wherever t does (tie-breaks exempt).
    agree = (np.asarray(hit.prim_id) == np.asarray(hb.prim_id)) | bad
    assert agree.mean() > 0.995


def test_sharded_render_matches_replicated():
    scene = cgrt.load_scene("monkey")
    mesh = _mesh(8)
    shards = build_geometry_shards(scene, 8, CFG)
    img_s = np.asarray(geometry_sharded_render(scene, cgrt.Camera.default(),
                                               CFG, mesh, shards=shards))
    img_r = np.asarray(cgrt.render(scene, cgrt.Camera.default(), CFG))
    mismatch = (np.abs(img_s - img_r).max(axis=-1) > 1e-4).mean()
    assert mismatch < 0.005


def test_sharded_render_reflective_and_point_shadows():
    # Cornell box with mirror: reflections cross shard boundaries, so bounce-2
    # rays originating from one shard's surface must still find hits in others.
    scene = cgrt.load_scene("cornell_box")
    cfg = dataclasses.replace(CFG, backend="brute")  # 32 tris -> brute shards
    mesh = _mesh(4)
    shards = build_geometry_shards(scene, 4, cfg)
    assert shards.accel is None  # brute shards carry no accel
    img_s = np.asarray(geometry_sharded_render(scene, cgrt.Camera.default(),
                                               cfg, mesh, shards=shards))
    img_r = np.asarray(cgrt.render(scene, cgrt.Camera.default(), cfg))
    mismatch = (np.abs(img_s - img_r).max(axis=-1) > 1e-4).mean()
    assert mismatch < 0.005


def test_sharded_render_soft_shadows_bitwise_sample_stream():
    # The soft-shadow PRNG stream is a pure function of (key, light, chunk) —
    # independent of the mesh — so the sharded render's stochastic visibility
    # matches the replicated render's exactly (SURVEY §7 hard-part 4).
    scene = cgrt.load_scene("cornell_box_spherical_light")
    cfg = cgrt.RenderConfig(width=16, height=16, backend="brute",
                            soft_shadow_samples=8, soft_shadow_chunk=4)
    mesh = _mesh(4)
    shards = build_geometry_shards(scene, 4, cfg)
    img_s = np.asarray(geometry_sharded_render(scene, cgrt.Camera.default(),
                                               cfg, mesh, shards=shards))
    img_r = np.asarray(cgrt.render(scene, cgrt.Camera.default(), cfg))
    np.testing.assert_allclose(img_s, img_r, atol=1e-5)


def test_sharded_render_2d_rays_by_prims_mesh():
    # TP x DP composition: rays sharded over one axis, geometry over the other.
    scene = cgrt.load_scene("monkey")
    mesh = _mesh(8, axes=("rays", PRIM_AXIS))  # 2 x 4
    shards = build_geometry_shards(scene, 4, CFG)
    img_s = np.asarray(geometry_sharded_render(
        scene, cgrt.Camera.default(), CFG, mesh, shards=shards,
        ray_axis="rays"))
    img_r = np.asarray(cgrt.render(scene, cgrt.Camera.default(), CFG))
    mismatch = (np.abs(img_s - img_r).max(axis=-1) > 1e-4).mean()
    assert mismatch < 0.005


def test_sharded_effects_compose():
    scene = cgrt.load_scene("cube")
    cfg = dataclasses.replace(CFG, width=16, height=16, backend="brute",
                              anti_aliasing=True, bloom=True)
    mesh = _mesh(2)
    shards = build_geometry_shards(scene, 2, cfg)
    img_s = np.asarray(geometry_sharded_render(scene, cgrt.Camera.default(),
                                               cfg, mesh, shards=shards))
    img_r = np.asarray(cgrt.render(scene, cgrt.Camera.default(), cfg))
    np.testing.assert_allclose(img_s, img_r, atol=1e-4)


def _big_torus_scene(num_u: int, num_v: int):
    """Vectorized torus mesh builder (the preset builder's Python triangle loop
    is too slow at millions of triangles)."""
    from cg_raytracer.scene.types import PointLights, make_scene

    u = np.linspace(0.0, 1.0, num_u, endpoint=False)
    v = np.linspace(0.0, 1.0, num_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    th, ph = 2 * np.pi * uu, 2 * np.pi * vv
    R, a = 1.0, 0.4
    pts = np.stack([(R + a * np.cos(ph)) * np.cos(th), a * np.sin(ph),
                    (R + a * np.cos(ph)) * np.sin(th)], axis=-1)
    pts = pts.reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(num_u), np.arange(num_v), indexing="ij")
    v00 = (ii % num_u) * num_v + (jj % num_v)
    v10 = ((ii + 1) % num_u) * num_v + (jj % num_v)
    v11 = ((ii + 1) % num_u) * num_v + ((jj + 1) % num_v)
    v01 = (ii % num_u) * num_v + ((jj + 1) % num_v)
    t1 = np.stack([v00, v10, v11], axis=-1).reshape(-1, 3)
    t2 = np.stack([v00, v11, v01], axis=-1).reshape(-1, 3)
    tris = np.concatenate([t1, t2]).astype(np.int32)
    # Geometric normals are fine for an intersection-scale test.
    nrm = pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-9)
    mesh = {"vertices": pts, "normals": nrm.astype(np.float32),
            "triangles": tris,
            "material": {"kd": (0.8, 0.5, 0.3), "ks": (0.0, 0.0, 0.0),
                         "shininess": 1.0, "transparency": 1.0}}
    lights = PointLights.of(((0.0, 2.5, -2.5), (1.0, 1.0, 1.0)))
    return make_scene((mesh,), point_lights=lights)


def test_beyond_hbm_cap_scene_renders_and_matches():
    """A donut-scale scene (320K triangles) split 8 ways over geometry must
    render through geometry sharding and match the replicated (jnp-BVH)
    render."""
    scene = _big_torus_scene(400, 400)
    assert scene.num_triangles == 320_000

    cfg = cgrt.RenderConfig(width=12, height=12, backend="bvh", max_depth=1)
    mesh = _mesh(8)
    shards = build_geometry_shards(scene, 8, cfg)
    assert shards.shard_size < scene.num_triangles // 4
    img_s = np.asarray(geometry_sharded_render(scene, cgrt.Camera.default(),
                                               cfg, mesh, shards=shards))
    img_r = np.asarray(cgrt.render(scene, cgrt.Camera.default(), cfg))
    assert np.isfinite(img_s).all()
    mismatch = (np.abs(img_s - img_r).max(axis=-1) > 1e-4).mean()
    assert mismatch < 0.005


def test_shard_count_mismatch_raises():
    scene = cgrt.load_scene("cube")
    mesh = _mesh(4)
    shards = build_geometry_shards(scene, 2, CFG)
    with pytest.raises(ValueError, match="mesh axis"):
        geometry_sharded_render(scene, cgrt.Camera.default(), CFG, mesh,
                                shards=shards)
