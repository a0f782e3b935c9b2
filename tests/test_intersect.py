"""Primitive intersector unit tests vs analytic cases (ray_tracing.cpp semantics)."""
import jax.numpy as jnp
import numpy as np

import cg_raytracer as cgrt
from cg_raytracer.ops.intersect import (intersect_aabb, intersect_brute,
                                            intersect_spheres_one,
                                            moller_trumbore, occluded_brute,
                                            reconstruct_hit)
from cg_raytracer.scene.types import PointLights, make_scene

V0 = jnp.asarray([0.0, 0.0, 0.0])
V1 = jnp.asarray([1.0, 0.0, 0.0])
V2 = jnp.asarray([0.0, 1.0, 0.0])


def _mt(o, d):
    return moller_trumbore(jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
                           V0, V1, V2)


def test_triangle_hit_center():
    t, u, v, ok = _mt([0.25, 0.25, -1.0], [0.0, 0.0, 1.0])
    assert bool(ok) and np.isclose(float(t), 1.0)
    assert np.isclose(float(u), 0.25) and np.isclose(float(v), 0.25)


def test_triangle_miss_outside():
    _, _, _, ok = _mt([0.9, 0.9, -1.0], [0.0, 0.0, 1.0])
    assert not bool(ok)


def test_triangle_behind_origin():
    # intersectRayWithPlane rejects t < 0 (ray_tracing.cpp:59-62).
    _, _, _, ok = _mt([0.25, 0.25, 1.0], [0.0, 0.0, 1.0])
    assert not bool(ok)


def test_triangle_backface_accepted():
    # The reference's plane test is double-sided (ray_tracing.cpp:90-107).
    t, _, _, ok = _mt([0.25, 0.25, 1.0], [0.0, 0.0, -1.0])
    assert bool(ok) and np.isclose(float(t), 1.0)


def test_triangle_parallel_ray():
    _, _, _, ok = _mt([0.25, 0.25, -1.0], [1.0, 0.0, 0.0])
    assert not bool(ok)


def test_sphere_outside_inside_behind():
    c = jnp.asarray([0.0, 0.0, 5.0])
    r = jnp.float32(1.0)
    o = jnp.asarray([0.0, 0.0, 0.0])
    d = jnp.asarray([0.0, 0.0, 1.0])
    # Outside: smaller root (ray_tracing.cpp:136-139).
    t, ok = intersect_spheres_one(o, d, c, r)
    assert bool(ok) and np.isclose(float(t), 4.0)
    # Inside: bigger root (ray_tracing.cpp:140-143).
    t, ok = intersect_spheres_one(jnp.asarray([0.0, 0.0, 5.0]), d, c, r)
    assert bool(ok) and np.isclose(float(t), 1.0)
    # Behind: miss (ray_tracing.cpp:144-147).
    t, ok = intersect_spheres_one(jnp.asarray([0.0, 0.0, 8.0]), d, c, r)
    assert not bool(ok)
    # Tangent-miss.
    t, ok = intersect_spheres_one(jnp.asarray([0.0, 2.0, 0.0]), d, c, r)
    assert not bool(ok)


def test_aabb_slab():
    lo = jnp.asarray([0.0, 0.0, 0.0])
    hi = jnp.asarray([1.0, 1.0, 1.0])
    d = jnp.asarray([0.0, 0.0, 1.0])
    inv = 1.0 / d
    # In front.
    t, ok = intersect_aabb(jnp.asarray([0.5, 0.5, -2.0]), inv, lo, hi)
    assert bool(ok) and np.isclose(float(t), 2.0)
    # Origin inside: hit (ray_tracing.cpp:184-187 takes tOut).
    _, ok = intersect_aabb(jnp.asarray([0.5, 0.5, 0.5]), inv, lo, hi)
    assert bool(ok)
    # Behind.
    _, ok = intersect_aabb(jnp.asarray([0.5, 0.5, 2.0]), inv, lo, hi)
    assert not bool(ok)
    # Parallel ray outside the slab (division by zero -> IEEE inf handling).
    _, ok = intersect_aabb(jnp.asarray([2.0, 0.5, -2.0]), inv, lo, hi)
    assert not bool(ok)


def _single_tri_scene():
    mesh = {
        "vertices": np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        "normals": np.asarray([[0, 0, -1]] * 3, np.float32),
        "triangles": np.asarray([[0, 1, 2]], np.int32),
        "material": {"kd": (1.0, 0.5, 0.25), "ks": (0.5, 0.5, 0.5), "shininess": 8.0},
    }
    return make_scene([mesh], point_lights=PointLights.of(((0, 0, -2), (1, 1, 1))))


def test_brute_closest_and_reconstruct():
    scene = _single_tri_scene()
    o = jnp.asarray([[0.25, 0.25, -1.0], [5.0, 5.0, -1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], jnp.float32)
    hit = intersect_brute(scene, o, d)
    assert int(hit.prim_id[0]) == 0 and int(hit.prim_id[1]) == -1
    assert np.isinf(float(hit.t[1]))
    surf = reconstruct_hit(scene, o, d, hit)
    assert bool(surf.valid[0]) and not bool(surf.valid[1])
    np.testing.assert_allclose(np.asarray(surf.position[0]), [0.25, 0.25, 0.0], atol=1e-6)
    # Facing flip parity (ray_tracing.cpp:99-106): the flip keys off the *plane*
    # normal cross(v1-v0, v2-v0) = (0,0,1); dot(plane_n, -dir) = -1 < 0, so the
    # interpolated vertex normal (0,0,-1) is negated to (0,0,1) — exactly what the
    # reference computes for this winding.
    np.testing.assert_allclose(np.asarray(surf.normal[0]), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(surf.kd[0]), [1.0, 0.5, 0.25], atol=1e-6)
    assert float(surf.shininess[0]) == 8.0


def test_occluded_respects_t_max():
    scene = _single_tri_scene()
    o = jnp.asarray([[0.25, 0.25, -1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    # Triangle at t=1: occluded with t_max=2, clear with t_max=0.5.
    assert bool(occluded_brute(scene, o, d, jnp.asarray([2.0]))[0])
    assert not bool(occluded_brute(scene, o, d, jnp.asarray([0.5]))[0])


def test_ray_t_bound_semantics():
    # t_max acts as the loop-carried "closest so far" (ray.t in the reference):
    # a hit beyond it is rejected.
    scene = _single_tri_scene()
    o = jnp.asarray([[0.25, 0.25, -1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    hit = intersect_brute(scene, o, d, t_max=jnp.asarray([0.5]))
    assert int(hit.prim_id[0]) == -1


def test_plane_intersector():
    from cg_raytracer.ops.intersect import intersect_plane

    n = jnp.asarray([0.0, 1.0, 0.0])
    o = jnp.asarray([[0.0, 2.0, 0.0], [0.0, 2.0, 0.0], [0.0, 1.0, 0.0],
                     [0.0, 2.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0],
                     [1.0, 0.0, 0.0]], jnp.float32)
    t, ok = intersect_plane(o, d, n, jnp.float32(1.0))
    # Hit from above at t=1 (plane y=1).
    assert bool(ok[0]) and np.isclose(float(t[0]), 1.0)
    # Pointing away -> behind-origin reject (ray_tracing.cpp:59-62).
    assert not bool(ok[1])
    # Origin on the plane -> t=0 (ray_tracing.cpp:43-47).
    assert bool(ok[2]) and float(t[2]) == 0.0
    # Parallel, off-plane -> miss (ray_tracing.cpp:51-54).
    assert not bool(ok[3])
