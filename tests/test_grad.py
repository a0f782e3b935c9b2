"""Gradient tests: jax.grad through the full render vs finite differences.

BASELINE.json config 1: grads w.r.t. materials, lights, and vertex positions
checked against central finite differences (away from visibility discontinuities).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cg_raytracer as cgrt
from cg_raytracer.models.whitted import render_image

CFG = cgrt.RenderConfig(width=24, height=24, backend="brute")


def _loss_builder(scene, cfg=CFG, camera=None, key=None):
    camera = camera or cgrt.Camera.default()
    key = key if key is not None else jax.random.PRNGKey(0)

    def loss_of_scene(scene_):
        img = render_image(scene_, camera, cfg, key=key)
        # Smooth spatial weighting keeps the loss sensitive to geometry shifts.
        h, w = cfg.height, cfg.width
        wy = jnp.linspace(0.3, 1.0, h)[:, None, None]
        wx = jnp.linspace(1.0, 0.4, w)[None, :, None]
        return jnp.sum(img * wy * wx)

    return loss_of_scene


def _fd_check(loss_fn, x0, grad, picks, eps=2e-3, rtol=0.08, atol=1e-4):
    """Central finite differences at a few coordinates."""
    flat = np.asarray(x0, np.float64).ravel()
    g = np.asarray(grad).ravel()
    for i in picks:
        xp = flat.copy()
        xp[i] += eps
        xm = flat.copy()
        xm[i] -= eps
        lp = float(loss_fn(jnp.asarray(xp.reshape(np.shape(x0)), jnp.float32)))
        lm = float(loss_fn(jnp.asarray(xm.reshape(np.shape(x0)), jnp.float32)))
        fd = (lp - lm) / (2 * eps)
        assert np.isclose(fd, g[i], rtol=rtol, atol=max(atol, 5e-3 * abs(fd))), (
            f"coord {i}: fd={fd:.6f} grad={g[i]:.6f}"
        )


@pytest.fixture(scope="module")
def tri_scene():
    return cgrt.load_scene("single_triangle")


def test_grad_kd_matches_fd(tri_scene):
    scene = tri_scene
    base = _loss_builder(scene)

    def loss_kd(kd):
        mats = dataclasses.replace(scene.materials, kd=kd)
        return base(dataclasses.replace(scene, materials=mats))

    g = jax.grad(loss_kd)(scene.materials.kd)
    assert np.all(np.isfinite(np.asarray(g)))
    _fd_check(loss_kd, scene.materials.kd, g, picks=[0, 1, 2])


def test_grad_light_position_matches_fd(tri_scene):
    scene = tri_scene
    base = _loss_builder(scene)

    def loss_lp(pos):
        lights = dataclasses.replace(scene.point_lights, position=pos)
        return base(dataclasses.replace(scene, point_lights=lights))

    g = jax.grad(loss_lp)(scene.point_lights.position)
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.abs(np.asarray(g)).max() > 0
    _fd_check(loss_lp, scene.point_lights.position, g, picks=[0, 1, 2])


def big_triangle_scene(ks=(0.0, 0.0, 0.0), shininess=1.0):
    """A large TILTED camera-facing triangle with varying vertex normals and a
    nearby point light: big interior footprint AND a full-rank dependence of
    the image on vertex positions.  (A flat constant-normal triangle is
    degenerate for vertex-gradient checks: in-plane vertex moves don't change
    the ray-plane hit points, so interior pixels carry exactly zero vertex
    gradient.  The preset single_triangle is also a sliver at the default
    camera.)"""
    from cg_raytracer.scene.types import PointLights, make_scene

    normals = np.asarray([[0, 0, -1], [0.3, 0, -1], [0, 0.3, -1]], np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    tri = {
        "vertices": np.asarray([[-1, -1, 0], [3, -1, 0.6], [-1, 3, -0.4]],
                               np.float32),
        "normals": normals,
        "triangles": np.asarray([[0, 2, 1]], np.int32),
        "material": {"kd": (0.8, 0.6, 0.4), "ks": ks, "shininess": shininess},
    }
    light = ((2.0, 0.5, -2.0), (1.0, 1.0, 1.0))
    cam = cgrt.Camera.default(euler_deg=(0, 0, 0), dist=3.0,
                              look_at=(0.5, 0.5, 0.0))
    return make_scene([tri], point_lights=PointLights.of(light)), cam


def test_grad_vertices_matches_fd():
    # dL/d(vertex position) through hit reconstruction + shading (the
    # continuous part; the discrete hit selection is stop-gradded by design).
    # FD-checked away from visibility discontinuities: the loss integrates an
    # INTERIOR pixel window only, so a small vertex shift moves shading (hit
    # position -> light direction/distance) smoothly without any silhouette
    # crossing the window.
    scene, camera = big_triangle_scene(ks=(0.3, 0.3, 0.3), shininess=8.0)
    cfg = CFG
    key = jax.random.PRNGKey(0)

    # Locate a window strictly inside the triangle's footprint: a pixel whose
    # whole 5x5 neighborhood hits.
    img0 = np.asarray(render_image(scene, camera, cfg, key=key))
    hit = img0.max(axis=-1) > 0
    win = None
    for cy in range(2, cfg.height - 2):
        for cx in range(2, cfg.width - 2):
            cand = (slice(cy - 2, cy + 3), slice(cx - 2, cx + 3))
            if hit[cand].all():
                win = cand
    assert win is not None, "no interior 5x5 window; adjust test setup"

    def loss_v(verts):
        img = render_image(dataclasses.replace(scene, vertices=verts), camera,
                           cfg, key=key)
        return jnp.sum(img[win[0], win[1]])

    g = jax.grad(loss_v)(scene.vertices)
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.abs(np.asarray(g)).max() > 0
    # Check several vertex coordinates: z components (plane shifts) and an
    # in-plane x (changes the tilted plane's orientation).
    _fd_check(loss_v, scene.vertices, g, picks=[0, 2, 5, 8], eps=1e-3, rtol=0.1)


def test_grad_shininess_and_ks(tri_scene):
    scene = tri_scene
    # Give the material a specular term so shininess has signal.
    mats = dataclasses.replace(
        scene.materials,
        ks=jnp.asarray([[0.5, 0.5, 0.5]], jnp.float32),
        shininess=jnp.asarray([8.0], jnp.float32),
    )
    scene = dataclasses.replace(scene, materials=mats)
    base = _loss_builder(scene)

    def loss_s(shin):
        m = dataclasses.replace(scene.materials, shininess=shin)
        return base(dataclasses.replace(scene, materials=m))

    g = jax.grad(loss_s)(scene.materials.shininess)
    assert np.all(np.isfinite(np.asarray(g)))
    _fd_check(loss_s, scene.materials.shininess, g, picks=[0], eps=1e-2)


def test_grad_through_bvh_backend(scenes):
    # BVH traversal is a stop-gradded oracle; grads flow via differentiable
    # reconstruction — must match the brute backend's grads.  (cornell_box rather
    # than cube: the cube camera grazes shared edges exactly, where coincident-t
    # tie-breaks legitimately differ between backends.)
    scene = scenes("cornell_box")
    cfg_b = dataclasses.replace(CFG, backend="brute")
    cfg_v = dataclasses.replace(CFG, backend="bvh")
    from cg_raytracer.ops.bvh import build_bvh

    bvh = build_bvh(scene)
    cam = cgrt.Camera.default()
    key = jax.random.PRNGKey(0)

    def loss(kd, cfg, bvh_):
        mats = dataclasses.replace(scene.materials, kd=kd)
        s = dataclasses.replace(scene, materials=mats)
        from cg_raytracer.models.whitted import make_backend

        backend = make_backend(s, cfg, bvh=bvh_)
        return jnp.sum(render_image(s, cam, cfg, backend=backend, key=key))

    gb = jax.grad(lambda kd: loss(kd, cfg_b, None))(scene.materials.kd)
    gv = jax.grad(lambda kd: loss(kd, cfg_v, bvh))(scene.materials.kd)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(gv), rtol=1e-3, atol=1e-4)


def test_grad_soft_shadow_scene_finite(scenes):
    scene = scenes("cornell_box_spherical_light")
    cfg = cgrt.RenderConfig(width=16, height=16, soft_shadow_samples=4,
                            soft_shadow_chunk=2)
    cam = cgrt.Camera.default()

    def loss(kd):
        mats = dataclasses.replace(scene.materials, kd=kd)
        s = dataclasses.replace(scene, materials=mats)
        return jnp.sum(render_image(s, cam, cfg, key=jax.random.PRNGKey(0)))

    g = jax.grad(loss)(scene.materials.kd)
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.abs(np.asarray(g)).max() > 0


def test_grad_two_phase_matches_one_phase():
    # cfg.grad_two_phase='on' moves the oracle record computation ahead of the
    # differentiable shade chain (models/whitted.py trace_rays).  Forward
    # images and parameter gradients must match the one-phase path (the
    # restructure only moves the partial-eval boundary).
    from cg_raytracer.optim.inverse import (apply_material_params,
                                                material_params)

    scene = cgrt.load_scene("cornell_box")
    cam = cgrt.Camera.default()
    key = jax.random.PRNGKey(3)
    cfg_off = cgrt.RenderConfig(width=24, height=24, backend="bvh",
                                grad_two_phase="off")
    cfg_on = dataclasses.replace(cfg_off, grad_two_phase="on")
    params = material_params(scene)

    def loss(params_, cfg):
        s = apply_material_params(scene, params_)
        img = render_image(s, cam, cfg, key=key)
        return jnp.mean(img), img

    (l0, img0), g0 = jax.value_and_grad(
        lambda p: loss(p, cfg_off), has_aux=True)(params)
    (l1, img1), g1 = jax.value_and_grad(
        lambda p: loss(p, cfg_on), has_aux=True)(params)
    np.testing.assert_allclose(np.asarray(img0), np.asarray(img1),
                               rtol=1e-6, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(np.asarray(g0[k]), np.asarray(g1[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
