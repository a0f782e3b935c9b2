"""BVH refit tests (ops/refit.py): oracle validity on moved geometry, vertex
gradients through refit backends, end-to-end geometry optimization.

Reference anchor: the build being refit is createTree
(src/bounding_volume_hierarchy.cpp:343-389); the reference has
no refit (it rebuilds on scene switches)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cg_raytracer as cgrt
from cg_raytracer.models.whitted import render_image, make_backend
from cg_raytracer.ops import camera as cam_ops
from cg_raytracer.ops.bvh import build_bvh, intersect_bvh
from cg_raytracer.ops.intersect import intersect_brute
from cg_raytracer.ops.refit import make_refit_plan, refit_accel


def _moved_monkey(scale=0.05, seed=0):
    scene = cgrt.load_scene("monkey")
    rng = np.random.default_rng(seed)
    v2 = np.asarray(scene.vertices) + rng.normal(
        scale=scale, size=scene.vertices.shape).astype(np.float32)
    return scene, dataclasses.replace(scene, vertices=jnp.asarray(v2))


def _mismatch(scene2, hit, oracle):
    tb = np.where(np.isinf(np.asarray(oracle.t)), 1e9, np.asarray(oracle.t))
    tv = np.where(np.isinf(np.asarray(hit.t)), 1e9, np.asarray(hit.t))
    return (~np.isclose(tb, tv, atol=1e-4, rtol=1e-5)).mean()


def test_refit_bvh_matches_brute_on_moved_geometry():
    scene, scene2 = _moved_monkey()
    bvh0 = build_bvh(scene)
    plan = make_refit_plan(bvh0, scene)
    bvh2 = jax.jit(lambda s: refit_accel(bvh0, s, plan))(scene2)
    o, d = cam_ops.generate_rays(cgrt.Camera.default(), 32, 32)
    assert _mismatch(scene2, intersect_bvh(scene2, bvh2, o, d),
                     intersect_brute(scene2, o, d)) < 0.002
    # Containment invariant: every refit node box bounds its triangles.
    lo = np.asarray(bvh2.node_lo)
    hi = np.asarray(bvh2.node_hi)
    first = np.asarray(bvh2.first)
    count = np.asarray(bvh2.count)
    tv = np.stack([np.asarray(bvh2.tv0), np.asarray(bvh2.tv1),
                   np.asarray(bvh2.tv2)], axis=1)  # [T,3,3]
    for ni in np.where(count > 0)[0][:50]:
        pts = tv[first[ni]:first[ni] + count[ni]].reshape(-1, 3)
        assert (pts >= lo[ni] - 1e-5).all() and (pts <= hi[ni] + 1e-5).all()


def test_refit_tree_repacks_for_the_cuda_kernel():
    """The CUDA traversal packs its records from the BVH inside the jitted
    step, so a refit tree reaches the kernel with the moved geometry: node
    boxes round-trip and triangle records carry the new v0 and edges."""
    from cg_raytracer.ops.bvh_cuda import pack_nodes, pack_triangles, unpack_nodes

    scene, scene2 = _moved_monkey()
    bvh0 = build_bvh(scene)
    plan = make_refit_plan(bvh0, scene)
    bvh2 = jax.jit(lambda s: refit_accel(bvh0, s, plan))(scene2)
    lo, hi, *_ = unpack_nodes(pack_nodes(bvh2))
    np.testing.assert_array_equal(lo, np.asarray(bvh2.node_lo))
    np.testing.assert_array_equal(hi, np.asarray(bvh2.node_hi))
    tris = np.asarray(pack_triangles(bvh2))
    v0 = tris[:, 0:3].view(np.float32)
    e1 = tris[:, 4:7].view(np.float32)
    np.testing.assert_array_equal(v0, np.asarray(bvh2.tv0))
    np.testing.assert_array_equal(e1, np.asarray(bvh2.tv1 - bvh2.tv0))
    assert np.abs(v0 - np.asarray(bvh0.tv0)).max() > 0  # geometry did move


def test_vertex_grad_through_refit_bvh_matches_brute_backend():
    """The VERDICT r2 done-criterion at monkey scale: d(render)/d(vertices)
    through a refit-BVH backend equals the brute backend's gradient (same
    discrete hit structure by the oracle contract, same differentiable
    reconstruction)."""
    scene = cgrt.load_scene("monkey")
    cfg_bvh = cgrt.RenderConfig(width=24, height=24, backend="bvh")
    cfg_brute = dataclasses.replace(cfg_bvh, backend="brute")
    bvh0 = build_bvh(scene)
    plan = make_refit_plan(bvh0, scene)
    key = jax.random.PRNGKey(0)

    def loss_bvh(verts):
        s = dataclasses.replace(scene, vertices=verts)
        bvh = refit_accel(bvh0, s, plan)
        backend = make_backend(s, cfg_bvh, bvh=bvh)
        return jnp.sum(render_image(s, cgrt.Camera.default(), cfg_bvh,
                                    backend=backend, key=key) ** 2)

    def loss_brute(verts):
        s = dataclasses.replace(scene, vertices=verts)
        return jnp.sum(render_image(s, cgrt.Camera.default(), cfg_brute,
                                    key=key) ** 2)

    g_bvh = np.asarray(jax.jit(jax.grad(loss_bvh))(scene.vertices))
    g_brute = np.asarray(jax.jit(jax.grad(loss_brute))(scene.vertices))
    assert np.isfinite(g_bvh).all()
    assert np.abs(g_bvh).max() > 0
    np.testing.assert_allclose(g_bvh, g_brute, atol=1e-4, rtol=1e-3)


def test_vertex_grad_through_refit_matches_fd():
    """FD spot-check through the refit path on the smooth big-triangle scene
    (away from visibility discontinuities, mirroring test_grad's setup)."""
    from tests.test_grad import big_triangle_scene

    scene, camera = big_triangle_scene(ks=(0.3, 0.3, 0.3), shininess=8.0)
    cfg = cgrt.RenderConfig(width=32, height=32, backend="bvh")
    bvh0 = build_bvh(scene)
    plan = make_refit_plan(bvh0, scene)
    key = jax.random.PRNGKey(0)

    img0 = np.asarray(render_image(scene, camera, cfg, key=key,
                                   backend=make_backend(scene, cfg, bvh=bvh0)))
    hit = img0.max(axis=-1) > 0
    win = None
    for cy in range(2, cfg.height - 2):
        for cx in range(2, cfg.width - 2):
            cand = (slice(cy - 2, cy + 3), slice(cx - 2, cx + 3))
            if hit[cand].all():
                win = cand
    assert win is not None

    def loss(verts):
        s = dataclasses.replace(scene, vertices=verts)
        backend = make_backend(s, cfg, bvh=refit_accel(bvh0, s, plan))
        img = render_image(s, camera, cfg, backend=backend, key=key)
        return jnp.sum(img[win[0], win[1]])

    g = np.asarray(jax.jit(jax.grad(loss))(scene.vertices))
    loss_j = jax.jit(loss)
    for (vi, ci) in [(0, 2), (1, 2), (2, 0)]:
        eps = 1e-3
        vp = np.asarray(scene.vertices).copy(); vp[vi, ci] += eps
        vm = np.asarray(scene.vertices).copy(); vm[vi, ci] -= eps
        fd = (float(loss_j(jnp.asarray(vp))) - float(loss_j(jnp.asarray(vm)))) / (2 * eps)
        assert np.isclose(g[vi, ci], fd, rtol=0.05, atol=1e-3), (
            f"v{vi}.{ci}: autodiff {g[vi, ci]} vs FD {fd}")


def test_vertex_optimize_through_bvh_backend_converges():
    """End-to-end geometry optimization with backend='bvh' (refit per step,
    wired automatically by optimize when 'vertices' is among the params)."""
    from cg_raytracer.optim.inverse import (apply_vertex_params, optimize,
                                                vertex_params)
    from tests.test_grad import big_triangle_scene

    scene, cam = big_triangle_scene()
    cfg = cgrt.RenderConfig(width=48, height=48, backend="bvh")
    target = np.asarray(render_image(scene, cam, cfg, key=jax.random.PRNGKey(0)))
    shift = np.asarray([0.0, 0.0, 0.08], np.float32)
    perturbed = dataclasses.replace(
        scene, vertices=jnp.asarray(np.asarray(scene.vertices) + shift))

    params_v, losses_v = optimize(
        perturbed, cam, target, cfg, steps=100, learning_rate=1e-2,
        params=vertex_params(perturbed), apply_params=apply_vertex_params,
        log_every=0)
    assert losses_v[-1] < losses_v[0] * 0.25, (losses_v[0], losses_v[-1])
    final = np.asarray(render_image(
        apply_vertex_params(perturbed, params_v), cam, cfg,
        key=jax.random.PRNGKey(0)))
    assert np.abs(final - target).mean() < 2.5e-3
