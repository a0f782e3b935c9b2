"""Multi-device tests on the 8-virtual-CPU mesh (SURVEY §4 test strategy)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import cg_raytracer as cgrt
from cg_raytracer.optim.inverse import apply_material_params, material_params
from cg_raytracer.parallel.sharding import (make_mesh, make_train_step,
                                                replicated, row_sharded,
                                                sharded_render)

CFG = cgrt.RenderConfig(width=32, height=32)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8  # conftest forces 8 virtual CPU devices


def test_sharded_render_matches_single_device(scenes):
    scene = scenes("cornell_box")
    cam = cgrt.Camera.default()
    single = np.asarray(cgrt.render(scene, cam, CFG))
    mesh = make_mesh()
    sharded = sharded_render(scene, cam, CFG, mesh)
    # The image really is distributed over the mesh.
    assert len(sharded.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(sharded), single, atol=1e-5)


def test_sharded_render_soft_shadows_deterministic(scenes):
    # Counter-based PRNG: per-(pixel, sample) streams are sharding-invariant, so
    # single-device and 8-device renders of a stochastic scene are identical.
    scene = scenes("cornell_box_spherical_light")
    cfg = cgrt.RenderConfig(width=16, height=16, soft_shadow_samples=4,
                            soft_shadow_chunk=2)
    cam = cgrt.Camera.default()
    single = np.asarray(cgrt.render(scene, cam, cfg))
    mesh = make_mesh()
    sharded = np.asarray(sharded_render(scene, cam, cfg, mesh))
    np.testing.assert_allclose(sharded, single, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_sample_axis_sharding_matches_single_device(scenes, shape):
    # 2-D ('rays','samples') mesh: soft-shadow sample chunks split over the
    # second axis; per-(light, chunk) keys are mesh-independent, so the result
    # is identical to the unsharded render for any mesh shape.
    from cg_raytracer.parallel.sharding import (make_mesh2,
                                                    sample_sharded_render)

    scene = scenes("cornell_box_spherical_light")
    cfg = cgrt.RenderConfig(width=16, height=16, soft_shadow_samples=8,
                            soft_shadow_chunk=4)
    cam = cgrt.Camera.default()
    single = np.asarray(cgrt.render(scene, cam, cfg))
    mesh = make_mesh2(*shape)
    assert mesh.devices.shape == shape
    sharded = sample_sharded_render(scene, cam, cfg, mesh)
    assert len(sharded.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(sharded), single, atol=1e-6)


def test_train_step_on_mesh(scenes):
    scene = scenes("cube")
    cam = cgrt.Camera.default()
    mesh = make_mesh()
    params = material_params(scene)
    optimizer = optax.adam(1e-2)
    opt_state = optimizer.init(params)
    step = make_train_step(CFG, optimizer, apply_material_params, mesh=mesh)

    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)
    rep = replicated(mesh)
    scene_r = jax.device_put(scene, rep)
    cam_r = jax.device_put(cam, rep)
    params = jax.device_put(params, rep)
    opt_state = jax.device_put(opt_state, rep)
    target = jax.device_put(target, row_sharded(mesh))

    with mesh:
        losses = []
        for i in range(3):
            params, opt_state, loss = step(params, opt_state, scene_r, cam_r,
                                           target, jax.random.PRNGKey(i))
            losses.append(float(loss))
    assert all(np.isfinite(losses))
    # Driving toward a black target must reduce the loss.
    assert losses[-1] < losses[0]


def test_train_step_mesh_matches_single(scenes):
    # Gradient all-reduce correctness: one step on the mesh == one step on a single
    # device (same params, same key).
    scene = scenes("cube")
    cam = cgrt.Camera.default()
    params0 = material_params(scene)
    optimizer = optax.adam(1e-2)
    target = jnp.full((CFG.height, CFG.width, 3), 0.25, jnp.float32)
    key = jax.random.PRNGKey(0)

    step_single = make_train_step(CFG, optimizer, apply_material_params, mesh=None)
    p1, _, l1 = step_single(params0, optimizer.init(params0), scene, cam, target, key)

    mesh = make_mesh()
    step_mesh = make_train_step(CFG, optimizer, apply_material_params, mesh=mesh)
    rep = replicated(mesh)
    with mesh:
        p8, _, l8 = step_mesh(
            jax.device_put(params0, rep),
            jax.device_put(optimizer.init(params0), rep),
            jax.device_put(scene, rep),
            jax.device_put(cam, rep),
            jax.device_put(target, row_sharded(mesh)),
            key,
        )
    assert np.isclose(float(l1), float(l8), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p8)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_graft_entry_and_dryrun():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fn, args = mod.entry()
    img = jax.jit(fn)(*args)
    assert img.shape == (128, 128, 3)
    assert bool(jnp.isfinite(img).all())

    mod.dryrun_multichip(8)
