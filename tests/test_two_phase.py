"""Two-phase gradient structure (models/whitted.py::trace_rays): phase 1
records every level's oracle outputs with the scene stop-gradded, phase 2
shades them differentiably.  Images and gradients must match the one-phase
path on every XLA backend, for point lights, spherical lights and spheres.

Capability anchor: the shading math being differentiated is
main.cpp:61-135 over ray_tracing.cpp:94-106."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cg_raytracer as cgrt
from cg_raytracer.models.whitted import (_synth_bounce, _two_phase_records,
                                         make_backend, render_image)
from cg_raytracer.ops import camera as cam_ops
from cg_raytracer.ops.intersect import reconstruct_hit, record_surface
from cg_raytracer.optim.inverse import apply_material_params, material_params


@pytest.fixture(scope="module")
def cornell():
    return cgrt.load_scene("cornell_box")


def _grads_close(g_ref, g, atol):
    for a, b in zip(g_ref, g):
        assert not bool(jnp.isnan(b).any())
        scale = float(jnp.abs(a).max()) + 1e-12
        np.testing.assert_allclose(np.asarray(b) / scale,
                                   np.asarray(a) / scale, atol=atol)


@pytest.mark.parametrize("backend", ["brute", "bvh"])
def test_two_phase_render_and_grads_match_one_phase(cornell, backend):
    cam = cgrt.Camera.default()
    key = jax.random.PRNGKey(7)
    cfg_ref = cgrt.RenderConfig(width=24, height=24, backend=backend,
                                grad_two_phase="off")
    cfg_2p = dataclasses.replace(cfg_ref, grad_two_phase="on")
    params = material_params(cornell)

    def loss(params_, cfg):
        s = apply_material_params(cornell, params_)
        img = render_image(s, cam, cfg, key=key)
        return jnp.mean(img), img

    (_, img0), g0 = jax.value_and_grad(
        lambda p: loss(p, cfg_ref), has_aux=True)(params)
    (_, img1), g1 = jax.value_and_grad(
        lambda p: loss(p, cfg_2p), has_aux=True)(params)
    np.testing.assert_allclose(np.asarray(img0), np.asarray(img1),
                               rtol=1e-5, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(np.asarray(g0[k]), np.asarray(g1[k]),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    # Recorded-rays path: identical image, identical material/light grads
    # (the dropped reflected-origin term only touches vertex grads).
    cfg_rec = dataclasses.replace(cfg_2p, two_phase_rays="recorded")
    (_, img2), g2 = jax.value_and_grad(
        lambda p: loss(p, cfg_rec), has_aux=True)(params)
    np.testing.assert_allclose(np.asarray(img0), np.asarray(img2),
                               rtol=1e-5, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(np.asarray(g0[k]), np.asarray(g2[k]),
                                   rtol=2e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("depth,quirks", [(3, False), (2, True)])
def test_two_phase_matches_one_phase_at_depth(cornell, depth, quirks):
    # The record phase's reflection rays (incl. the ks-comma quirk) must
    # reproduce the one-phase render at any depth.
    cam = cgrt.Camera.default()
    key = jax.random.PRNGKey(9)
    cfg_ref = cgrt.RenderConfig(width=24, height=24, backend="brute",
                                max_depth=depth, reference_quirks=quirks,
                                grad_two_phase="off")
    cfg_2p = dataclasses.replace(cfg_ref, grad_two_phase="on")
    img0 = np.asarray(render_image(cornell, cam, cfg_ref, key=key))
    img1 = np.asarray(render_image(cornell, cam, cfg_2p, key=key))
    np.testing.assert_allclose(img0, img1, rtol=1e-5, atol=1e-6)


def test_two_phase_vertex_grads_match_one_phase(cornell):
    # Vertex grads through the two-phase render equal the one-phase path —
    # incl. the reflected-ray-origin term (the cornell mirror makes bounce 1
    # carry real vertex dependence).
    cam = cgrt.Camera.default()
    key = jax.random.PRNGKey(3)
    cfg_ref = cgrt.RenderConfig(width=24, height=24, backend="brute",
                                grad_two_phase="off")
    cfg_2p = dataclasses.replace(cfg_ref, grad_two_phase="on")

    def loss(vertices, cfg):
        s = dataclasses.replace(cornell, vertices=vertices)
        return jnp.mean(render_image(s, cam, cfg, key=key))

    g0 = jax.grad(lambda v: loss(v, cfg_ref))(cornell.vertices)
    g1 = jax.grad(lambda v: loss(v, cfg_2p))(cornell.vertices)
    assert np.abs(np.asarray(g0)).max() > 0
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("backend", ["brute", "bvh"])
def test_record_surface_matches_reconstruct(cornell, backend):
    """The record phase's surfaces come from the recorded (t, u, v) without a
    Möller–Trumbore recompute; they must reproduce reconstruct_hit's
    position/normal/ks on every level, and the oracles' u/v must be real."""
    cfg = cgrt.RenderConfig(width=24, height=24, backend=backend, max_depth=2)
    be = make_backend(cornell, cfg)
    o, d = cam_ops.generate_rays(cgrt.Camera.default(), 24, 24)
    records = _two_phase_records(cornell, o, d, cfg, _synth_bounce(cornell, be))
    assert len(records) == 2
    for o_l, d_l, hit, _, _ in records:
        valid = np.asarray(hit.prim_id) >= 0
        assert valid.any()
        u = np.asarray(hit.u)[valid]
        v = np.asarray(hit.v)[valid]
        assert (np.abs(u) + np.abs(v)).max() > 0.0
        surf_ref = reconstruct_hit(cornell, o_l, d_l, hit)
        surf_rec = record_surface(cornell, o_l, d_l, hit)
        np.testing.assert_array_equal(np.asarray(surf_rec.valid),
                                      np.asarray(surf_ref.valid))
        np.testing.assert_allclose(np.asarray(surf_rec.position),
                                   np.asarray(surf_ref.position),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(surf_rec.normal),
                                   np.asarray(surf_ref.normal),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(surf_rec.ks),
                                   np.asarray(surf_ref.ks),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preset,backend", [
    ("cornell_box_spherical_light", "brute"),
    ("monkey_spherical_light", "bvh"),
])
def test_spherical_two_phase_matches_one_phase(preset, backend):
    """Phase 1 records per-level visibility fractions (an oracle, same PRNG
    stream); phase 2 scales the differentiable Phong terms by them.  Images
    and material + spherical light (+ vertex, on the brute route) grads
    match the one-phase chain."""
    scene = cgrt.load_scene(preset)
    cam = cgrt.Camera.default()
    cfg1 = cgrt.RenderConfig(width=24, height=24, backend=backend,
                             soft_shadow_samples=10, soft_shadow_chunk=5)
    cfg2 = dataclasses.replace(cfg1, grad_two_phase="on")
    img1 = cgrt.render(scene, cam, cfg1, jit=False)
    img2 = cgrt.render(scene, cam, cfg2, jit=False)
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img2), atol=1e-5)

    diff_verts = backend == "brute"

    def loss(kd, lp, lc, v, cfg):
        mats = dataclasses.replace(scene.materials, kd=kd)
        sl = dataclasses.replace(scene.spherical_lights, position=lp, color=lc)
        s = dataclasses.replace(scene, materials=mats, spherical_lights=sl,
                                vertices=v)
        return jnp.sum(cgrt.render(s, cam, cfg, jit=False) ** 2)

    args = (scene.materials.kd, scene.spherical_lights.position,
            scene.spherical_lights.color, scene.vertices)
    argnums = (0, 1, 2, 3) if diff_verts else (0, 1, 2)
    g1 = jax.grad(loss, argnums=argnums)(*args, cfg1)
    g2 = jax.grad(loss, argnums=argnums)(*args, cfg2)
    _grads_close(g1, g2, atol=3e-5)


def test_spherical_two_phase_bitwise():
    """The two-phase restructure is a pure partial-eval move for spherical
    scenes: bitwise-identical images and material grads."""
    scene = cgrt.load_scene("cornell_box_spherical_light")
    cam = cgrt.Camera.default()
    base = cgrt.RenderConfig(width=24, height=24, backend="brute",
                             soft_shadow_samples=10, soft_shadow_chunk=5)
    cfg2 = dataclasses.replace(base, grad_two_phase="on")
    img1 = cgrt.render(scene, cam, base, jit=False)
    img2 = cgrt.render(scene, cam, cfg2, jit=False)
    assert float(jnp.abs(img1 - img2).max()) == 0.0

    def loss(kd, cfg):
        mats = dataclasses.replace(scene.materials, kd=kd)
        s = dataclasses.replace(scene, materials=mats)
        return jnp.sum(cgrt.render(s, cam, cfg, jit=False) ** 2)

    g1 = jax.grad(loss)(scene.materials.kd, base)
    g2 = jax.grad(loss)(scene.materials.kd, cfg2)
    assert float(jnp.abs(g1 - g2).max()) == 0.0


def test_spherical_fracs_zero_radius_gradient():
    """The visibility fraction is an oracle: no gradient flows through it —
    d/d(radius) is exactly zero (the radius only shapes the sampled
    visibility, never the shading; main.cpp:174 uses the light CENTER)."""
    scene = cgrt.load_scene("cornell_box_spherical_light")
    cam = cgrt.Camera.default()
    cfg = cgrt.RenderConfig(width=8, height=8, backend="brute",
                            soft_shadow_samples=4, soft_shadow_chunk=4,
                            grad_two_phase="on")

    def loss(rad):
        sl = dataclasses.replace(scene.spherical_lights, radius=rad)
        s = dataclasses.replace(scene, spherical_lights=sl)
        return jnp.sum(render_image(s, cam, cfg, key=jax.random.PRNGKey(0)) ** 2)

    g = jax.grad(loss)(scene.spherical_lights.radius)
    assert float(jnp.abs(g).max()) == 0.0


def test_spheres_two_phase_kernel_matches_one_phase():
    """Sphere primitives (prim ids T + s) through the two-phase records."""
    scene = cgrt.load_scene("spheres")
    cam = cgrt.Camera.default()
    base = cgrt.RenderConfig(width=32, height=32, backend="brute")
    cfg2 = dataclasses.replace(base, grad_two_phase="on")
    img1 = np.asarray(cgrt.render(scene, cam, base, jit=False))
    img2 = np.asarray(cgrt.render(scene, cam, cfg2, jit=False))
    # Specular pow amplifies ulp differences; bound relative error.
    np.testing.assert_allclose(img2, img1, atol=2e-3, rtol=1e-3)

    def loss(center, radius, kd, lp, cfg):
        sp = dataclasses.replace(scene.spheres, center=center, radius=radius,
                                 kd=kd)
        pl = dataclasses.replace(scene.point_lights, position=lp)
        s = dataclasses.replace(scene, spheres=sp, point_lights=pl)
        return jnp.sum(cgrt.render(s, cam, cfg, jit=False) ** 2)

    args = (scene.spheres.center, scene.spheres.radius, scene.spheres.kd,
            scene.point_lights.position)
    g1 = jax.grad(loss, argnums=(0, 1, 2, 3))(*args, base)
    g2 = jax.grad(loss, argnums=(0, 1, 2, 3))(*args, cfg2)
    _grads_close(g1, g2, atol=1e-3)


def test_sphere_center_radius_grads_not_nan():
    """reconstruct_hit's sphere branch gates the discriminant at the input:
    sqrt(max(disc, 0)) has an infinite VJP at disc <= 0, and every
    non-sphere lane evaluates it on a clipped sphere id, so ungated
    center/radius grads were NaN on any scene with spheres."""
    scene = cgrt.load_scene("spheres")
    cam = cgrt.Camera.default()
    cfg = cgrt.RenderConfig(width=16, height=16, backend="brute")

    def loss(center, radius):
        sp = dataclasses.replace(scene.spheres, center=center, radius=radius)
        s = dataclasses.replace(scene, spheres=sp)
        return jnp.sum(cgrt.render(s, cam, cfg, jit=False))

    gc, gr = jax.grad(loss, argnums=(0, 1))(scene.spheres.center,
                                            scene.spheres.radius)
    assert not bool(jnp.isnan(gc).any())
    assert not bool(jnp.isnan(gr).any())
    assert float(jnp.abs(gc).max()) > 0.0


def test_mixed_point_and_spherical_lights_two_phase_matches():
    """Scenes carrying BOTH light kinds: bit-gated point terms and
    fraction-scaled spherical terms shade in one phase-2 pass."""
    from cg_raytracer.scene.types import PointLights

    base_scene = cgrt.load_scene("cornell_box_spherical_light")
    scene = dataclasses.replace(
        base_scene,
        point_lights=PointLights.of(((0.0, 0.58, 0.0), (0.7, 0.7, 0.7))))
    cam = cgrt.Camera.default()
    cfg1 = cgrt.RenderConfig(width=24, height=24, backend="brute",
                             soft_shadow_samples=10, soft_shadow_chunk=5)
    cfg2 = dataclasses.replace(cfg1, grad_two_phase="on")
    img1 = cgrt.render(scene, cam, cfg1, jit=False)
    img2 = cgrt.render(scene, cam, cfg2, jit=False)
    np.testing.assert_allclose(np.asarray(img2), np.asarray(img1), atol=1e-5)

    def loss(kd, plp, slp, cfg):
        mats = dataclasses.replace(scene.materials, kd=kd)
        pl = dataclasses.replace(scene.point_lights, position=plp)
        sl = dataclasses.replace(scene.spherical_lights, position=slp)
        s = dataclasses.replace(scene, materials=mats, point_lights=pl,
                                spherical_lights=sl)
        return jnp.sum(cgrt.render(s, cam, cfg, jit=False) ** 2)

    args = (scene.materials.kd, scene.point_lights.position,
            scene.spherical_lights.position)
    g1 = jax.grad(loss, argnums=(0, 1, 2))(*args, cfg1)
    g2 = jax.grad(loss, argnums=(0, 1, 2))(*args, cfg2)
    _grads_close(g1, g2, atol=3e-5)


def test_mixed_triangles_and_spheres_two_phase_matches():
    """Triangles + sphere primitives in one scene: sphere hits (prim >= T)
    override the triangle surface in the record and shade phases."""
    from cg_raytracer.scene.types import Spheres

    tri_scene = cgrt.load_scene("cornell_box")
    spheres = Spheres(
        center=jnp.asarray([[0.0, -0.2, 0.2]], jnp.float32),
        radius=jnp.asarray([0.18], jnp.float32),
        kd=jnp.asarray([[0.2, 0.4, 0.8]], jnp.float32),
        ks=jnp.asarray([[0.05, 0.05, 0.05]], jnp.float32),
        shininess=jnp.asarray([8.0], jnp.float32))
    scene = dataclasses.replace(tri_scene, spheres=spheres)
    cam = cgrt.Camera.default()
    base = cgrt.RenderConfig(width=32, height=32, backend="brute")
    cfg2 = dataclasses.replace(base, grad_two_phase="on")
    img1 = np.asarray(cgrt.render(scene, cam, base, jit=False))
    img2 = np.asarray(cgrt.render(scene, cam, cfg2, jit=False))
    # The sphere must actually be visible for this test to bite.
    assert np.abs(img1 - cgrt.render(tri_scene, cam, base, jit=False)).max() > 0.05
    np.testing.assert_allclose(img2, img1, atol=2e-3, rtol=1e-3)

    def loss(center, kd_tri, cfg):
        sp = dataclasses.replace(scene.spheres, center=center)
        mats = dataclasses.replace(scene.materials, kd=kd_tri)
        s = dataclasses.replace(scene, spheres=sp, materials=mats)
        return jnp.sum(cgrt.render(s, cam, cfg, jit=False) ** 2)

    args = (scene.spheres.center, scene.materials.kd)
    g1 = jax.grad(loss, argnums=(0, 1))(*args, base)
    g2 = jax.grad(loss, argnums=(0, 1))(*args, cfg2)
    _grads_close(g1, g2, atol=1e-3)
