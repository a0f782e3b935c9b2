"""End-to-end render tests: semantics, backend agreement, golden regression."""
import dataclasses

import jax
import numpy as np
import pytest

import cg_raytracer as cgrt
from tests.conftest import assert_images_close

CFG64 = cgrt.RenderConfig(width=64, height=64)


def _render(scene, cfg=CFG64, camera=None, **kw):
    camera = camera or cgrt.Camera.default()
    return np.asarray(cgrt.render(scene, camera, cfg, **kw))


def test_miss_is_black(scenes):
    # trace(): miss -> black (main.cpp:289-294).  Corner rays miss the triangle.
    img = _render(scenes("single_triangle"))
    assert img[0, 0].max() == 0.0
    assert img.max() > 0.0  # something is lit


def test_backend_agreement(scenes):
    for name in ["cube", "cornell_box", "monkey"]:
        scene = scenes(name)
        brute = _render(scene, dataclasses.replace(CFG64, backend="brute"))
        bvh = _render(scene, dataclasses.replace(CFG64, backend="bvh"))
        assert_images_close(brute, bvh, msg=f"{name} brute vs bvh")


def test_cornell_semantics(scenes):
    img = _render(scenes("cornell_box"), cgrt.RenderConfig(width=96, height=96))
    h, w, _ = img.shape
    hit = img.max(axis=-1) > 0
    assert hit.mean() > 0.1
    # Red left wall: among lit pixels, some have strongly red-dominant color.
    red_dom = (img[..., 0] > 0.1) & (img[..., 0] > 3 * img[..., 1])
    assert red_dom.any()
    # Hard shadows exist: lit pixels span a wide brightness range.
    bright = img.sum(axis=-1)[hit]
    assert bright.max() / max(bright[bright > 0].min(), 1e-6) > 5


def test_mirror_reflection_depth(scenes):
    # The Cornell mirror wall contributes only at max_depth >= 2 (shade() recursion,
    # main.cpp:241-264).
    scene = scenes("cornell_box")
    img1 = _render(scene, dataclasses.replace(CFG64, max_depth=1))
    img2 = _render(scene, dataclasses.replace(CFG64, max_depth=2))
    diff = np.abs(img2 - img1).max(axis=-1)
    assert (diff > 1e-3).sum() > 10  # mirror region differs
    # Reflection only adds energy (ks-weighted addition, main.cpp:263).
    assert (img2 - img1).min() >= -1e-5


def test_shadowing_darkens(scenes):
    # Moving the light far away must not brighten; blocking geometry must darken
    # some pixels relative to a no-shadow render.  Compare against a light placed
    # inside the box vs outside.
    scene = scenes("cube")
    img = _render(scene)
    # With the light at (-1,1,-1) (scene.cpp:19) parts of the cube faces facing away
    # are black while facing parts are lit.
    lit = img.max(axis=-1)
    assert (lit > 0.05).any() and ((lit < 1e-6).mean() > 0.3)


def test_point_light_shadow_occlusion():
    # Two parallel triangles; light behind the second one -> first is shadowed.
    from cg_raytracer.scene.types import PointLights, make_scene

    # Winding chosen so the face normal cross(v1-v0, v2-v0) = (0,0,-1) faces the
    # camera (no facing flip) and matches the vertex normals.
    tri = {
        "vertices": np.asarray([[-1, -1, 0], [3, -1, 0], [-1, 3, 0]], np.float32),
        "normals": np.asarray([[0, 0, -1]] * 3, np.float32),
        "triangles": np.asarray([[0, 2, 1]], np.int32),
        "material": {"kd": (1, 1, 1), "ks": (0, 0, 0), "shininess": 1.0},
    }
    # Blocker at z=-1 covering the shadow path from the surface center to the light
    # at (2, 0.5, -2), while staying clear of the center pixels' primary rays.
    blocker = {
        "vertices": np.asarray([[0.75, -0.5, -1], [1.75, -0.5, -1], [1.25, 1.5, -1]],
                               np.float32),
        "normals": np.asarray([[0, 0, -1]] * 3, np.float32),
        "triangles": np.asarray([[0, 2, 1]], np.int32),
        "material": {"kd": (1, 1, 1), "ks": (0, 0, 0), "shininess": 1.0},
    }
    light = ((2.0, 0.5, -2.0), (1.0, 1.0, 1.0))
    cam = cgrt.Camera.default(euler_deg=(0, 0, 0), dist=3.0, look_at=(0.5, 0.5, 0.0))
    shadowed = make_scene([tri, blocker], point_lights=PointLights.of(light))
    img_s = _render(shadowed, camera=cam)
    unshadowed = make_scene([tri], point_lights=PointLights.of(light))
    img_u = _render(unshadowed, camera=cam)
    center = (slice(28, 36), slice(28, 36))
    assert img_u[center].max() > 0.1  # lit without the blocker...
    assert img_s[center].max() < 1e-6  # ...black with it (pointInShadow semantics)


def test_soft_shadows_partial_visibility(scenes):
    scene = scenes("cornell_box_spherical_light")
    cfg = cgrt.RenderConfig(width=48, height=48, soft_shadow_samples=16,
                            soft_shadow_chunk=8)
    img = _render(scene, cfg)
    vals = img.sum(axis=-1)
    lit = vals[vals > 1e-6]
    assert lit.size > 50
    # Penumbra: visibility fractions produce intermediate intensities.
    assert np.unique(np.round(lit, 3)).size > 20


def test_soft_shadows_deterministic(scenes):
    scene = scenes("cornell_box_spherical_light")
    cfg = cgrt.RenderConfig(width=32, height=32, soft_shadow_samples=8,
                            soft_shadow_chunk=4)
    k = jax.random.PRNGKey(7)
    a = _render(scene, cfg, key=k)
    b = _render(scene, cfg, key=k)
    np.testing.assert_array_equal(a, b)
    c = _render(scene, cfg, key=jax.random.PRNGKey(8))
    assert np.abs(a - c).max() > 0


def test_spheres_scene(scenes):
    img = _render(scenes("spheres"))
    assert img.max() > 0.5  # light color 15 saturates sphere surfaces
    assert (img.max(axis=-1) > 0).mean() < 0.5  # mostly background


def test_render_chunked_matches(scenes):
    scene = scenes("cube")
    full = _render(scene)
    chunked = _render(scene, dataclasses.replace(CFG64, ray_chunk=512))
    np.testing.assert_allclose(full, chunked, atol=1e-5)


def test_table2_custom_presets(scenes):
    # Report Table 2's Teacup/Donut scenes: procedural stand-ins at the reported
    # triangle counts.  Both are past the brute-force cap, so 'auto' routes
    # them to a BVH backend and build_accel builds (and memoizes) the tree.
    from cg_raytracer.models.whitted import build_accel
    from cg_raytracer.ops.bvh import BVH

    teacup = scenes("teacup")
    assert teacup.num_triangles == 48_000
    donut = scenes("donut")
    assert donut.num_triangles == 320_000
    cfg = cgrt.RenderConfig(width=8, height=8)
    assert cfg.resolve_backend(donut.num_triangles, platform="cpu") == "bvh"
    accel = build_accel(donut, cfg)
    assert isinstance(accel, BVH)
    assert build_accel(donut, cfg) is accel
    # Teacup renders something sensible through the jnp BVH backend.
    img = _render(teacup, cgrt.RenderConfig(width=32, height=32, backend="bvh"))
    assert img.max() > 0.0


# Golden regression moved to tests/test_golden_images.py: full [H,W,3]
# per-pixel pins (default + reference_quirks + effects) replace the round-1
# scalar mean-brightness checks.
