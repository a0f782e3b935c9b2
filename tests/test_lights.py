"""Light-editor API tests (the reference's ImGui panel, main.cpp:812-876)."""
import numpy as np
import pytest

import cg_raytracer as cgrt
from cg_raytracer.scene import lights as le


def test_add_point_light(scenes):
    scene = scenes("cube")
    n0 = scene.point_lights.position.shape[0]
    s2 = le.add_point_light(scene)  # reference defaults: pos 0, color 1
    assert s2.point_lights.position.shape[0] == n0 + 1
    np.testing.assert_array_equal(np.asarray(s2.point_lights.position[-1]), 0.0)
    np.testing.assert_array_equal(np.asarray(s2.point_lights.color[-1]), 1.0)
    # Original scene untouched (pure function).
    assert scene.point_lights.position.shape[0] == n0


def test_add_spherical_light_defaults(scenes):
    s2 = le.add_spherical_light(scenes("cube"))
    assert s2.spherical_lights.position.shape[0] == 1
    assert float(s2.spherical_lights.radius[-1]) == pytest.approx(0.1)


def test_remove_light_unified_index(scenes):
    scene = scenes("monkey")  # 2 point lights (scene.cpp:26-31)
    scene = le.add_spherical_light(scene, position=(1, 2, 3), radius=0.25)
    assert le.num_lights(scene) == 3
    # Unified index 2 = the spherical light.
    s2 = le.remove_light(scene, 2)
    assert s2.spherical_lights.position.shape[0] == 0
    assert s2.point_lights.position.shape[0] == 2
    # Index 0 = first point light.
    s3 = le.remove_light(scene, 0)
    assert s3.point_lights.position.shape[0] == 1
    np.testing.assert_allclose(np.asarray(s3.point_lights.position[0]),
                               np.asarray(scene.point_lights.position[1]))


def test_set_light_point_and_spherical(scenes):
    scene = le.add_spherical_light(scenes("cube"), position=(0, 1, 0), radius=0.1)
    npl = scene.point_lights.position.shape[0]
    s2 = le.set_light(scene, 0, position=(9, 9, 9), color=(0.5, 0, 0))
    np.testing.assert_array_equal(np.asarray(s2.point_lights.position[0]),
                                  [9, 9, 9])
    s3 = le.set_light(scene, npl, radius=0.4, color=(2, 2, 2))
    assert float(s3.spherical_lights.radius[0]) == pytest.approx(0.4)
    np.testing.assert_array_equal(np.asarray(s3.spherical_lights.color[0]), 2.0)


def test_set_light_errors(scenes):
    scene = scenes("cube")
    with pytest.raises(IndexError):
        le.set_light(scene, 99, position=(0, 0, 0))
    with pytest.raises(ValueError, match="point light"):
        le.set_light(scene, 0, radius=0.5)


def test_apply_edits_sequential_removes(scenes):
    scene = scenes("monkey")  # 2 point lights
    # Two sequential removes of index 0 (re-indexing like repeated button
    # presses) empty the point-light list.
    s2 = le.apply_edits(scene, removes=[0, 0],
                        add_points=[(0, 2, 0, 1, 1, 1)])
    assert s2.point_lights.position.shape[0] == 1
    np.testing.assert_array_equal(np.asarray(s2.point_lights.position[0]),
                                  [0, 2, 0])


def test_edited_lights_change_render(scenes):
    scene = scenes("cube")
    cfg = cgrt.RenderConfig(width=24, height=24)
    cam = cgrt.Camera.default()
    base = np.asarray(cgrt.render(scene, cam, cfg))
    moved = le.set_light(scene, 0, color=(3, 0, 0))
    img = np.asarray(cgrt.render(moved, cam, cfg))
    assert not np.allclose(base, img)
