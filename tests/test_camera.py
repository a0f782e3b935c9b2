"""Camera convention tests vs the reference Trackball (trackball.cpp:70-103)."""
import numpy as np
import jax.numpy as jnp

import cg_raytracer as cgrt
from cg_raytracer.ops.camera import (camera_position, generate_ray,
                                         generate_rays, pixel_ndc,
                                         quat_from_euler, quat_rotate)


def test_identity_euler_conventions():
    cam = cgrt.Camera.default(euler_deg=(0, 0, 0), dist=3.0, fovy_deg=50.0)
    # position = lookAt + quat * (0,0,-dist) = (0,0,-3) for identity rotation.
    np.testing.assert_allclose(np.asarray(camera_position(cam)), [0, 0, -3], atol=1e-6)
    # Center ray looks along +z (camera-space dir (0,0,1), trackball.cpp:96).
    o, d = generate_ray(cam, jnp.asarray([0.0, 0.0]))
    np.testing.assert_allclose(np.asarray(d), [0, 0, 1], atol=1e-6)
    # NDC +x maps to *negative* world x (the negated-x quirk, trackball.cpp:96).
    _, d = generate_ray(cam, jnp.asarray([1.0, 0.0]))
    assert float(d[0]) < 0
    # NDC +y maps to +y.
    _, d = generate_ray(cam, jnp.asarray([0.0, 1.0]))
    assert float(d[1]) > 0
    # Half-screen extent = tan(fovy/2) * aspect.
    _, d = generate_ray(cam, jnp.asarray([-1.0, 0.0]))
    expected = np.array([np.tan(np.radians(25.0)), 0.0, 1.0])
    expected /= np.linalg.norm(expected)
    np.testing.assert_allclose(np.asarray(d), expected, atol=1e-6)


def test_quat_rotation_matches_glm():
    # pitch +90 deg about x maps +z to -y under glm's quat convention.
    q = quat_from_euler(jnp.asarray([np.pi / 2, 0.0, 0.0]))
    v = quat_rotate(q, jnp.asarray([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(np.asarray(v), [0, -1, 0], atol=1e-6)
    # yaw +90 deg about y maps +z to +x.
    q = quat_from_euler(jnp.asarray([0.0, np.pi / 2, 0.0]))
    v = quat_rotate(q, jnp.asarray([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(np.asarray(v), [1, 0, 0], atol=1e-6)
    # Rotation preserves length for arbitrary euler.
    q = quat_from_euler(jnp.asarray([0.3, -0.7, 0.2]))
    v = quat_rotate(q, jnp.asarray([1.0, 2.0, 3.0]))
    assert np.isclose(np.linalg.norm(np.asarray(v)), np.linalg.norm([1, 2, 3]), atol=1e-5)


def test_default_camera_position():
    # Reference default: rot (20,20,0) deg, dist 3 (main.cpp:731).
    cam = cgrt.Camera.default()
    pos = np.asarray(camera_position(cam))
    assert np.isclose(np.linalg.norm(pos), 3.0, atol=1e-5)
    # With pitch 20 up / yaw 20: camera sits at -z side, above and to -x.
    assert pos[2] < 0 and pos[1] > 0


def test_pixel_grid_ordering():
    # Image row 0 = top of image = screen y = H-1 (screen.cpp:34 y-flip).
    ndc = np.asarray(pixel_ndc(4, 4))
    assert ndc[0, 0, 1] > ndc[3, 0, 1]  # top row has larger ndc y
    assert ndc[0, 0, 0] < ndc[0, 3, 0]  # left col has smaller ndc x
    # Reference NDC: x/W*2-1 without half-pixel offset (main.cpp:691-693).
    np.testing.assert_allclose(ndc[3, 0], [-1.0, -1.0], atol=1e-6)


def test_generate_rays_shapes_and_unit_norm():
    cam = cgrt.Camera.default()
    o, d = generate_rays(cam, 8, 16)
    assert o.shape == (128, 3) and d.shape == (128, 3)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=1), 1.0, atol=1e-5)
    # All origins equal the camera position (pinhole).
    pos = np.broadcast_to(np.asarray(camera_position(cam)), (128, 3))
    np.testing.assert_allclose(np.asarray(o), pos, atol=1e-6)


def test_trackball_interactions():
    from cg_raytracer.ops.camera import orbit, pan, zoom

    cam = cgrt.Camera.default()
    # Orbit changes euler only; pitch clamps at +-pi/2 (trackball.cpp:140).
    c2 = orbit(cam, (10.0, -2000.0))
    assert np.isclose(float(c2.euler[0]), np.pi / 2)
    np.testing.assert_allclose(np.asarray(c2.look_at), np.asarray(cam.look_at))
    # Pan moves look_at in the image plane, preserving dist/euler.
    c3 = pan(cam, (100.0, 0.0))
    assert not np.allclose(np.asarray(c3.look_at), np.asarray(cam.look_at))
    assert np.allclose(np.asarray(c3.euler), np.asarray(cam.euler))
    # Zoom clamps dist to [0.1, 100] (trackball.cpp:156).
    c4 = zoom(cam, 1000.0)
    assert np.isclose(float(c4.dist), 0.1)
    c5 = zoom(cam, -1000.0)
    assert np.isclose(float(c5.dist), 100.0)
