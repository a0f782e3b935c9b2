"""Camera: trackball orbit model + vectorized primary-ray generation.

Reference capability: ``Trackball::generateRay`` and ``Trackball::position``
(``framework/src/trackball.cpp:70-103``).  Conventions reproduced
exactly for pixel parity:

- camera position = lookAt + quat(euler) * (0, 0, -dist)             (trackball.cpp:72)
- camera-space ray direction = normalize(-px*halfW, py*halfH, 1)     (trackball.cpp:96,
  note the negated x) with halfH = tan(fovy/2), halfW = aspect*halfH,
- world direction = quat(euler) * cameraDir                          (trackball.cpp:100)
- NDC of pixel (x, y): (x/W*2-1, y/H*2-1) with y=0 at the *bottom*   (main.cpp:690-693)
  and the framebuffer y-flip applied at write time                   (screen.cpp:30-36).

Instead of one ray per call we emit the whole [H, W] grid in image-row order
(row 0 = top of image), so the output image needs no flip.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..scene.types import Camera
from .linalg import normalize


def quat_from_euler(euler):
    """glm::quat(vec3 euler) — the exact component formula glm uses.

    Returns (w, x, y, z) stacked on the last axis.
    """
    half = euler * 0.5
    c = jnp.cos(half)
    s = jnp.sin(half)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    w = cx * cy * cz + sx * sy * sz
    x = sx * cy * cz - cx * sy * sz
    y = cx * sy * cz + sx * cy * sz
    z = cx * cy * sz - sx * sy * cz
    return jnp.stack([w, x, y, z], axis=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q = (w, x, y, z).

    v' = v + 2 * cross(q.xyz, cross(q.xyz, v) + w * v). Broadcasts over leading axes.
    """
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    uuv = jnp.cross(u, uv + w * v)
    return v + 2.0 * uuv


def camera_position(cam: Camera):
    """lookAt + quat * (0, 0, -dist)  (trackball.cpp:70-73)."""
    q = quat_from_euler(cam.euler)
    offset = jnp.stack([jnp.zeros_like(cam.dist), jnp.zeros_like(cam.dist), -cam.dist])
    return cam.look_at + quat_rotate(q, offset)


def generate_ray(cam: Camera, ndc):
    """Single-ray parity entry point: ndc in [-1, 1]^2 -> (origin [3], dir [3])."""
    half_h = jnp.tan(cam.fovy / 2.0)
    half_w = cam.aspect * half_h
    cam_dir = normalize(jnp.stack([-ndc[..., 0] * half_w, ndc[..., 1] * half_h,
                                   jnp.ones_like(ndc[..., 0])], axis=-1))
    q = quat_from_euler(cam.euler)
    direction = quat_rotate(q, cam_dir)
    origin = camera_position(cam)
    return origin, direction


def pixel_ndc(height: int, width: int, offset=(0.0, 0.0)):
    """NDC coordinates for each pixel in image-row order, [H, W, 2].

    Image row r corresponds to screen y = H-1-r (the reference's setPixel y-flip,
    screen.cpp:34), and the reference samples pixel corners (no +0.5), main.cpp:691-693.
    ``offset`` is an extra (x, y) shift in pixel units (used for AA subsamples).
    """
    xs = (jnp.arange(width, dtype=jnp.float32) + offset[0]) / width * 2.0 - 1.0
    ys_screen = (jnp.arange(height - 1, -1, -1, dtype=jnp.float32) + offset[1]) / height * 2.0 - 1.0
    px = jnp.broadcast_to(xs[None, :], (height, width))
    py = jnp.broadcast_to(ys_screen[:, None], (height, width))
    return jnp.stack([px, py], axis=-1)


ROTATION_SPEED_DEG_PER_PX = 0.3  # trackball.cpp:13
TRANSLATION_SPEED = 0.005  # trackball.cpp:14
ZOOM_SPEED = 0.5  # trackball.cpp:15


def orbit(cam: Camera, delta_px):
    """Left-drag orbit (trackball.cpp:138-141): pitch clamped to +-pi/2."""
    import numpy as _np

    dx, dy = delta_px
    ex = jnp.clip(cam.euler[0] - jnp.radians(dy * ROTATION_SPEED_DEG_PER_PX),
                  -_np.pi / 2, _np.pi / 2)
    ey = cam.euler[1] - jnp.radians(dx * ROTATION_SPEED_DEG_PER_PX)
    return Camera(look_at=cam.look_at, euler=jnp.stack([ex, ey, cam.euler[2]]),
                  dist=cam.dist, fovy=cam.fovy, aspect=cam.aspect)


def pan(cam: Camera, delta_px):
    """Right-drag pan in the image plane (trackball.cpp:143-147)."""
    dx, dy = delta_px
    q = quat_from_euler(cam.euler)
    left = quat_rotate(q, jnp.asarray([1.0, 0.0, 0.0]))
    up = quat_rotate(q, jnp.asarray([0.0, 1.0, 0.0]))
    look_at = cam.look_at + dx * TRANSLATION_SPEED * left - dy * TRANSLATION_SPEED * up
    return Camera(look_at=look_at, euler=cam.euler, dist=cam.dist,
                  fovy=cam.fovy, aspect=cam.aspect)


def zoom(cam: Camera, scroll_y):
    """Scroll zoom (trackball.cpp:152-157): dist clamped to [0.1, 100]."""
    dist = jnp.clip(cam.dist - scroll_y * ZOOM_SPEED, 0.1, 100.0)
    return Camera(look_at=cam.look_at, euler=cam.euler, dist=dist,
                  fovy=cam.fovy, aspect=cam.aspect)


def generate_rays(cam: Camera, height: int, width: int, offset=(0.0, 0.0)):
    """Vectorized ray grid: returns (origins [H*W, 3], dirs [H*W, 3]).

    The origin is shared (pinhole); it is broadcast to the ray batch so downstream
    code can treat rays uniformly (and reflection rays get per-ray origins).
    """
    ndc = pixel_ndc(height, width, offset).reshape(-1, 2)
    origin, dirs = generate_ray(cam, ndc)
    origins = jnp.broadcast_to(origin, dirs.shape)
    return origins, dirs
