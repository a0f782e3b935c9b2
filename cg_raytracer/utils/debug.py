"""Debug data renders — the headless replacement for interactive debug draw.

Reference capability: the R-key debug-ray workflow and per-level BVH visualization
(``src/draw.cpp:159-180``, ``src/main.cpp:742-762,896-903``,
``src/bounding_volume_hierarchy.cpp:469-525``).  A headless framework returns debug
*data* instead of GL lines: per-ray traces (hit ids, t, normals, shadow outcomes)
as arrays, plus host-side helpers to rasterize BVH level boxes into a matplotlib/PIL
friendly form.
"""
from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..models.whitted import Backend, make_backend
from ..ops import camera as cam_ops
from ..ops.intersect import reconstruct_hit
from ..ops.linalg import norm, safe_normalize
from ..scene.types import Camera, Scene
from ..utils.config import RenderConfig


def debug_trace(scene: Scene, camera: Camera, ndc, cfg: RenderConfig | None = None,
                backend: Backend | None = None) -> Dict:
    """Trace one (or a batch of) debug ray(s) and return its full fate.

    The data equivalent of pressing R in the reference (main.cpp:747-753): for each
    bounce level, the hit id / t / position / normal, and per point light whether the
    shadow ray was occluded — everything the reference draws as colored GL lines
    (white=hit, red=miss/occluded, blue=normal, green=lit).
    """
    cfg = cfg or RenderConfig()
    if backend is None:
        backend = make_backend(scene, cfg)
    ndc = jnp.atleast_2d(jnp.asarray(ndc, jnp.float32))
    origin, dirs = cam_ops.generate_ray(camera, ndc)
    origins = jnp.broadcast_to(origin, dirs.shape)

    out = {"levels": []}
    o, d = origins, dirs
    for level in range(cfg.max_depth):
        hit = backend.closest(o, d)
        surf = reconstruct_hit(scene, o, d, hit)
        level_info = {
            "origin": np.asarray(o),
            "direction": np.asarray(d),
            "hit": np.asarray(surf.valid),
            "t": np.asarray(hit.t),
            "prim_id": np.asarray(hit.prim_id),
            "position": np.asarray(surf.position),
            "normal": np.asarray(surf.normal),
            "shadowed_by_light": [],
        }
        num_lights = scene.point_lights.position.shape[0]
        for li in range(num_lights):
            lpos = scene.point_lights.position[li]
            to_light = lpos - surf.position
            dist = norm(to_light)
            ldir = safe_normalize(to_light)
            blocked = backend.occluded(surf.position + 1e-3 * ldir, ldir, dist - 1e-3)
            level_info["shadowed_by_light"].append(np.asarray(blocked & surf.valid))
        out["levels"].append(level_info)

        refl = safe_normalize(
            d - 2.0 * jnp.sum(d * surf.normal, axis=-1, keepdims=True) * surf.normal
        )
        o = surf.position + 1e-3 * refl
        d = refl
    return out


def hit_statistics(scene: Scene, camera: Camera, cfg: RenderConfig,
                   backend: Backend | None = None) -> Dict:
    """Whole-grid debug arrays: hit mask, t-buffer, prim ids (for notebook viz)."""
    if backend is None:
        backend = make_backend(scene, cfg)
    origins, dirs = cam_ops.generate_rays(camera, cfg.height, cfg.width)
    hit = backend.closest(origins, dirs)
    shape = (cfg.height, cfg.width)
    return {
        "hit": np.asarray(hit.prim_id >= 0).reshape(shape),
        "t": np.asarray(hit.t).reshape(shape),
        "prim_id": np.asarray(hit.prim_id).reshape(shape),
        "u": np.asarray(hit.u).reshape(shape),
        "v": np.asarray(hit.v).reshape(shape),
    }


def render_bvh_levels(scene: Scene, camera: Camera, level: int,
                      width: int = 400, height: int = 400, bvh=None,
                      base=None) -> np.ndarray:
    """Visualize one BVH level as wireframe AABBs over a (dimmed) render —
    the headless equivalent of the reference's debugDraw slider view
    (bvh.cpp:469-525, main.cpp:805-807, leaf/inner color-coded).

    Host-side numpy utility (debug tooling, not a jit path).  Returns
    [H, W, 3] float32: inner nodes red, leaves green, over 0.5x ``base``
    (a fresh small render when None).
    """
    import jax.numpy as jnp

    from ..models.whitted import render as _render
    from ..ops import camera as cam_ops
    from ..ops.bvh import build_bvh
    from ..utils.config import RenderConfig

    if bvh is None:
        bvh = build_bvh(scene)
    lo, hi, is_leaf = bvh_level_boxes(bvh, level)
    if base is None:
        base = _render(scene, camera, RenderConfig(width=width, height=height))
    img = 0.5 * np.asarray(base, np.float32).copy()

    # Forward projection (inverse of generate_ray): world -> camera space via the
    # conjugate quat, then ndc = (-x / (z*half_w), y / (z*half_h)).
    q = np.asarray(cam_ops.quat_from_euler(camera.euler))
    q_conj = np.asarray([q[0], -q[1], -q[2], -q[3]], np.float32)
    cam_pos = np.asarray(cam_ops.camera_position(camera))
    half_h = float(np.tan(float(camera.fovy) / 2.0))
    half_w = float(camera.aspect) * half_h

    def project(pts):  # [K,3] world -> (cols, rows, in_front) in pixel coords
        rel = jnp.asarray(pts, jnp.float32) - cam_pos
        pc = np.asarray(cam_ops.quat_rotate(jnp.asarray(q_conj), rel))
        z = np.maximum(pc[:, 2], 1e-6)
        ndc_x = -pc[:, 0] / (z * half_w)
        ndc_y = pc[:, 1] / (z * half_h)
        cols = (ndc_x + 1.0) / 2.0 * width
        rows = height - 1 - (ndc_y + 1.0) / 2.0 * height
        return cols, rows, pc[:, 2] > 1e-4

    EDGES = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    for b_lo, b_hi, leaf in zip(lo, hi, is_leaf):
        corners = np.array([[b_lo[0] if not (k & 1) else b_hi[0],
                             b_lo[1] if not (k & 2) else b_hi[1],
                             b_lo[2] if not (k & 4) else b_hi[2]]
                            for k in range(8)], np.float32)
        cols, rows, ok = project(corners)
        color = np.array([0.1, 0.9, 0.2] if leaf else [0.9, 0.2, 0.1], np.float32)
        for a, b in EDGES:
            if not (ok[a] and ok[b]):
                continue
            steps = int(max(abs(cols[b] - cols[a]), abs(rows[b] - rows[a]), 1))
            t = np.linspace(0.0, 1.0, min(steps + 1, 4 * max(width, height)))
            cs = np.clip(cols[a] + t * (cols[b] - cols[a]), 0, width - 1).astype(int)
            rs = np.clip(rows[a] + t * (rows[b] - rows[a]), 0, height - 1).astype(int)
            img[rs, cs] = 0.35 * img[rs, cs] + 0.65 * color
    return img


def bvh_level_boxes(bvh, level: int):
    """AABBs (lo, hi, is_leaf) of all nodes at a given tree level — the data behind
    the reference's per-level debugDraw slider (bvh.cpp:469-525, main.cpp:805-807)."""
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    depth = np.zeros(left.shape[0], np.int32)
    for i in range(left.shape[0]):
        for c in (left[i], right[i]):
            if c >= 0:
                depth[c] = depth[i] + 1
    sel = depth == level
    return (
        np.asarray(bvh.node_lo)[sel],
        np.asarray(bvh.node_hi)[sel],
        (np.asarray(bvh.count) > 0)[sel],
    )
