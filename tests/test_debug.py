"""Debug-data API tests (the data equivalent of the reference's debug draw, C11)."""
import numpy as np

import cg_raytracer as cgrt
from cg_raytracer.ops.bvh import build_bvh, bvh_num_levels
from cg_raytracer.utils.debug import bvh_level_boxes, debug_trace, hit_statistics

CFG = cgrt.RenderConfig(width=24, height=24)


def test_debug_trace_hit_and_shadow(scenes):
    scene = scenes("cornell_box")
    cam = cgrt.Camera.default()
    out = debug_trace(scene, cam, [0.0, 0.0], cfg=CFG)
    assert len(out["levels"]) == CFG.max_depth
    lvl0 = out["levels"][0]
    assert lvl0["hit"][0]  # center ray hits the box interior
    assert np.isfinite(lvl0["t"][0])
    assert len(lvl0["shadowed_by_light"]) == 1
    # Normal is unit length at hits.
    assert np.isclose(np.linalg.norm(lvl0["normal"][0]), 1.0, atol=1e-4)


def test_hit_statistics_shapes(scenes):
    scene = scenes("cube")
    stats = hit_statistics(scene, cgrt.Camera.default(), CFG)
    assert stats["hit"].shape == (24, 24)
    assert stats["t"].shape == (24, 24)
    assert stats["hit"].any() and not stats["hit"].all()
    assert np.isfinite(stats["t"][stats["hit"]]).all()


def test_bvh_level_boxes(scenes):
    scene = scenes("monkey")
    bvh = build_bvh(scene)
    levels = bvh_num_levels(bvh)
    assert levels > 3
    lo0, hi0, leaf0 = bvh_level_boxes(bvh, 0)
    assert lo0.shape == (1, 3)  # root level
    lo2, hi2, _ = bvh_level_boxes(bvh, 2)
    assert lo2.shape[0] == 4  # complete binary levels until leaves appear
    # Child boxes at level 2 are inside the root box.
    assert (lo2 >= lo0[0] - 1e-5).all() and (hi2 <= hi0[0] + 1e-5).all()


def test_render_bvh_levels(scenes):
    # Headless equivalent of the reference's per-level debugDraw slider:
    # wireframe AABBs over the dimmed render, inner red / leaf green.
    from cg_raytracer.ops.bvh import build_bvh
    from cg_raytracer.utils.debug import render_bvh_levels

    scene = scenes("monkey")
    bvh = build_bvh(scene)
    cam = cgrt.Camera.default()
    img = render_bvh_levels(scene, cam, level=2, width=64, height=64, bvh=bvh)
    assert img.shape == (64, 64, 3)
    red = (img[..., 0] > 0.5) & (img[..., 1] < 0.3)
    assert red.sum() > 20  # inner-node wireframes present
    # Monkey's default tree bottoms out at level 8 (all leaves there).
    deep = render_bvh_levels(scene, cam, level=8, width=64, height=64, bvh=bvh)
    green = (deep[..., 1] > 0.5) & (deep[..., 0] < 0.3)
    assert green.sum() > 20  # leaves at the deep level
