"""Roofline model sanity (utils/roofline.py).

Its work counts must track the oracles' actual structure, its ideal times must
be physically sensible bounds, and its peaks must be the published ones.
"""
import pytest

from cg_raytracer import Camera, load_scene
from cg_raytracer.ops.bvh import build_bvh
from cg_raytracer.ops.camera import generate_rays
from cg_raytracer.utils import roofline as rl

H100 = rl.device_peaks("NVIDIA H100 80GB HBM3")


def test_chip_model_matches_public_specs():
    # NVIDIA's H100 SXM data sheet, dense rates.
    assert H100.f32_flops == pytest.approx(67e12)
    assert H100.bf16_tensor_flops == pytest.approx(989e12)
    assert H100.hbm_bytes_per_s == pytest.approx(3.35e12)
    assert "data sheet" in H100.source


def test_unknown_device_kind_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        rl.device_peaks("cpu")


def test_brute_flops_scale_with_work():
    base = rl.brute_flops_per_ray(32, 1, 2)
    assert base > 2 * 32 * rl.MT_FLOPS  # at least the two closest sweeps
    # Doubling triangles roughly doubles the sweep-dominated count.
    assert rl.brute_flops_per_ray(64, 1, 2) > 1.8 * base
    # Backward adds the jnp VJP replay but not oracle work.
    bwd = rl.brute_flops_per_ray(32, 1, 2, include_bwd=True)
    assert base < bwd < base + 3 * 2 * (
        rl.RECON_FLOPS + rl.SHADE_FLOPS + rl.BOUNCE_MISC_FLOPS)


def test_headline_roofline_is_a_bound():
    # cornell_box headline config: 1024^2, 32 tris, 1 light, 2 bounces, fwd+bwd.
    info = rl.headline_roofline(1024, 1024, 32, 1, 2, include_bwd=True,
                                peaks=H100)
    assert info["bound"] in ("compute (float32)", "memory (HBM)")
    assert info["peaks"] == H100.name
    # The sweep work alone is ~9 GFLOP, so the ideal frame is >0.1 ms on a
    # 67 TFLOP/s part and far below a second.
    assert info["gflops_per_frame"] > 5.0
    assert 1e-4 < info["ideal_seconds"] < 1.0


def test_pct_of_roofline_direction():
    flops, byts = 1e9, 1e6
    ideal, _ = rl.roofline_seconds(flops, byts, H100)
    assert rl.pct_of_roofline(2 * ideal, flops, byts, H100) == pytest.approx(50.0)


def test_bvh_visit_stats_counts_real_traversals():
    scene = load_scene("monkey")
    bvh = build_bvh(scene)
    cam = Camera.default(aspect=1.0)
    origins, dirs = generate_rays(cam, 32, 32)
    stats = rl.bvh_visit_stats(bvh, origins, dirs)
    # Every primary ray at least tests the root's children.
    assert stats["mean_internal_visits"] >= 1.0
    assert stats["max_internal_visits"] >= stats["mean_internal_visits"]
    # Rays that hit the monkey must test at least one triangle.
    assert stats["mean_tri_tests"] > 0.1
    # Far fewer nodes than the whole tree (log-ish traversal, not a sweep).
    assert stats["max_internal_visits"] < bvh.left.shape[0]


def test_bvh_flops_use_measured_stats():
    f = rl.bvh_flops_per_ray(internal_visits=20.0, tri_tests=12.0,
                             num_lights=1, bounces=1)
    assert f > 20 * rl.INTERNAL_VISIT_FLOPS
    assert f > 12 * rl.MT_FLOPS
    # More traversal work => more flops, monotonic.
    assert rl.bvh_flops_per_ray(40.0, 24.0, 1, 1) > 1.5 * f
