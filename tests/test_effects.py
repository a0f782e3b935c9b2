"""Effects tests: AA, bloom, motion blur (main.cpp:318-720 capabilities)."""
import dataclasses

import numpy as np
import jax.numpy as jnp

import cg_raytracer as cgrt
from cg_raytracer.ops.effects import bloom, _box_blur_1d

CFG = cgrt.RenderConfig(width=48, height=48)


def _render(scene, cfg):
    return np.asarray(cgrt.render(scene, cgrt.Camera.default(), cfg))


def test_aa_smooths_edges(scenes):
    scene = scenes("cube")
    plain = _render(scene, CFG)
    aa = _render(scene, dataclasses.replace(CFG, anti_aliasing=True))
    assert aa.shape == plain.shape
    # AA must produce intermediate values on silhouette edges: count pixels that are
    # neither background-black nor fully interior.
    def edges(img):
        v = img.sum(axis=-1)
        return ((v > 1e-4) & (v < 0.9 * v.max())).sum()

    assert not np.allclose(aa, plain)
    # Default divisor 4 keeps overall brightness comparable (not /5-darkened).
    assert abs(aa.mean() - plain.mean()) < 0.25 * max(plain.mean(), 1e-6)


def test_aa_reference_quirk_divisor(scenes):
    # Quirk mode divides the 4-sample sum by 5 (main.cpp:685) -> exactly 4/5 of the
    # default-mode image.
    scene = scenes("cube")
    aa = _render(scene, dataclasses.replace(CFG, anti_aliasing=True))
    aq = _render(scene, dataclasses.replace(CFG, anti_aliasing=True,
                                            reference_quirks=True))
    np.testing.assert_allclose(aq, aa * 0.8, atol=1e-5)


def test_bloom_threshold_and_blur():
    # Synthetic image: one bright pixel above threshold (sum > 1), rest dim.
    img = jnp.zeros((48, 48, 3), jnp.float32).at[24, 24].set(jnp.asarray([2.0, 2.0, 2.0]))
    out = np.asarray(bloom(img, CFG))
    # Energy added around the bright pixel within the 21x21 window.
    assert out[24, 30].sum() > 0  # inside radius 10
    assert out[24, 40].sum() == 0  # outside radius
    # Dim pixels below threshold contribute nothing.
    img2 = jnp.full((48, 48, 3), 0.2, jnp.float32)  # sum 0.6 < 1
    out2 = np.asarray(bloom(img2, CFG))
    np.testing.assert_allclose(out2, np.asarray(img2), atol=1e-6)


def test_box_blur_normalization():
    # Edge-clipped normalization: blurring a constant image is the identity.
    img = jnp.full((32, 32, 3), 0.7, jnp.float32)
    out = np.asarray(_box_blur_1d(_box_blur_1d(img, 10, axis=0), 10, axis=1))
    np.testing.assert_allclose(out, 0.7, atol=1e-5)


def test_motion_blur_smears(scenes):
    scene = scenes("cube")
    cfg = dataclasses.replace(CFG, width=32, height=32)
    plain = _render(scene, cfg)
    blurred = _render(scene, dataclasses.replace(cfg, motion_blur=True))
    assert blurred.shape == plain.shape
    assert not np.allclose(blurred, plain)
    # Averaging jittered renders cannot exceed the per-frame max by much.
    assert blurred.max() <= plain.max() + 0.3


def _bloom_quirk_numpy(img):
    """Direct transcription of bloomEffect (main.cpp:586-628) in numpy: raster
    scan, in-place window accumulation, counter normalization, add-back."""
    h, w, _ = img.shape
    b = np.where(img.sum(-1, keepdims=True) > 1.0, img, 0.0).astype(np.float64)
    for y in range(h):
        for x in range(w):
            counter = 1
            acc = b[y, x].copy()
            for i in range(-10, 11):
                if y + i < 0 or y + i > h - 1:
                    continue
                for j in range(-10, 11):
                    if i == 0 and j == 0:
                        continue
                    if x + j < 0 or x + j > w - 1:
                        continue
                    acc += b[y + i, x + j]
                    counter += 1
            b[y, x] = acc / counter
    return img + b.astype(np.float32)


def test_bloom_quirk_matches_reference_transcription():
    rng = np.random.default_rng(0)
    img = rng.uniform(0.0, 0.8, (24, 24, 3)).astype(np.float32)
    img[5, 7] = [1.5, 1.2, 0.3]   # above threshold
    img[18, 3] = [0.6, 0.6, 0.6]  # above threshold (sum 1.8)
    want = _bloom_quirk_numpy(img)
    from cg_raytracer.ops.effects import _bloom_quirk

    got = np.asarray(_bloom_quirk(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bloom_quirk_aa_matches_reference_transcription():
    """AA+bloom quirk path (main.cpp:663-705): threshold on the running
    4-subsample sum, bright value = LAST (x+.5, y+.5) subsample, final pixel =
    in-place blur + un-antialiased center render (replacing the AA average)."""
    from cg_raytracer.ops.effects import bloom_quirk_aa

    rng = np.random.default_rng(2)
    subs = {off: rng.uniform(0.0, 0.5, (20, 20, 3)).astype(np.float32)
            for off in [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5)]}
    subs[(0.5, 0.5)][4, 6] = [0.9, 0.9, 0.9]  # pushes the 4-sum over 1 there

    # numpy transcription of the reference loop
    total = sum(subs.values())
    bright = np.where(total.sum(-1, keepdims=True) > 1.0, subs[(0.5, 0.5)], 0.0)
    b = bright.astype(np.float64)
    h, w, _ = b.shape
    for y in range(h):
        for x in range(w):
            counter = 1
            acc = b[y, x].copy()
            for i in range(-10, 11):
                if y + i < 0 or y + i > h - 1:
                    continue
                for j in range(-10, 11):
                    if i == 0 and j == 0:
                        continue
                    if x + j < 0 or x + j > w - 1:
                        continue
                    acc += b[y + i, x + j]
                    counter += 1
            b[y, x] = acc / counter
    want = subs[(0.0, 0.0)] + b.astype(np.float32)

    got = np.asarray(bloom_quirk_aa(lambda off: jnp.asarray(subs[off]), CFG))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bloom_quirk_aa_through_render(scenes):
    # End-to-end: quirks + AA + bloom renders finite, and the base is the
    # UN-antialiased render (the reference's final setPixel replaces the AA
    # average) — so pixels far from any bloom energy match the no-AA render.
    scene = scenes("spheres")
    cfg = dataclasses.replace(CFG, width=24, height=24, reference_quirks=True,
                              anti_aliasing=True, bloom=True)
    out = _render(scene, cfg)
    assert np.isfinite(out).all()
    plain = _render(scene, dataclasses.replace(cfg, anti_aliasing=False,
                                               bloom=False))
    assert (out - plain).min() >= -1e-5  # bloom only adds energy


def test_bloom_quirk_differs_from_clean_filter():
    # The in-place accumulation smears energy toward later scan positions; on a
    # bright-pixel image the quirk and clean outputs must differ.
    img = jnp.zeros((32, 32, 3), jnp.float32).at[10, 10].set(
        jnp.asarray([2.0, 2.0, 2.0]))
    clean = np.asarray(bloom(img, CFG))
    quirk = np.asarray(bloom(img, dataclasses.replace(CFG, reference_quirks=True)))
    assert not np.allclose(clean, quirk, atol=1e-6)


def test_bloom_quirk_through_render(scenes):
    # End-to-end: quirks render with bloom stays finite and adds energy over
    # the no-bloom quirks render wherever anything crossed the threshold.
    scene = scenes("spheres")  # light color 15 -> saturated pixels
    cfg = dataclasses.replace(CFG, width=24, height=24, reference_quirks=True)
    base = _render(scene, cfg)
    bloomed = _render(scene, dataclasses.replace(cfg, bloom=True))
    assert np.isfinite(bloomed).all()
    assert (bloomed - base).min() >= -1e-5
    assert (bloomed - base).max() > 1e-4


def test_motion_blur_relative_to_camera(scenes):
    # Default mode jitters relative to the user's look_at; the render through a
    # non-default camera must stay in the same neighborhood (NOT teleport to
    # the absolute origin path, which is quirks-only, main.cpp:344-568).
    scene = scenes("cube")
    cfg = dataclasses.replace(CFG, width=24, height=24)
    cam = cgrt.Camera.default(look_at=(0.3, 0.1, 0.0), dist=2.0)
    plain = np.asarray(cgrt.render(scene, cam, cfg))
    blurred = np.asarray(cgrt.render(scene, cam,
                                     dataclasses.replace(cfg, motion_blur=True)))
    quirk = np.asarray(cgrt.render(
        scene, cam, dataclasses.replace(cfg, motion_blur=True,
                                        reference_quirks=True)))
    # Relative jitter keeps most of the image: strong correlation with plain.
    overlap = np.minimum(blurred.sum(-1) > 1e-4, plain.sum(-1) > 1e-4).mean()
    both = (plain.sum(-1) > 1e-4).mean()
    assert overlap > 0.5 * both
    # The absolute-origin quirk path sees a different framing entirely.
    assert not np.allclose(blurred, quirk, atol=1e-4)


def test_motion_blur_reference_quirk(scenes):
    # Quirk mode: 15 jittered renders / 16 (base omitted) -> strictly darker in
    # expectation than the default 16/16 average.
    scene = scenes("cube")
    cfg = dataclasses.replace(CFG, width=24, height=24)
    default = _render(scene, dataclasses.replace(cfg, motion_blur=True))
    quirk = _render(scene, dataclasses.replace(cfg, motion_blur=True,
                                               reference_quirks=True))
    assert quirk.mean() < default.mean()
