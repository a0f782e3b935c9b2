"""Golden-image case definitions shared by the regression test and the regen
script (tests/golden/regen.py).

Each case pins a FULL [H, W, 3] float32 render — any bug that redistributes
energy (wrong shadow edge, flipped normal region, swapped walls) fails the
per-pixel diff, unlike the round-1 scalar mean-brightness pins (VERDICT r1).

Backends are pinned explicitly (never 'auto') so goldens don't shift when
auto-routing thresholds move.  The spherical-light case pins the PRNG key and
sample/chunk counts: the sample stream is a pure function of (key, chunk
structure), so it is bitwise reproducible on CPU.
"""
from __future__ import annotations

import cg_raytracer as cgrt

GOLDEN_NPZ = "images.npz"  # under tests/golden/
GOLDEN_PNG_800 = "cornell_box_800.png"  # u8-quantized 800x800 cornell render


def golden_cases():
    """name -> (scene_name, RenderConfig).  Deterministic on CPU, key=0."""
    C = cgrt.RenderConfig
    d = dict(width=64, height=64, backend="brute")
    big = dict(width=48, height=48, backend="bvh")
    return {
        "single_triangle": ("single_triangle", C(**d)),
        "cube": ("cube", C(**d)),
        "cornell_box": ("cornell_box", C(**d)),
        "cornell_box_quirks": ("cornell_box", C(reference_quirks=True, **d)),
        "cornell_box_aa_bloom": ("cornell_box",
                                 C(anti_aliasing=True, bloom=True, **d)),
        "cornell_box_aa_bloom_quirks": ("cornell_box",
                                        C(anti_aliasing=True, bloom=True,
                                          reference_quirks=True, **d)),
        "cornell_box_motion_blur": ("cornell_box",
                                    C(width=32, height=32, backend="brute",
                                      motion_blur=True)),
        "cornell_box_spherical_light": ("cornell_box_spherical_light",
                                        C(soft_shadow_samples=16,
                                          soft_shadow_chunk=8, **d)),
        "monkey": ("monkey", C(**d)),
        "spheres": ("spheres", C(**d)),
        "dragon": ("dragon", C(**big)),
        "teacup": ("teacup", C(**big)),
        "donut": ("donut", C(**big)),
    }


def cornell_800_cfg():
    return cgrt.RenderConfig(width=800, height=800, backend="brute")
