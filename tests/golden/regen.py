"""Regenerate the full-image goldens (tests/golden/images.npz + the 800x800
u8 PNG pin).

Run on CPU:
  JAX_PLATFORMS=cpu python tests/golden/regen.py

Only rerun when shading semantics intentionally change; commit the regenerated
files together with the change that moved them and say why in the commit.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import cg_raytracer as cgrt  # noqa: E402
from tests.golden_cases import (GOLDEN_NPZ, GOLDEN_PNG_800, cornell_800_cfg,
                                golden_cases)  # noqa: E402


def main():
    out_dir = os.path.dirname(os.path.abspath(__file__))
    cam = cgrt.Camera.default()
    arrays = {}
    scenes = {}
    for name, (scene_name, cfg) in golden_cases().items():
        if scene_name not in scenes:
            scenes[scene_name] = cgrt.load_scene(scene_name)
        img = np.asarray(cgrt.render(scenes[scene_name], cam, cfg), np.float32)
        arrays[name] = img
        print(f"{name}: {img.shape} mean {img.mean():.6f}")
    np.savez_compressed(os.path.join(out_dir, GOLDEN_NPZ), **arrays)

    from cg_raytracer.utils.image import write_png

    img800 = np.asarray(
        cgrt.render(scenes.get("cornell_box") or cgrt.load_scene("cornell_box"),
                    cam, cornell_800_cfg()))
    write_png(os.path.join(out_dir, GOLDEN_PNG_800), img800)
    print(f"cornell 800x800: mean {img800.mean():.6f}")


if __name__ == "__main__":
    main()
