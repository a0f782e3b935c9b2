#!/usr/bin/env python
"""Render the reference's performance-table scenes (report.pdf §9 Table 2).

Same conditions as the reference: 800x800, Whitted depth 2, point/spherical lights
per scene preset; soft shadows use the reference's 200 samples.  Prints one JSON
line per scene with the wall-clock, the device it ran on (platform, kind, count)
and the reference's CPU time (BASELINE.md) for context.  The Dragon/Teacup/Donut
rows use procedural stand-ins at the reported triangle counts (their data files
were stripped from / never committed to the reference repo).  Run it on the GPU
in one process; on a CPU the times say nothing about the card.
"""
import argparse
import json
import time

import jax

REFERENCE_MS = {
    "cornell_box": 168.0,
    "cornell_box_spherical_light": 48_500.0,
    "monkey": 500.0,
    "dragon": 500.0,
    "teacup": 430.0,
    "donut": 6_500.0,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-bwd", action="store_true",
                    help="skip the fwd+bwd column (faster)")
    args = ap.parse_args()

    from cg_raytracer.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import cg_raytracer as cgrt

    cam = cgrt.Camera.default()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    for name, ref_ms in REFERENCE_MS.items():
        scene = cgrt.load_scene(name)
        cfg = cgrt.RenderConfig(width=800, height=800)
        img = cgrt.render(scene, cam, cfg)
        jax.block_until_ready(img)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = cgrt.render(scene, cam, cfg)
            jax.block_until_ready(img)
            ts.append(time.perf_counter() - t0)
        ms = sorted(ts)[len(ts) // 2] * 1e3
        rec = {"scene": name, "tris": scene.num_triangles, "ms": round(ms, 2),
               "reference_ms": ref_ms, "device": device}

        # Steady-state per-frame time: 8 frames scanned inside one dispatch.
        from cg_raytracer.utils.bench import run_bench

        steady = run_bench(scene=name, width=800, height=800,
                           include_bwd=False, iters=3)
        rec["ms_steady"] = round(steady["seconds_per_frame"] * 1e3, 2)

        # fwd+bwd steady: the headline metric is a backward pass, so every
        # Table-2 scene gets a gradient row.
        if not args.no_bwd:
            kw = (dict(iters=2, frames_per_call=2)
                  if "spherical" in name else dict(iters=3, frames_per_call=4))
            bwd = run_bench(scene=name, width=800, height=800,
                            include_bwd=True, **kw)
            rec["ms_fwd_bwd"] = round(bwd["seconds_per_frame"] * 1e3, 2)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
