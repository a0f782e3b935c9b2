#!/usr/bin/env python
"""Scaling-efficiency sweep over an n-device mesh.

On a machine with several GPUs this measures rays/s scaling with the device
count.  Without them, run with
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8``
to validate the sharded path end-to-end (virtual devices share one socket, so the
efficiency number is only meaningful on real hardware).

Usage: python scripts/scaling_bench.py [--scene dragon] [--size 2048] [--devices 1 2 4 8]
"""
import argparse
import json
import time

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell_box")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    from cg_raytracer.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import cg_raytracer as cgrt
    from cg_raytracer.parallel.sharding import make_mesh, sharded_render
    from cg_raytracer.utils.profiling import scaling_efficiency

    avail = len(jax.devices())
    counts = args.devices or [n for n in (1, 2, 4, 8, 16, 32) if n <= avail]
    scene = cgrt.load_scene(args.scene)
    cfg = cgrt.RenderConfig(width=args.size, height=args.size)
    cam = cgrt.Camera.default()
    rays = args.size * args.size

    base = None
    for n in counts:
        mesh = make_mesh(n)
        img = sharded_render(scene, cam, cfg, mesh)
        jax.block_until_ready(img)
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            img = sharded_render(scene, cam, cfg, mesh)
            jax.block_until_ready(img)
            ts.append(time.perf_counter() - t0)
        rps = rays / sorted(ts)[len(ts) // 2]
        if base is None:
            base = rps
        dev = jax.devices()[0]
        print(json.dumps({
            "device": {"platform": dev.platform, "kind": dev.device_kind},
            "devices": n,
            "rays_per_s": rps,
            "rays_per_s_per_device": rps / n,
            "scaling_efficiency": scaling_efficiency(rps, base, n),
        }))


if __name__ == "__main__":
    main()
