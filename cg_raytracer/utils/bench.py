"""Benchmark harness.

Reference baseline: report.pdf Table 2 (BASELINE.md) — Cornell box point-light
800x800 in 168 ms => ~3.8 M primary rays/s on a 2020 CPU.  The north-star metric
(BASELINE.json) is primary rays/s per device for a *forward+backward* Cornell render at
1024^2; ``vs_baseline`` divides by the reference's forward-only 3.8e6.
"""
from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp

BASELINE_RAYS_PER_S = 3.8e6  # Cornell/point, report.pdf Table 2 (BASELINE.md)


def time_fn(fn, *args, iters: int = 5, warmup: int = 2):
    """Median steady-state wall time (median, not min: robust to one-off
    outliers in either direction)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def run_bench(scene: str = "cornell_box", width: int = 1024, height: int = 1024,
              backend: str = "auto", include_bwd: bool = True, iters: int = 5,
              max_depth: int = 2, data_dir: Optional[str] = None,
              frames_per_call: int = 8,
              cfg_overrides: Optional[dict] = None,
              include_vertex_params: bool = False) -> dict:
    """Steady-state throughput: ``frames_per_call`` frames (distinct PRNG keys)
    are computed inside ONE jitted call via ``lax.scan`` and the wall time is
    divided by the frame count, the way a render or train loop batches frames.
    The result names the device it ran on; the roofline share is reported
    only for a device in ``roofline.PEAKS``."""
    from .. import Camera, RenderConfig, load_scene
    from ..models.whitted import build_accel, make_backend, needs_bvh, render_image
    from ..optim.inverse import apply_material_params, material_params

    import dataclasses

    from ..models.whitted import effective_max_depth

    scn = load_scene(scene, data_dir=data_dir)
    cfg = RenderConfig(width=width, height=height, max_depth=max_depth,
                       backend=backend)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cfg = dataclasses.replace(cfg, max_depth=effective_max_depth(scn, cfg))
    camera = Camera.default(aspect=width / height)
    key = jax.random.PRNGKey(0)
    bvh = build_accel(scn, cfg) if needs_bvh(cfg, scn.num_triangles) else None

    keys = jax.random.split(key, frames_per_call)

    def jittered(cam_, key_):
        # Sub-pixel camera jitter per frame: keeps every scanned frame a real,
        # distinct render — otherwise point-light scenes ignore the PRNG key and
        # XLA could hoist the loop-invariant render out of the scan.
        import dataclasses as _dc

        eps = jax.random.uniform(key_, (3,), jnp.float32, -1e-4, 1e-4)
        return _dc.replace(cam_, look_at=cam_.look_at + eps)

    if include_bwd:
        params = material_params(scn)
        if include_vertex_params:
            # Full-gradient contract (round 4): vertices differentiate too —
            # the two-phase structure threads the reflected-ray chain, so
            # this exercises the complete vertex-grad path.
            params["vertices"] = scn.vertices
        if cfg.grad_two_phase == "auto":
            # Mirror optimize(): the two-phase gradient structure is exact
            # for every param set (phase 2 threads the reflected-ray chain
            # differentiably).
            cfg = dataclasses.replace(cfg, grad_two_phase="on")
        if cfg.two_phase_rays == "auto" and not include_vertex_params:
            # Material-only differentiation: recorded-rays fast path is
            # exact (the dropped vertex term is structurally zero).
            cfg = dataclasses.replace(cfg, two_phase_rays="recorded")

        def loss_fn(params_, scn_, cam_, key_):
            scn_p = apply_material_params(scn_, params_)
            if "vertices" in params_:
                scn_p = dataclasses.replace(scn_p, vertices=params_["vertices"])
            be = make_backend(scn_p, cfg, bvh=bvh)
            img = render_image(scn_p, cam_, cfg, backend=be, key=key_)
            return jnp.mean(img)

        @jax.jit
        def steps(params_, scn_, cam_, keys_):
            def one(carry, key_):
                loss, grads = jax.value_and_grad(loss_fn)(
                    params_, scn_, jittered(cam_, key_), key_)
                return carry + loss, grads

            total, grads = jax.lax.scan(one, jnp.float32(0.0), keys_)
            return total, grads

        best = time_fn(steps, params, scn, camera, keys, iters=iters)
        mode = "fwd+bwd"
    else:
        @jax.jit
        def frames(scn_, cam_, keys_):
            def one(carry, key_):
                be = make_backend(scn_, cfg, bvh=bvh)
                img = render_image(scn_, jittered(cam_, key_), cfg,
                                   backend=be, key=key_)
                return carry + jnp.mean(img), None

            return jax.lax.scan(one, jnp.float32(0.0), keys_)[0]

        best = time_fn(frames, scn, camera, keys, iters=iters)
        mode = "fwd"

    best = best / frames_per_call
    rays = width * height
    rays_per_s = rays / best
    dev = jax.devices()[0]
    result = {
        "metric": f"primary rays/s/device {mode} ({scene} {width}x{height}, "
                  f"{scn.num_triangles} tris)",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / BASELINE_RAYS_PER_S,
        "seconds_per_frame": best,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }

    # Roofline fraction: only the brute-sweep path has an exact closed-form
    # work count; BVH scenes need measured traversal stats.  Scenes with
    # spheres route their sphere tail through jnp — the brute model would
    # undercount; skip rather than report a wrong ceiling.
    from .roofline import PEAKS, device_peaks, headline_roofline, pct_of_roofline

    if (cfg.resolve_backend(scn.num_triangles) == "brute"
            and scn.spheres.radius.shape[0] == 0
            and dev.device_kind in PEAKS):
        peaks = device_peaks(dev.device_kind)
        info = headline_roofline(
            width, height, scn.num_triangles,
            scn.point_lights.position.shape[0], cfg.max_depth,
            include_bwd=include_bwd, peaks=peaks)
        result["pct_of_roofline"] = pct_of_roofline(
            best, info["gflops_per_frame"] * 1e9, info["mbytes_per_frame"] * 1e6,
            peaks)
        result["roofline"] = info
    return result
