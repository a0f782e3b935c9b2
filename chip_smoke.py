#!/usr/bin/env python
"""Smoke test of the renderer on one NVIDIA GPU (or, with --multi, four).

    python chip_smoke.py           # phases (a)-(g) on one GPU
    python chip_smoke.py --multi   # phase (h) only: the 4-GPU paths

One process drives every card.  Each phase prints a line when it starts; any
failure raises, so the script exits non-zero and prints no result.  The last
line of standard output is one JSON object naming the device JAX ran on.

Phases:
  (a) device check: JAX's default backend is a GPU; the card's name and power
      limit from nvidia-smi, read by a child process that stays off JAX.
  (b) forward renders at 800^2 through cgrt.render with backend='auto'.
  (c) oracle check: the chosen backend and the CUDA traversal kernel against
      the brute-force reference on a 64K-ray sample per scene.
  (d) image check: the cornell 800^2 GPU image against a CPU render.
  (e) gradient check: fwd+bwd over materials, lights and vertices at 1024^2
      (cornell) and 800^2 (teacup); GPU against CPU gradients at 128^2, and a
      finite difference on kd.
  (f) inverse rendering: three optimize() steps on monkey at 512^2.
  (g) timings: CUDA kernel against the jnp while-loop traversal (closest and
      occluded, then render fwd and fwd+bwd) on dragon, teacup and donut at
      800^2, and the one-hot against the row gather on cornell.
  (t) the repository's tests marked ``gpu``.
  (h) --multi: ray-sharded render and train step, the 2x2 ('rays',
      'samples') mesh, and the geometry-sharded render over 4 GPUs, each
      against the single-GPU result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import cg_raytracer as cgrt
from cg_raytracer.models.whitted import (build_accel, effective_max_depth,
                                         make_backend, render_image)
from cg_raytracer.ops import camera as cam_ops
from cg_raytracer.ops import intersect as isect
from cg_raytracer.ops.bvh import build_bvh
from cg_raytracer.optim.inverse import apply_material_params, material_params
from cg_raytracer.utils.bench import time_fn
from cg_raytracer.utils.cache import enable_compilation_cache

REPO = os.path.dirname(os.path.abspath(__file__))
LIGHT = jnp.asarray([-1.0, 1.0, -1.0], jnp.float32)
CARD = ""  # nvidia-smi name and power limit, set in phase (a)


@contextlib.contextmanager
def phase(title):
    print(f"== {title}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"   done in {time.perf_counter() - t0:.1f} s", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cpu_device():
    return jax.devices("cpu")[0]


def on_cpu(tree):
    return jax.device_put(tree, cpu_device())


def grad_params(scene):
    params = material_params(scene)
    params["vertices"] = scene.vertices
    return params


def apply_grad_params(scene, params):
    scene = apply_material_params(scene, params)
    return dataclasses.replace(scene, vertices=params["vertices"])


def loss_fn(scene, cfg, bvh, camera, key):
    """Mean image over the full parameter set (materials, lights, vertices)."""

    def loss(params):
        s = apply_grad_params(scene, params)
        img = render_image(s, camera, cfg, backend=make_backend(s, cfg, bvh),
                           key=key)
        return jnp.mean(img)

    return loss


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def sample_rays(scene, n_side=800, keep=64 * 1024, seed=0):
    """64K primary rays sampled from the 800^2 grid, plus shadow rays from
    their closest hits (brute force) towards the light."""
    o, d = cam_ops.generate_rays(cgrt.Camera.default(), n_side, n_side)
    idx = np.random.default_rng(seed).choice(o.shape[0], keep, replace=False)
    o, d = o[idx], d[idx]
    hit = jax.jit(lambda o_, d_: isect.intersect_brute(scene, o_, d_))(o, d)
    ok = jnp.isfinite(hit.t)
    pos = o + d * jnp.where(ok, hit.t, 0.0)[:, None]
    to_light = LIGHT - pos
    dist = jnp.linalg.norm(to_light, axis=-1)
    sdir = to_light / dist[:, None]
    return o, d, pos + 1e-3 * sdir, sdir, dist - 1e-3, hit


# ---------------------------------------------------------------------------


def phase_a():
    global CARD
    with phase("(a) device check"):
        dev = jax.devices()[0]
        check(dev.platform == "gpu",
              f"JAX's default device is {dev.platform!r}, not a GPU")
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
        check(lines, "nvidia-smi listed no GPU")
        CARD = lines[0]
        for ln in lines:
            print(ln, flush=True)
        print(f"   jax: {jax.__version__}, {len(jax.devices())} x "
              f"{dev.device_kind}", flush=True)


def phase_b(scenes):
    with phase("(b) forward renders, 800^2, backend='auto'"):
        cam = cgrt.Camera.default()
        for name in ("cornell_box", "cornell_box_spherical_light", "monkey",
                     "donut"):
            scene = scenes[name]
            cfg = cgrt.RenderConfig(width=800, height=800)
            kind = cfg.resolve_backend(scene.num_triangles)
            t0 = time.perf_counter()
            img = jax.block_until_ready(cgrt.render(scene, cam, cfg))
            first = time.perf_counter() - t0
            steady = time_fn(lambda: cgrt.render(scene, cam, cfg), iters=3,
                             warmup=0)
            arr = np.asarray(img)
            check(arr.shape == (800, 800, 3), f"{name}: shape {arr.shape}")
            check(np.isfinite(arr).all(), f"{name}: non-finite pixels")
            check(arr.max() > 0.05, f"{name}: image is black")
            print(f"   {name}: {scene.num_triangles} tris, backend {kind}, "
                  f"first call {first:.2f} s, steady {steady * 1e3:.2f} ms, "
                  f"mean {arr.mean():.5f}  [{CARD}]", flush=True)
        scene = scenes["donut"]
        cfg = cgrt.RenderConfig(width=800, height=800)
        bvh = build_accel(scene, cfg)
        fn = jax.jit(lambda s, b, k: render_image(
            s, cam, cfg, backend=make_backend(s, cfg, b), key=k))
        mem = fn.lower(scene, bvh, jax.random.PRNGKey(0)).compile().memory_analysis()
        print(f"   donut 800^2 fwd memory_analysis: {mem}", flush=True)


def phase_c(scenes):
    with phase("(c) oracle check against brute force, 64K rays per scene"):
        for name in ("cornell_box", "monkey", "teacup", "donut"):
            scene = scenes[name]
            o, d, so, sd, tmax, ref = sample_rays(scene)
            ref_occ = jax.jit(lambda a, b, c: isect.occluded_brute(
                scene, a, b, c))(so, sd, tmax)
            auto = cgrt.RenderConfig().resolve_backend(scene.num_triangles)
            bvh = build_bvh(scene)
            for kind in sorted({auto, "cuda"}):
                be = make_backend(scene, cgrt.RenderConfig(backend=kind), bvh)
                hit = jax.jit(be.closest)(o, d)
                occ = jax.jit(be.occluded)(so, sd, tmax)
                pid, rid = np.asarray(hit.prim_id), np.asarray(ref.prim_id)
                same = pid == rid
                tk, tr = np.asarray(hit.t)[same], np.asarray(ref.t)[same]
                fin = np.isfinite(tr)
                check((np.isfinite(tk) == fin).all(),
                      f"{name}/{kind}: hit/miss disagree on equal prim ids")
                t_rel = (float(np.max(np.abs(tk[fin] - tr[fin])
                                      / np.maximum(np.abs(tr[fin]), 1e-30)))
                         if fin.any() else 0.0)
                occ_agree = float((np.asarray(occ) == np.asarray(ref_occ)).mean())
                print(f"   {name} [{kind}]: prim_id agree {same.mean():.5f}, "
                      f"max t rel diff {t_rel:.2e}, any-hit agree "
                      f"{occ_agree:.5f}, hits {(rid >= 0).mean():.3f}, "
                      f"blocked {np.asarray(ref_occ).mean():.3f}", flush=True)
                check(same.mean() >= 0.995, f"{name}/{kind}: prim_id agreement")
                check(t_rel <= 1e-5, f"{name}/{kind}: t differs by {t_rel}")
                check(occ_agree >= 0.995, f"{name}/{kind}: any-hit agreement")


def phase_d(scenes):
    with phase("(d) cornell 800^2: GPU image against a CPU render"):
        scene = scenes["cornell_box"]
        cam = cgrt.Camera.default()
        cfg = cgrt.RenderConfig(width=800, height=800)
        gpu_img = np.asarray(cgrt.render(scene, cam, cfg))
        with jax.default_device(cpu_device()):
            cpu_img = np.asarray(cgrt.render(
                on_cpu(scene), on_cpu(cam), dataclasses.replace(cfg, backend="brute")))
        bad = (np.abs(gpu_img - cpu_img).max(axis=-1) > 1e-4).mean()
        print(f"   pixels beyond 1e-4: {bad:.5f} (limit 0.005), max diff "
              f"{np.abs(gpu_img - cpu_img).max():.2e}", flush=True)
        check(bad <= 0.005, f"GPU/CPU image mismatch on {bad:.4%} of pixels")


def phase_e(scenes):
    with phase("(e) gradients over materials, lights and vertices"):
        key = jax.random.PRNGKey(0)
        for name, size in (("cornell_box", 1024), ("teacup", 800)):
            scene = scenes[name]
            cam = cgrt.Camera.default()
            cfg = cgrt.RenderConfig(width=size, height=size,
                                    grad_two_phase="on")
            bvh = build_accel(scene, cfg)
            fn = jax.jit(jax.value_and_grad(loss_fn(scene, cfg, bvh, cam, key)))
            params = grad_params(scene)
            t0 = time.perf_counter()
            loss, grads = jax.block_until_ready(fn(params))
            first = time.perf_counter() - t0
            steady = time_fn(fn, params, iters=3, warmup=0)
            check(np.isfinite(float(loss)), f"{name}: loss {loss}")
            for k, g in grads.items():
                check(np.isfinite(np.asarray(g)).all(), f"{name}: grad {k}")
            print(f"   {name} {size}^2 fwd+bwd ({cfg.resolve_backend(scene.num_triangles)}): "
                  f"first call {first:.2f} s, steady {steady * 1e3:.2f} ms  "
                  f"[{CARD}]", flush=True)

            # GPU against CPU at 128^2; the CPU takes the jnp traversal.
            small = dataclasses.replace(cfg, width=128, height=128)
            g_gpu = jax.jit(jax.grad(loss_fn(scene, small, bvh, cam, key)))(params)
            with jax.default_device(cpu_device()):
                cfg_cpu = dataclasses.replace(small, backend="bvh" if bvh is not None
                                              else "brute")
                bvh_cpu = on_cpu(bvh) if bvh is not None else None
                g_cpu = jax.jit(jax.grad(loss_fn(
                    on_cpu(scene), cfg_cpu, bvh_cpu, on_cpu(cam), on_cpu(key))))(
                    on_cpu(params))
            for k in params:
                err = rel_err(g_gpu[k], g_cpu[k])
                print(f"   {name} 128^2 grad {k}: GPU vs CPU rel err {err:.2e}",
                      flush=True)
                check(err <= 1e-3, f"{name}: grad {k} GPU vs CPU {err}")

        # Finite difference on one kd entry (cornell, 128^2, sum of image).
        scene = scenes["cornell_box"]
        cam = cgrt.Camera.default()
        cfg = cgrt.RenderConfig(width=128, height=128)

        def total(kd):
            s = dataclasses.replace(scene, materials=dataclasses.replace(
                scene.materials, kd=kd))
            return jnp.sum(render_image(s, cam, cfg, key=key))

        kd = scene.materials.kd
        g = np.asarray(jax.jit(jax.grad(total))(kd))
        i, c = np.unravel_index(np.argmax(np.abs(g)), g.shape)
        eps = 1e-2
        f = jax.jit(total)
        fd = (float(f(kd.at[i, c].add(eps))) - float(f(kd.at[i, c].add(-eps)))) / (2 * eps)
        err = abs(fd - g[i, c]) / max(abs(fd), 1e-12)
        print(f"   kd[{i},{c}]: analytic {g[i, c]:.5f}, finite difference "
              f"{fd:.5f}, rel err {err:.2e}", flush=True)
        check(err <= 1e-2, f"finite-difference check on kd: {err}")


def phase_f(scenes):
    with phase("(f) inverse rendering: 3 optimize() steps, monkey 512^2"):
        from cg_raytracer.optim.inverse import optimize

        scene = scenes["monkey"]
        cam = cgrt.Camera.default()
        cfg = cgrt.RenderConfig(width=512, height=512)
        target = cgrt.render(scene, cam, cfg)
        start = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, kd=scene.materials.kd * 0.5))
        _, losses = optimize(start, cam, target, cfg, steps=3,
                             learning_rate=0.05, log_every=0)
        print(f"   losses: {losses}", flush=True)
        check(all(np.isfinite(losses)), "non-finite loss")
        check(losses[-1] < losses[0], "loss did not fall")


def phase_g(scenes):
    with phase(f"(g) timings, median of 5 [{CARD}]"):
        cam = cgrt.Camera.default()
        key = jax.random.PRNGKey(0)
        for name in ("dragon", "teacup", "donut"):
            scene = scenes[name]
            bvh = build_bvh(scene)
            o, d = cam_ops.generate_rays(cam, 800, 800)
            be_k = make_backend(scene, cgrt.RenderConfig(backend="cuda"), bvh)
            be_j = make_backend(scene, cgrt.RenderConfig(backend="bvh"), bvh)
            hit = jax.jit(be_k.closest)(o, d)
            ok = jnp.isfinite(hit.t)
            pos = o + d * jnp.where(ok, hit.t, 0.0)[:, None]
            to_light = LIGHT - pos
            dist = jnp.linalg.norm(to_light, axis=-1)
            sd = to_light / dist[:, None]
            so, tm = pos + 1e-3 * sd, dist - 1e-3
            row = {}
            for label, be in (("cuda", be_k), ("jnp", be_j)):
                row[f"closest_{label}"] = time_fn(jax.jit(be.closest), o, d)
                row[f"occluded_{label}"] = time_fn(jax.jit(be.occluded), so, sd, tm)
            for label, kind in (("cuda", "cuda"), ("jnp", "bvh")):
                cfg = cgrt.RenderConfig(width=800, height=800, backend=kind)
                # The bounce count render() would use (dead levels skipped).
                cfg = dataclasses.replace(
                    cfg, max_depth=effective_max_depth(scene, cfg))
                fwd = jax.jit(lambda s, c=cfg: render_image(
                    s, cam, c, backend=make_backend(s, c, bvh), key=key))
                row[f"render_fwd_{label}"] = time_fn(fwd, scene)
                cfg2 = dataclasses.replace(cfg, grad_two_phase="on")
                fb = jax.jit(jax.value_and_grad(loss_fn(scene, cfg2, bvh, cam, key)))
                row[f"render_fwd_bwd_{label}"] = time_fn(fb, grad_params(scene))
            print(f"   {name} ({scene.num_triangles} tris, 800^2) ms: " + ", ".join(
                f"{k} {v * 1e3:.3f}" for k, v in row.items()), flush=True)
            print("   TIMING " + json.dumps({"scene": name, "card": CARD, **{
                k: round(v * 1e3, 4) for k, v in row.items()}}), flush=True)

        # Gather A/B on cornell (32 triangles): one-hot matmul vs row gather.
        scene = scenes["cornell_box"]
        cfg = cgrt.RenderConfig(width=1024, height=1024, grad_two_phase="on")
        saved = isect.ONEHOT_GATHER_MAX_TRIS
        row = {}
        try:
            for label, cap in (("onehot", 128), ("rows", 0), ("onehot2", 128),
                               ("rows2", 0)):
                isect.ONEHOT_GATHER_MAX_TRIS = cap
                fb = jax.jit(jax.value_and_grad(loss_fn(scene, cfg, None, cam, key)))
                row[label] = time_fn(fb, grad_params(scene))
        finally:
            isect.ONEHOT_GATHER_MAX_TRIS = saved
        print("   cornell 1024^2 fwd+bwd gather ms: " + ", ".join(
            f"{k} {v * 1e3:.3f}" for k, v in row.items()), flush=True)
        print("   TIMING " + json.dumps({"scene": "cornell_box_gather",
                                         "card": CARD, **{
            k: round(v * 1e3, 4) for k, v in row.items()}}), flush=True)


def phase_t():
    with phase("(t) tests marked gpu"):
        import pytest

        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests", "test_bvh_cuda.py")])
        check(rc == 0, f"GPU tests failed (pytest exit {rc})")


def phase_h(scenes):
    from jax.sharding import Mesh

    from cg_raytracer.parallel.geometry import (PRIM_AXIS, build_geometry_shards,
                                                geometry_sharded_render)
    from cg_raytracer.parallel.sharding import (make_mesh, make_mesh2,
                                                make_train_step, replicated,
                                                row_sharded,
                                                sample_sharded_render,
                                                sharded_render)

    n = len(jax.devices())
    check(n == 4, f"--multi needs 4 GPUs, found {n}")
    cam = cgrt.Camera.default()

    def compare(label, got, want, exact_ok=True):
        got, want = np.asarray(got), np.asarray(want)
        diff = np.abs(got - want)
        bad = (diff.max(axis=-1) > 1e-4).mean() if diff.ndim == 3 else float(
            (diff > 1e-4).mean())
        print(f"   {label}: max abs diff {diff.max():.3e}, bitwise "
              f"{bool((diff == 0).all())}, share beyond 1e-4 {bad:.5f}",
              flush=True)
        check(np.isfinite(got).all(), f"{label}: non-finite")
        check(bad <= 0.005, f"{label}: {bad:.4%} beyond 1e-4")

    with phase("(h) 4 GPUs: ray-sharded render and train step"):
        scene = scenes["teacup"]
        cfg = cgrt.RenderConfig(width=800, height=800)
        bvh = build_accel(scene, cfg)
        mesh = make_mesh(4)
        img4 = sharded_render(scene, cam, cfg, mesh, bvh=bvh)
        img1 = cgrt.render(scene, cam, cfg)
        compare("teacup 800^2 rays over 4", img4, img1)

        import optax

        cfg_t = cgrt.RenderConfig(width=256, height=256)
        target = jnp.zeros((256, 256, 3), jnp.float32)
        params = material_params(scene)
        opt = optax.adam(1e-2)
        step1 = make_train_step(cfg_t, opt, apply_material_params, bvh=bvh)
        p1, _, l1 = step1(params, opt.init(params), scene, cam, target,
                          jax.random.PRNGKey(0))
        step4 = make_train_step(cfg_t, opt, apply_material_params, mesh=mesh,
                                bvh=bvh)
        rep = replicated(mesh)
        with mesh:
            p4, _, l4 = step4(jax.device_put(params, rep),
                              jax.device_put(opt.init(params), rep),
                              jax.device_put(scene, rep), jax.device_put(cam, rep),
                              jax.device_put(target, row_sharded(mesh)),
                              jax.random.PRNGKey(0))
        err = max(rel_err(p4[k], p1[k]) for k in p1)
        print(f"   train step: loss 1 GPU {float(l1):.6e}, 4 GPUs "
              f"{float(l4):.6e}, params max rel diff {err:.2e}", flush=True)
        check(abs(float(l4) - float(l1)) <= 1e-5 * abs(float(l1)) + 1e-9,
              "train-step loss differs")
        check(err <= 1e-4, f"train-step params differ by {err}")

    with phase("(h) 4 GPUs: 2x2 ('rays', 'samples') mesh"):
        scene = scenes["cornell_box_spherical_light"]
        cfg = cgrt.RenderConfig(width=256, height=256, soft_shadow_samples=40,
                                soft_shadow_chunk=20)
        img4 = sample_sharded_render(scene, cam, cfg, make_mesh2(2, 2))
        img1 = cgrt.render(scene, cam, cfg)
        compare("cornell spherical 256^2, 2x2 mesh", img4, img1)

    with phase("(h) 4 GPUs: geometry-sharded render, prims axis of 4"):
        scene = scenes["donut"]
        cfg = cgrt.RenderConfig(width=800, height=800)
        meshg = Mesh(np.asarray(jax.devices()[:4]), (PRIM_AXIS,))
        shards = build_geometry_shards(scene, 4, cfg)
        img4 = geometry_sharded_render(scene, cam, cfg, meshg, shards=shards)
        img1 = cgrt.render(scene, cam, cfg)
        compare("donut 800^2, prims over 4", img4, img1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the 4-GPU phase (h)")
    args = parser.parse_args(argv)
    enable_compilation_cache()

    phase_a()
    names = ("cornell_box", "cornell_box_spherical_light", "monkey", "dragon",
             "teacup", "donut")
    scenes = {name: cgrt.load_scene(name) for name in names}
    if args.multi:
        phase_h(scenes)
    else:
        phase_b(scenes)
        phase_c(scenes)
        phase_d(scenes)
        phase_e(scenes)
        phase_f(scenes)
        phase_g(scenes)
        phase_t()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
