"""Whitted-style renderer: the core render loop.

Reference capability: the recursive ``trace``/``shade``/``getFinalColor`` trio
(``src/main.cpp:160-310``) and the per-pixel loop of
``renderRayTracing`` (main.cpp:648-720).  XLA has no recursion, so the bounce
recursion (depth cap 2, main.cpp:267) becomes an unrolled iterative loop with a
per-ray throughput mask:

    contribution += throughput * direct_light(hit)         (shade, main.cpp:244-263)
    throughput   *= ks;  ray = reflected ray + eps offset  (main.cpp:252-256)
    active       &= hit && any(ks > 0.01)                  (main.cpp:246, fixed form)

The entire render — ray generation, every bounce's closest-hit query, every shadow
ray, shading, effects — is one jittable, differentiable function of the scene
pytree, so ``jax.grad`` flows from pixels to vertices, normals, materials, and
lights.  Intersection backends are pluggable ('brute' | 'bvh' | 'cuda') behind
the oracle + differentiable-reconstruction contract (see ops/intersect.py).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import camera as cam_ops
from ..ops import shading
from ..ops.bvh import BVH, build_bvh, intersect_bvh, occluded_bvh
from ..ops.intersect import (intersect_brute, occluded_brute,
                             reconstruct_hit, record_surface)
from ..ops.linalg import reflect, safe_normalize
from ..scene.types import Camera, Scene
from ..utils.config import RenderConfig

REFLECT_EPS = 1e-3


class Backend(NamedTuple):
    """Intersection oracle pair: closest-hit and any-hit queries."""

    closest: Callable  # (origins, dirs) -> Hit
    occluded: Callable  # (origins, dirs, t_max) -> bool [N]


def make_backend(scene: Scene, cfg: RenderConfig, bvh: Optional[BVH] = None,
                 mesh=None) -> Backend:
    """Oracles for the resolved backend.  ``mesh``: the device mesh a
    ray-sharded caller splits rays over; the CUDA kernel then runs under
    shard_map so each device traverses its own rays."""
    kind = cfg.resolve_backend(scene.num_triangles)
    if kind == "brute":
        return Backend(
            closest=lambda o, d: intersect_brute(scene, o, d, tri_chunk=cfg.tri_chunk),
            occluded=lambda o, d, tm: occluded_brute(scene, o, d, tm, tri_chunk=cfg.tri_chunk),
        )
    if bvh is None:
        bvh = build_bvh(scene, builder=cfg.resolve_bvh_builder())
    if kind == "cuda":
        from ..ops.bvh_cuda import cuda_oracles

        closest, occluded = cuda_oracles(scene, bvh, mesh=mesh)
        return Backend(closest=closest, occluded=occluded)
    return Backend(
        closest=lambda o, d: intersect_bvh(scene, bvh, o, d),
        occluded=lambda o, d, tm: occluded_bvh(scene, bvh, o, d, tm),
    )


def _two_phase_records(sg_scene, origins, dirs, cfg, bounce):
    """Phase 1 of the two-phase gradient structure: per-level oracle records
    (o, d, hit, shadow_bits, active-in), geometry/masks only (stop-grad
    scene).  The reflective test and the reflection rays use only
    stop-gradded quantities the one-phase path also never differentiates
    (masks are discrete; o/d feed stop-gradded oracles), so gradients are
    unchanged — only the partial-eval boundary moves."""
    n = origins.shape[0]
    records = []
    o, d = origins, dirs
    active = jnp.ones((n,), bool)
    for level in range(cfg.max_depth):
        hit, bits = bounce(o, d)
        records.append((o, d, hit, bits, active))
        if level + 1 >= cfg.max_depth:
            break
        # Position/normal/ks straight from the recorded (t, u, v): no
        # Möller–Trumbore recompute and a [T, 15] gather instead of
        # reconstruct's [T, 28].  Exact here: the whole record phase is
        # stop-gradient domain.
        surf = record_surface(sg_scene, o, d, hit)
        lit = active & surf.valid
        if cfg.reference_quirks:
            reflective = surf.ks[..., 2] > 0.01
        else:
            reflective = jnp.any(surf.ks > 0.01, axis=-1)
        active = lit & reflective
        refl_dir = safe_normalize(reflect(d, surf.normal))
        o = surf.position + REFLECT_EPS * refl_dir
        d = jnp.where(active[..., None], refl_dir, d)
    return records


def _synth_bounce(scene: Scene, backend: Backend):
    """Compose a (Hit, shadow_bits) bounce record from the closest/any-hit
    oracles: the closest hit plus per-point-light occlusion bits (bit l =
    light l blocked).  The bits come from the SAME occluded oracle the
    one-phase ``direct_point_lights`` would call, at positions reconstructed
    from the recorded t (identical math, so phase placement doesn't change
    results beyond oracle tie-break noise)."""
    lights = jax.lax.stop_gradient(scene.point_lights.position)
    num_lights = lights.shape[0]

    def bounce(o, d):
        from ..ops.linalg import norm
        from ..ops.shading import SHADOW_EPS

        hit = backend.closest(o, d)
        valid = hit.prim_id >= 0
        t = jnp.where(valid, hit.t, 0.0)
        pos = jnp.where(valid[:, None], o + d * t[:, None], 0.0)
        bits = jnp.zeros((o.shape[0],), jnp.int32)
        for li in range(num_lights):
            to_light = lights[li] - pos
            ldir = safe_normalize(to_light)
            dist = norm(to_light)
            shadow_origin = pos + SHADOW_EPS * ldir
            blocked = backend.occluded(shadow_origin, ldir,
                                       dist - SHADOW_EPS)
            bits = bits | (blocked.astype(jnp.int32) << li)
        return hit, bits

    return bounce


def trace_rays(scene: Scene, origins, dirs, cfg: RenderConfig, backend: Backend, key,
               sample_constrain=None):
    """Iterative Whitted trace of a ray batch -> color [N,3].

    Parity notes vs the reference:
    - miss -> black (trace(), main.cpp:289-294),
    - depth cap: contributions beyond ``max_depth`` levels are dropped (main.cpp:267),
    - reflection continues only while ks is non-negligible; the reference's comma-
      operator bug tests only ks.z (main.cpp:246) — reproduced under
      ``cfg.reference_quirks``, otherwise any(ks > 0.01),
    - reflected ray: reflect(dir, shading normal), origin offset by eps=0.001
      (main.cpp:252-256).
    """
    n = origins.shape[0]

    def shade_level(scene_, o_, d_, hit_, bits_, lkey_, soft_fracs_=None):
        surf_ = reconstruct_hit(scene_, o_, d_, hit_)
        direct_ = shading.direct_light(
            scene_, d_, surf_, backend.occluded, lkey_,
            soft_shadow_samples=cfg.soft_shadow_samples,
            sample_chunk=cfg.soft_shadow_chunk,
            shadow_bits=bits_,
            sample_constrain=sample_constrain,
            soft_fracs=soft_fracs_,
        )
        return direct_, surf_.valid, surf_.ks, surf_.normal, surf_.position

    # Two-phase structure (cfg.grad_two_phase): oracle records first (all
    # bounces, scene stop-gradded), then the differentiable shade chain over
    # them.  Sample-axis sharding owns the soft-shadow sample stream inside
    # the shade, so it keeps the one-phase structure.
    if cfg.resolve_grad_two_phase() and sample_constrain is None:
        sg_scene = jax.tree_util.tree_map(jax.lax.stop_gradient, scene)
        records = _two_phase_records(sg_scene, origins, dirs, cfg,
                                     _synth_bounce(scene, backend))

        # Spherical-light oracle records: per-level visibility fractions at
        # the recorded hit positions (o + t*d, zeroed on miss — Surface miss
        # semantics), with the SAME per-level/per-light/per-chunk key folding
        # as the one-phase path, so the sampled visibility is identical.
        num_sph = scene.spherical_lights.position.shape[0]
        soft_fracs_levels = None
        if num_sph > 0:
            soft_fracs_levels = []
            for level, (o_rec, d_rec, hit_l, _, _) in enumerate(records):
                valid_l = hit_l.prim_id >= 0
                t_l = jnp.where(valid_l, hit_l.t, 0.0)
                pos_l = jnp.where(valid_l[:, None],
                                  o_rec + d_rec * t_l[:, None], 0.0)
                fr = shading.spherical_fracs(
                    sg_scene, pos_l, backend.occluded,
                    jax.random.fold_in(key, level),
                    num_samples=cfg.soft_shadow_samples,
                    sample_chunk=cfg.soft_shadow_chunk)
                soft_fracs_levels.append(fr)

        # --- Phase 2: differentiable shade chain over the records, with the
        # bounce rays RECOMPUTED differentiably from the previous level's
        # surface (position + eps * reflect).  The recorded o/d are primal-
        # equal byproducts of phase 1 (same reconstruct math on the same hit
        # ids) and are unused past level 0; recomputing them here threads the
        # reflected-ray-origin dependence through the graph, so vertex grads
        # match the one-phase path exactly.  Masks stay the recorded primal
        # ones (discrete, identical to a recompute).  'recorded' rays consume
        # the stop-gradded phase-1 rays instead, which drops the
        # reflected-origin vertex term (selected only where that term is
        # structurally zero).
        exact_rays = cfg.resolve_two_phase_rays() == "exact"
        color = jnp.zeros((n, 3), jnp.float32)
        throughput = jnp.ones((n, 3), jnp.float32)
        o_l, d_l = origins, dirs
        for level, (o_rec, d_rec, hit_l, bits_l, active_l) in enumerate(records):
            if not exact_rays and level > 0:
                o_l, d_l = o_rec, d_rec
            fr_l = (soft_fracs_levels[level]
                    if soft_fracs_levels is not None else None)
            lkey = jax.random.fold_in(key, level)
            direct, valid, ks, normal, position = shade_level(
                scene, o_l, d_l, hit_l, bits_l, lkey, fr_l)
            lit = active_l & valid
            color = color + throughput * direct * lit[..., None].astype(jnp.float32)
            throughput = throughput * ks
            if level + 1 >= len(records) or not exact_rays:
                continue
            active_next = records[level + 1][4]
            refl_dir = safe_normalize(reflect(d_l, normal))
            o_l = position + REFLECT_EPS * refl_dir
            d_l = jnp.where(active_next[..., None], refl_dir, d_l)
        return color

    color = jnp.zeros((n, 3), jnp.float32)
    throughput = jnp.ones((n, 3), jnp.float32)
    active = jnp.ones((n,), bool)
    o, d = origins, dirs
    for level in range(cfg.max_depth):
        hit = backend.closest(o, d)
        lkey = jax.random.fold_in(key, level)
        direct, valid, ks, normal, position = shade_level(
            scene, o, d, hit, None, lkey)
        lit = active & valid
        color = color + throughput * direct * lit[..., None].astype(jnp.float32)

        if level + 1 >= cfg.max_depth:
            break
        if cfg.reference_quirks:
            # Comma-operator bug: only ks.z is tested (main.cpp:246).
            reflective = ks[..., 2] > 0.01
        else:
            reflective = jnp.any(ks > 0.01, axis=-1)
        active = lit & reflective
        throughput = throughput * ks
        refl_dir = safe_normalize(reflect(d, normal))
        o = position + REFLECT_EPS * refl_dir
        d = jnp.where(active[..., None], refl_dir, d)

    return color


def _render_flat(scene: Scene, camera: Camera, cfg: RenderConfig, backend: Backend,
                 key, offset=(0.0, 0.0), sample_constrain=None):
    origins, dirs = cam_ops.generate_rays(camera, cfg.height, cfg.width, offset=offset)
    if cfg.ray_chunk and cfg.ray_chunk < origins.shape[0]:
        num = origins.shape[0]
        chunk = cfg.ray_chunk
        pad = (-num) % chunk
        o = jnp.pad(origins, ((0, pad), (0, 0)))
        d = jnp.pad(dirs, ((0, pad), (0, 0)), constant_values=1.0)
        o = o.reshape(-1, chunk, 3)
        d = d.reshape(-1, chunk, 3)
        colors = jax.lax.map(
            lambda od: trace_rays(scene, od[0], od[1], cfg, backend, key,
                                  sample_constrain=sample_constrain), (o, d)
        )
        color = colors.reshape(-1, 3)[:num]
    else:
        color = trace_rays(scene, origins, dirs, cfg, backend, key,
                           sample_constrain=sample_constrain)
    return color.reshape(cfg.height, cfg.width, 3)


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig,
                 backend: Optional[Backend] = None, bvh: Optional[BVH] = None,
                 key=None, sample_constrain=None):
    """Full render: AA supersampling + bloom + motion blur post-passes.

    This is the functional equivalent of ``renderRayTracing`` (main.cpp:648-720).
    Returns [H, W, 3] float32 in image-row order (row 0 = top), linear values
    (clamp/quantize happens at write time, parity with screen.cpp:38-49).

    ``sample_constrain``: optional sharding constraint for the soft-shadow
    sample axis (parallel/sharding.py::sample_sharded_render).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    if backend is None:
        backend = make_backend(scene, cfg, bvh=bvh)

    from ..ops import effects

    if cfg.bloom and cfg.reference_quirks and cfg.anti_aliasing and not cfg.motion_blur:
        # The reference's AA+bloom path thresholds the running subsample sum
        # and its final setPixel REPLACES the AA average (main.cpp:663-705);
        # it cannot be expressed as a post-pass on the supersampled image.
        return effects.bloom_quirk_aa(
            lambda off: _render_flat(scene, camera, cfg, backend, key,
                                     offset=off, sample_constrain=sample_constrain),
            cfg,
        )

    def base_render(camera_, key_):
        if cfg.anti_aliasing:
            return effects.supersample_render(
                lambda off: _render_flat(scene, camera_, cfg, backend, key_,
                                         offset=off, sample_constrain=sample_constrain),
                cfg,
            )
        return _render_flat(scene, camera_, cfg, backend, key_,
                            sample_constrain=sample_constrain)

    if cfg.motion_blur:
        img = effects.motion_blur(base_render, camera, cfg, key)
    else:
        img = base_render(camera, key)

    if cfg.bloom:
        img = effects.bloom(img, cfg)
    return img


def render_rows(scene: Scene, camera: Camera, cfg: RenderConfig, rows: slice,
                backend: Optional[Backend] = None, bvh: Optional[BVH] = None,
                key=None, offset=(0.0, 0.0)):
    """Render only image rows [rows.start, rows.stop) -> [k, W, 3].

    The row-tile primitive behind multi-host output assembly (each host renders
    and writes its ``host_local_rows`` slice without an all-gather) and failure
    recovery (re-run one failed tile instead of the whole frame) — SURVEY §5
    failure-detection row.  AA supersampling and motion blur are per-pixel and
    compose row-locally; bloom gathers a 21x21 neighborhood and therefore needs
    the full frame (raises).
    """
    if cfg.bloom:
        raise ValueError("render_rows cannot apply bloom: it gathers a 21x21 "
                         "pixel neighborhood across row-tile boundaries; "
                         "apply ops.effects.bloom on the assembled frame")
    if key is None:
        key = jax.random.PRNGKey(0)
    if backend is None:
        backend = make_backend(scene, cfg, bvh=bvh)
    start, stop, step = rows.indices(cfg.height)
    if step != 1:
        raise ValueError("render_rows requires a contiguous row slice")
    k = stop - start

    from ..ops import effects

    def rows_flat(camera_, key_, off):
        ndc = cam_ops.pixel_ndc(cfg.height, cfg.width, offset=off)[start:stop]
        origin, dirs = cam_ops.generate_ray(camera_, ndc.reshape(-1, 2))
        origins = jnp.broadcast_to(origin, dirs.shape)
        color = trace_rays(scene, origins, dirs, cfg, backend, key_)
        return color.reshape(k, cfg.width, 3)

    def base(camera_, key_):
        if cfg.anti_aliasing:
            return effects.supersample_render(
                lambda off: rows_flat(camera_, key_, off), cfg)
        return rows_flat(camera_, key_, offset)

    if cfg.motion_blur:
        return effects.motion_blur(base, camera, cfg, key)
    return base(camera, key)


def effective_max_depth(scene: Scene, cfg: RenderConfig) -> int:
    """Host-side bounce-count shortcut: if no material can pass the reflection
    continue-test (``any(ks > 0.01)``, or ``ks.z > 0.01`` under reference quirks,
    main.cpp:246), every bounce past the first contributes exactly zero — skip
    compiling them.  Only applies when the scene is concrete (outside jit)."""
    import numpy as np

    try:
        ks = np.asarray(scene.materials.ks)
        sks = np.asarray(scene.spheres.ks)
    except Exception:  # traced values: can't inspect, keep configured depth
        return cfg.max_depth
    if cfg.reference_quirks:
        reflective = (ks[:, 2] > 0.01).any() or (sks.size > 0 and (sks[:, 2] > 0.01).any())
    else:
        reflective = (ks > 0.01).any() or (sks.size > 0 and (sks > 0.01).any())
    return cfg.max_depth if reflective else min(cfg.max_depth, 1)


def needs_bvh(cfg: RenderConfig, num_tris: int) -> bool:
    """Whether the resolved backend requires a prebuilt acceleration structure
    (host-side build — must happen outside jit)."""
    return cfg.resolve_backend(num_tris) in ("bvh", "cuda")


def build_accel(scene: Scene, cfg: RenderConfig):
    """Host-side BVH build for the resolved backend, or None for brute force.

    Memoized on the identity of the scene's triangle buffer: the build is a
    host-side pass plus a device upload, so rebuilding it inside a render loop
    would dominate the render itself — ``render(bvh=None)`` calls this every
    frame and relies on the cache.
    """
    if not needs_bvh(cfg, scene.num_triangles):
        return None
    builder = cfg.resolve_bvh_builder()
    return _cached_accel(scene, ("bvh", builder),
                         lambda: build_bvh(scene, builder=builder))


_ACCEL_CACHE: dict = {}


def _cached_accel(scene: Scene, tag: tuple, builder):
    """Accel memo keyed on the triangle/vertex buffer identities (geometry only
    — materials and lights don't affect the tree).  Entries are evicted when the
    keying buffers are garbage-collected, so a stale id() can never be reused."""
    import weakref

    tris, verts = scene.triangles, scene.vertices
    key = (id(tris), id(verts), int(scene.num_triangles)) + tag
    hit = _ACCEL_CACHE.get(key)
    if hit is not None:
        return hit
    accel = _ACCEL_CACHE[key] = builder()
    for buf in (tris, verts):
        try:
            weakref.finalize(buf, _ACCEL_CACHE.pop, key, None)
        except TypeError:  # non-weakrefable leaf (e.g. numpy scalar): no eviction
            pass
    return accel


import functools


@functools.partial(jax.jit, static_argnames=("cfg",))
def _render_jit(scene, camera, bvh, key, cfg):
    backend = make_backend(scene, cfg, bvh=bvh)
    return render_image(scene, camera, cfg, backend=backend, key=key)


def render(scene: Scene, camera: Camera, cfg: RenderConfig, key=None, jit: bool = True,
           bvh=None):
    """User-facing render entry point.

    The jitted computation is cached on the (hashable) config + pytree structure —
    repeated calls with the same cfg re-trace nothing (a fresh closure per call
    costs ~1 s of tracing overhead per render, which would dwarf the render
    itself).
    """
    import dataclasses

    depth = effective_max_depth(scene, cfg)
    if depth != cfg.max_depth:
        cfg = dataclasses.replace(cfg, max_depth=depth)
    if bvh is None and needs_bvh(cfg, scene.num_triangles):
        bvh = build_accel(scene, cfg)
    if key is None:
        key = jax.random.PRNGKey(0)

    if not jit:
        backend = make_backend(scene, cfg, bvh=bvh)
        return render_image(scene, camera, cfg, backend=backend, key=key)
    return _render_jit(scene, camera, bvh, key, cfg)
