"""Phong shading, hard shadows, stochastic soft shadows — batched over rays.

Reference capability: ``src/main.cpp``:
- ``diffuseOneLight`` (:84-98): Id * Kd * max(cos, 0),
- ``specularOneLight`` (:61-82): Is * Ks * pow(max(cos, 0), shininess) with the
  reflected *view* ray,
- ``pointInShadow`` (:104-135): shadow ray with eps=0.001 origin offset, occluded iff
  an intersection lies closer than the light,
- soft shadows (:166-218): per spherical light, 200 shadow rays to random points on
  the light sphere (Gaussian-normalized directions, ``randomUnitVector`` :46-59),
  visibility fraction scales (diffuse + specular) computed w.r.t. the light center.

Design: everything is a fused elementwise pass over the ray batch; shadow
queries are batched any-hit calls into the active intersection backend; the soft
shadow sample axis is chunked through ``lax.scan`` with a counter-based
``jax.random`` stream (threefry keys derived per (render, bounce, light, chunk)), so
renders are bitwise reproducible under any sharding of the ray axis.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..scene.types import Scene
from .intersect import Surface
from .linalg import dot, norm, reflect, safe_normalize

SHADOW_EPS = 1e-3


def phong_one_light(view_dir, normal, kd, ks, shininess, light_dir, light_color):
    """Diffuse + specular from one light direction (no visibility term).

    view_dir: [N,3] ray direction camera->surface (the reference reuses
    ``ray.direction`` directly, main.cpp:63).  light_dir: [N,3] normalized
    surface->light.  Returns (diffuse [N,3], specular [N,3]).
    """
    diffuse_cos = dot(light_dir, normal)
    diffuse = light_color * kd * jnp.maximum(diffuse_cos, 0.0)[..., None]

    reflected = safe_normalize(reflect(view_dir, normal))
    spec_cos = dot(reflected, light_dir)
    # pow with base clamped to strictly positive keeps grads finite; the <=0 branch
    # is masked to zero exactly as the reference early-out (main.cpp:70-75).
    spec = jnp.power(jnp.maximum(spec_cos, 1e-30), shininess)
    specular = light_color * ks * jnp.where(spec_cos > 0.0, spec, 0.0)[..., None]
    return diffuse, specular


def direct_point_lights(scene: Scene, view_dir, surf: Surface, occluded_fn,
                        shadow_bits=None):
    """Sum of Phong contributions over point lights, gated by hard shadows.

    occluded_fn(origins [N,3], dirs [N,3], t_max [N]) -> bool [N] any-hit oracle.
    ``shadow_bits`` (optional, [N] int32): occlusion bits recorded by the two-phase
    record phase (bit l = light l blocked) — skips the per-light any-hit calls.
    Parity: shadow origin offset eps=0.001 along the shadow dir (main.cpp:110-111);
    occluded iff hit with t < dist - eps (main.cpp:119 tests ``t + eps >= dist`` for
    visibility).
    """
    num_lights = scene.point_lights.position.shape[0]
    if num_lights == 0:
        return jnp.zeros_like(surf.position)

    def one_light(li, lpos, lcol):
        to_light = lpos - surf.position
        ldir = safe_normalize(to_light)
        if shadow_bits is not None:
            blocked = ((shadow_bits >> li) & 1) > 0
        else:
            dist = norm(to_light)
            shadow_origin = surf.position + SHADOW_EPS * ldir
            blocked = occluded_fn(shadow_origin, ldir, dist - SHADOW_EPS)
        diffuse, specular = phong_one_light(
            view_dir, surf.normal, surf.kd, surf.ks, surf.shininess, ldir, lcol
        )
        lit = (~blocked) & surf.valid
        return (diffuse + specular) * lit[..., None].astype(diffuse.dtype)

    contrib = jax.vmap(one_light)(jnp.arange(num_lights),
                                  scene.point_lights.position,
                                  scene.point_lights.color)
    return jnp.sum(contrib, axis=0)


def _random_unit_vectors(key, shape):
    """Gaussian-normalized unit vectors (randomUnitVector, main.cpp:46-59)."""
    g = jax.random.normal(key, shape + (3,), dtype=jnp.float32)
    return safe_normalize(g)


def spherical_fracs(scene: Scene, positions, occluded_fn, key,
                    num_samples: int = 200, sample_chunk: int = 20,
                    sample_constrain=None):
    """Per-(light, ray) soft-shadow visibility FRACTIONS [L, N] — the
    spherical-light oracle (discrete, non-differentiable by the oracle
    contract, exactly like the any-hit bools it aggregates).

    Factored out of ``direct_spherical_lights`` so the two-phase gradient
    structure can record fractions in its oracle phase and shade them in
    phase 2; both callers share the identical PRNG stream
    (``fold_in(key, light)`` then ``fold_in(.., chunk)``), so phase placement
    never changes the sampled visibility.  Counts are normalized by the
    scanned total ``ceil(num_samples / chunk) * chunk``.
    """
    num_lights = scene.spherical_lights.position.shape[0]
    n = positions.shape[0]
    if num_lights == 0:
        return jnp.zeros((0, n), jnp.float32)

    sample_chunk = max(1, min(sample_chunk, num_samples))
    num_chunks = -(-num_samples // sample_chunk)
    total = num_chunks * sample_chunk

    def one_light(li, lpos, lrad):
        def chunk_body(carry, ci):
            ckey = jax.random.fold_in(jax.random.fold_in(key, li), ci)
            units = _random_unit_vectors(ckey, (sample_chunk, n))  # [C,N,3]
            if sample_constrain is not None:
                units = sample_constrain(units)
            sample_pts = lpos + lrad * units
            to_sample = sample_pts - positions[None]
            sdir = safe_normalize(to_sample)
            sorigin = positions[None] + SHADOW_EPS * sdir
            light_t = norm(sample_pts - sorigin)  # main.cpp:181 measures from origin
            flat = lambda a: a.reshape((-1,) + a.shape[2:])
            blocked = occluded_fn(flat(sorigin), flat(sdir), flat(light_t))
            visible = (~blocked).reshape(sample_chunk, n)
            return carry + jnp.sum(visible.astype(jnp.float32), axis=0), None

        vis_count, _ = jax.lax.scan(chunk_body, jnp.zeros((n,), jnp.float32),
                                    jnp.arange(num_chunks))
        return vis_count / jnp.float32(total)

    return jax.vmap(one_light)(
        jnp.arange(num_lights),
        scene.spherical_lights.position,
        scene.spherical_lights.radius,
    )


def direct_spherical_lights(scene: Scene, view_dir, surf: Surface, occluded_fn, key,
                            num_samples: int = 200, sample_chunk: int = 20,
                            sample_constrain=None, fracs=None):
    """Soft-shadowed Phong from spherical lights.

    Parity with main.cpp:168-218: shading terms use the light *center*; visibility is
    the fraction of ``num_samples`` shadow rays to uniform Gaussian-normalized points
    on the light sphere that reach the light (miss, or first hit beyond the sample
    point).  The sample axis is chunked via ``lax.scan`` to bound memory at
    O(N * sample_chunk).

    ``sample_constrain`` (optional): callable applied to the per-chunk [C, N, 3]
    sample-direction batch; the sharded render path passes a
    ``with_sharding_constraint`` to P('samples', 'rays') so each chunk's shadow
    rays split over a second mesh axis and XLA reduces the visibility counts
    across it (parallel/sharding.py::sample_sharded_render) — the framework's
    sequence/sample-parallel axis (SURVEY §5 long-context row).

    ``fracs`` (optional, [L, N]): precomputed visibility fractions (the
    two-phase record path) — skips the sampling entirely.
    """
    num_lights = scene.spherical_lights.position.shape[0]
    if num_lights == 0:
        return jnp.zeros_like(surf.position)

    if fracs is None:
        fracs = spherical_fracs(
            scene, surf.position, occluded_fn, key,
            num_samples=num_samples, sample_chunk=sample_chunk,
            sample_constrain=sample_constrain)

    contrib = jnp.zeros_like(surf.position)
    for li in range(num_lights):
        lpos = scene.spherical_lights.position[li]
        lcol = scene.spherical_lights.color[li]
        ldir_center = safe_normalize(lpos - surf.position)
        diffuse, specular = phong_one_light(
            view_dir, surf.normal, surf.kd, surf.ks, surf.shininess,
            ldir_center, lcol,
        )
        contrib = contrib + (diffuse + specular) * (
            fracs[li] * surf.valid.astype(jnp.float32))[..., None]
    return contrib


def direct_light(scene: Scene, view_dir, surf: Surface, occluded_fn, key,
                 soft_shadow_samples: int = 200, sample_chunk: int = 20,
                 shadow_bits=None, sample_constrain=None, soft_fracs=None):
    """Total direct lighting = point lights + spherical lights (shading(), main.cpp:160-235)."""
    color = direct_point_lights(scene, view_dir, surf, occluded_fn,
                                shadow_bits=shadow_bits)
    color = color + direct_spherical_lights(
        scene, view_dir, surf, occluded_fn, key,
        num_samples=soft_shadow_samples, sample_chunk=sample_chunk,
        sample_constrain=sample_constrain, fracs=soft_fracs,
    )
    return color
