"""Roofline model: how fast *could* each render go on this device, and what
fraction of that a measured time achieves.

Two resource ceilings bound a render:

- **float32 compute**: intersection (Moller-Trumbore, slab tests) and shading
  (Phong) are elementwise float32 code; on a GPU it runs on the CUDA cores,
  not the tensor cores.  The only matrix work is the small one-hot gather in
  ``reconstruct_hit``.
- **device-memory bandwidth**: every stage streams per-ray buffers (rays, hits,
  surfaces, colours) through device memory.

``roofline_seconds`` takes the larger of (flops / float32 peak) and
(bytes / memory bandwidth); ``pct_of_roofline`` divides that ideal time by the
measured time.  FLOP counts are *useful per-ray work*: what an ideal per-ray
traversal executes, counted from ``ops/intersect.py``, ``ops/bvh.py`` and
``native/bvh_traverse.cu``.  Divisions, square roots and powers count as one
operation each (they take several), so the compute ceiling is optimistic and
the reported fractions conservative.

Peaks are published numbers, kept in one table keyed by the ``device_kind``
JAX reports.  A device that is not in the table is an error, not a default.
A share against a published peak says how far a kernel is from the data
sheet; the card's power limit belongs beside it (a card set below its maximum
cannot hold its top clock under load).
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Device peaks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    f32_flops: float  # float32 FLOP/s outside the tensor cores
    bf16_tensor_flops: float  # dense bf16 tensor-core FLOP/s
    hbm_bytes_per_s: float
    source: str


_H100_SXM = Peaks(
    name="NVIDIA H100 SXM",
    f32_flops=67e12,
    bf16_tensor_flops=989e12,
    hbm_bytes_per_s=3.35e12,
    source="NVIDIA H100 Tensor Core GPU data sheet, SXM column (dense rates, "
           "700 W)",
)

# Keyed by jax.Device.device_kind.
PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def device_peaks(device_kind: str) -> Peaks:
    """Published peaks for a device kind; raises for a kind not in PEAKS."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; known: "
            f"{sorted(PEAKS)}") from None


# ---------------------------------------------------------------------------
# Per-op float32 operation counts.
# Each add/mul/cmp/select/min/max/div/sqrt/pow counts as 1.
# ---------------------------------------------------------------------------

# moller_trumbore (ops/intersect.py): edges 6, pvec 9, det 5, det-test 2,
# inv_det 2, tvec 3, u 6, qvec 9, v 6, t 6, validity chain 9.
MT_FLOPS = 64
# closest-hit running-minimum update: closer = valid & (t < t_best) + 4 selects
CLOSEST_UPDATE = 6
# any-hit accumulate: ok & (t < tmax), or-reduce
ANYHIT_UPDATE = 4
# per-light shadow-ray construction: to-light 3, dist 6, inv 2, dir 3,
# origin 6, tmax 1
SHADOW_SETUP = 21

# padded slab test (ops/bvh.py::_slab): 12 sub/mul, 10 min/max, pad 3,
# hit chain 5
SLAB_FLOPS = 30
# entry-distance test against the running closest hit: pad 3, add/cmp/and 3
TBOUND_FLOPS = 6
# one internal-node expansion of the per-ray traversal: two child slab tests
# with their t bounds, near/far ordering ~10, the pop's re-test 6
INTERNAL_VISIT_FLOPS = 2 * (SLAB_FLOPS + TBOUND_FLOPS) + 10 + TBOUND_FLOPS

# jnp stages (models/whitted.py + ops/shading.py + ops/intersect.py), per ray:
# reconstruct_hit: one MT re-solve 64, normal interpolation ~30, face normal
# cross+normalize ~25, facing flip + masking selects ~30
RECON_FLOPS = 150
# phong_one_light + shadow gating per light: normalize ~9, diffuse ~15,
# reflect+normalize ~21, specular pow chain ~10, masks ~5
SHADE_FLOPS = 60
# per-bounce bookkeeping in trace_rays: throughput update, reflection dir,
# masks, contribution accumulate
BOUNCE_MISC_FLOPS = 50

# ---------------------------------------------------------------------------
# Device-memory traffic lower bounds (bytes/ray) — the unavoidable streams.
# ---------------------------------------------------------------------------

# oracle query: 6 ray components + tmax in (28 B), t/prim/u/v/bits out (20 B)
ORACLE_BYTES = 48
# reconstruction: one packed [*,28] f32 row gather in + Surface fields out (~60 B)
RECON_BYTES = 28 * 4 + 60
# shading: surface fields re-read + color accumulate (several [N,3] streams)
SHADE_BYTES = 120


def brute_flops_per_ray(num_tris: int, num_lights: int, bounces: int,
                        include_bwd: bool = False) -> float:
    """Useful float32 operations per primary ray for the brute-sweep path
    (every ray tests every triangle — cornell-class scenes;
    ops/intersect.py::intersect_brute / occluded_brute).

    The sweeps are non-differentiated oracles (stop_gradient), so the
    backward pass only replays reconstruction + shading VJPs (~2x their
    forward cost); the sweeps are forward-only either way.
    """
    closest = num_tris * (MT_FLOPS + CLOSEST_UPDATE)
    shadow = num_lights * (SHADOW_SETUP + num_tris * (MT_FLOPS + ANYHIT_UPDATE))
    oracle = bounces * (closest + shadow)
    jnp_fwd = bounces * (RECON_FLOPS + num_lights * SHADE_FLOPS + BOUNCE_MISC_FLOPS)
    total = oracle + jnp_fwd
    if include_bwd:
        total += 2 * jnp_fwd
    return float(total)


def bvh_flops_per_ray(internal_visits: float, tri_tests: float, num_lights: int,
                      bounces: int, include_bwd: bool = False,
                      shadow_internal_visits: float | None = None,
                      shadow_tri_tests: float | None = None) -> float:
    """Useful float32 operations per ray for a BVH-traversal render,
    parameterized by *measured* mean per-ray traversal statistics
    (``bvh_visit_stats``).

    internal_visits / tri_tests: mean internal-node expansions and triangle
    tests per closest-hit query.  Shadow queries default to the same stats
    (any-hit early exit makes them cheaper in practice, which again makes the
    ceiling optimistic and the reported fraction conservative).
    """
    if shadow_internal_visits is None:
        shadow_internal_visits = internal_visits
    if shadow_tri_tests is None:
        shadow_tri_tests = tri_tests
    closest = (internal_visits * INTERNAL_VISIT_FLOPS
               + tri_tests * (MT_FLOPS + CLOSEST_UPDATE))
    shadow = num_lights * (SHADOW_SETUP
                           + shadow_internal_visits * INTERNAL_VISIT_FLOPS
                           + shadow_tri_tests * (MT_FLOPS + ANYHIT_UPDATE))
    oracle = bounces * (closest + shadow)
    jnp_fwd = bounces * (RECON_FLOPS + num_lights * SHADE_FLOPS + BOUNCE_MISC_FLOPS)
    total = oracle + jnp_fwd
    if include_bwd:
        total += 2 * jnp_fwd
    return float(total)


def bytes_per_ray(num_lights: int, bounces: int, include_bwd: bool = False) -> float:
    """Device-memory stream lower bound per ray (triangle/node tables are
    small next to the per-ray buffers and amortize to ~0 per ray)."""
    oracle = bounces * (1 + num_lights) * ORACLE_BYTES
    jnp_fwd = bounces * (RECON_BYTES + SHADE_BYTES)
    total = oracle + jnp_fwd
    if include_bwd:
        # VJP re-streams activations and writes grads (~2x the forward jnp
        # traffic); the oracles are not differentiated.
        total += 2 * jnp_fwd
    return float(total)


def roofline_seconds(flops: float, bytes_: float, peaks: Peaks):
    """Ideal frame time and which resource binds it."""
    t_compute = flops / peaks.f32_flops
    t_memory = bytes_ / peaks.hbm_bytes_per_s
    if t_compute >= t_memory:
        return t_compute, "compute (float32)"
    return t_memory, "memory (HBM)"


def pct_of_roofline(measured_s: float, flops: float, bytes_: float,
                    peaks: Peaks) -> float:
    ideal, _ = roofline_seconds(flops, bytes_, peaks)
    return 100.0 * ideal / measured_s


def headline_roofline(width: int, height: int, num_tris: int, num_lights: int,
                      bounces: int, include_bwd: bool, peaks: Peaks) -> dict:
    """Roofline summary for a brute-sweep render (the bench.py headline:
    cornell_box 1024^2 fwd+bwd, 32 triangles, 1 point light, 2 bounces)."""
    rays = width * height
    flops = rays * brute_flops_per_ray(num_tris, num_lights, bounces,
                                       include_bwd=include_bwd)
    byts = rays * bytes_per_ray(num_lights, bounces, include_bwd=include_bwd)
    ideal, bound = roofline_seconds(flops, byts, peaks)
    return {
        "peaks": peaks.name,
        "rays": rays,
        "gflops_per_frame": flops / 1e9,
        "mbytes_per_frame": byts / 1e6,
        "ideal_seconds": ideal,
        "bound": bound,
        "ideal_rays_per_s": rays / ideal,
    }


# ---------------------------------------------------------------------------
# Measured traversal statistics: an instrumented replica of the jnp per-ray
# traversal (ops/bvh.py::traverse_closest) that counts node expansions and
# triangle tests instead of returning hits.  Pure counting, so any backend
# gives the same numbers; run it on a sample of rays.
# ---------------------------------------------------------------------------


def bvh_visit_stats(bvh, origins, dirs, t_max=None, max_stack: int = 64) -> dict:
    """Mean per-ray closest-hit traversal counts: internal-node expansions and
    triangle tests.  Mirrors ops.bvh.traverse_closest's stack walk (same slab
    epsilons and near-to-far ordering) with counters.
    """
    import jax
    import jax.numpy as jnp

    from ..ops.bvh import _SLAB_EPS, _slab
    from ..ops.intersect import MISS, moller_trumbore

    n = origins.shape[0]
    chunk = bvh.max_leaf
    t0 = (jnp.full((n,), jnp.inf, jnp.float32) if t_max is None
          else jnp.broadcast_to(t_max, (n,)).astype(jnp.float32))

    def ray_fn(o, d, t_init):
        inv_d = 1.0 / d
        state = dict(
            sp=jnp.int32(1), stack=jnp.zeros((max_stack,), jnp.int32),
            stack_off=jnp.zeros((max_stack,), jnp.int32),
            t=t_init, slot=MISS, n_int=jnp.int32(0), n_tris=jnp.int32(0),
        )

        def cond(s):
            return s["sp"] > 0

        def body(s):
            sp = s["sp"] - 1
            ni = s["stack"][sp]
            off = s["stack_off"][sp]
            t_in, box_hit = _slab(o, inv_d, bvh.node_lo[ni], bvh.node_hi[ni])
            box_hit = box_hit & (t_in <= s["t"] + _SLAB_EPS * (1.0 + jnp.abs(s["t"])))
            cnt = bvh.count[ni]
            is_leaf = cnt > 0
            do_leaf = box_hit & is_leaf

            base = bvh.first[ni] + off
            t_cur, slot_cur = s["t"], s["slot"]
            for k in range(chunk):
                idx = base + k
                in_range = do_leaf & (off + k < cnt)
                safe = jnp.where(in_range, idx, 0)
                tt, _, _, ok = moller_trumbore(o, d, bvh.tv0[safe], bvh.tv1[safe],
                                               bvh.tv2[safe])
                ok = ok & in_range & (tt < t_cur)
                t_cur = jnp.where(ok, tt, t_cur)
                slot_cur = jnp.where(ok, safe, slot_cur)
            tests_here = jnp.where(do_leaf, jnp.minimum(cnt - off, chunk), 0)
            more = do_leaf & (off + chunk < cnt)
            stack = s["stack"].at[sp].set(ni)
            stack_off = s["stack_off"].at[sp].set(off + chunk)
            sp = sp + jnp.where(more, 1, 0)

            do_int = box_hit & (~is_leaf)
            li, ri = bvh.left[ni], bvh.right[ni]
            tl, hl = _slab(o, inv_d, bvh.node_lo[li], bvh.node_hi[li])
            tr, hr = _slab(o, inv_d, bvh.node_lo[ri], bvh.node_hi[ri])
            t_pad = _SLAB_EPS * (1.0 + jnp.abs(t_cur))
            hl = hl & do_int & (tl <= t_cur + t_pad)
            hr = hr & do_int & (tr <= t_cur + t_pad)
            left_near = tl <= tr
            near_i = jnp.where(left_near, li, ri)
            far_i = jnp.where(left_near, ri, li)
            near_h = jnp.where(left_near, hl, hr)
            far_h = jnp.where(left_near, hr, hl)
            stack = stack.at[sp].set(jnp.where(far_h, far_i, stack[sp]))
            stack_off = stack_off.at[sp].set(jnp.where(far_h, 0, stack_off[sp]))
            sp = sp + jnp.where(far_h, 1, 0)
            stack = stack.at[sp].set(jnp.where(near_h, near_i, stack[sp]))
            stack_off = stack_off.at[sp].set(jnp.where(near_h, 0, stack_off[sp]))
            sp = sp + jnp.where(near_h, 1, 0)

            return dict(sp=sp, stack=stack, stack_off=stack_off, t=t_cur,
                        slot=slot_cur,
                        n_int=s["n_int"] + do_int.astype(jnp.int32),
                        n_tris=s["n_tris"] + tests_here)

        out = jax.lax.while_loop(cond, body, state)
        return out["n_int"], out["n_tris"]

    n_int, n_tris = jax.jit(jax.vmap(ray_fn))(origins, dirs, t0)
    return {
        "mean_internal_visits": float(jnp.mean(n_int)),
        "mean_tri_tests": float(jnp.mean(n_tris)),
        "max_internal_visits": int(jnp.max(n_int)),
        "max_tri_tests": int(jnp.max(n_tris)),
    }
