"""Render configuration.

Reference capability: the reference's "config system" is compile-time defines plus
ImGui globals (``bloom``/``blur``/``antiAliasing`` at main.cpp:33-35, scene/light
widgets at main.cpp:769-882).  Every interactive tunable becomes a field here; the
dataclass is frozen/hashable so it can be a static jit argument.
"""
from __future__ import annotations

import dataclasses

BACKENDS = ("auto", "brute", "bvh", "cuda")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800  # reference windowResolution (main.cpp:29)
    height: int = 800
    max_depth: int = 2  # reflection recursion cap (trace(), main.cpp:267)
    anti_aliasing: bool = False  # 2x2 supersampling (main.cpp:663-687)
    bloom: bool = False  # threshold + 21x21 box blur (main.cpp:586-628)
    motion_blur: bool = False  # 16 lookAt-jittered renders averaged (main.cpp:318-584)
    soft_shadow_samples: int = 200  # shadow rays per spherical-light shading (main.cpp:176)
    soft_shadow_chunk: int = 20  # scan chunk for the sample axis (memory bound)
    # Intersection backend: 'brute' (jnp sweep over every triangle), 'bvh'
    # (jnp while-loop traversal; runs on every platform and is the reference
    # for the kernel), 'cuda' (per-ray CUDA traversal kernel; GPU only) or
    # 'auto' (brute up to brute_force_max_tris, then 'cuda' on a GPU and
    # 'bvh' elsewhere).
    backend: str = "auto"
    ray_chunk: int = 0  # >0: process rays in chunks of this size (host loop)
    tri_chunk: int = 2048  # triangle tile per brute-force scan step
    reference_quirks: bool = False  # reproduce documented reference bugs (SURVEY §0)
    # auto backend: brute force below this triangle count, BVH above.
    brute_force_max_tris: int = 4096

    # BVH split rule: 'median' (the reference's rule, bvh.cpp:192-207) or
    # 'sah' (binned surface-area heuristic).  'auto' means 'median'.  Pure
    # build-side change: the oracle contract is unchanged (tie-breaks on
    # coincident-t edges may differ).
    bvh_builder: str = "auto"

    def resolve_bvh_builder(self) -> str:
        if self.bvh_builder not in ("auto", "median", "sah"):
            raise ValueError(
                f"bvh_builder must be 'auto' | 'median' | 'sah', got "
                f"{self.bvh_builder!r}")
        return "median" if self.bvh_builder == "auto" else self.bvh_builder

    def resolve_backend(self, num_tris: int, platform: str | None = None) -> str:
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.backend != "auto":
            return self.backend
        if num_tris <= self.brute_force_max_tris:
            return "brute"
        if platform is None:
            import jax

            platform = jax.default_backend()
        return "cuda" if platform == "gpu" else "bvh"

    # Two-phase gradient structure: phase 1 computes every level's oracle
    # records (bounce hits + shadow bits + reflection rays) with the scene
    # stop-gradded; phase 2 re-runs reconstruct+shade differentiably over the
    # records, RECOMPUTING the bounce rays from each level's surface so the
    # reflected-ray-origin vertex-grad term flows.  Gradients are exact for
    # every param set (the one-phase path never differentiates the oracle
    # either); what changes is the partial-eval boundary XLA sees.  'auto' =
    # off for render(); optimize() and the benchmark turn it on.
    grad_two_phase: str = "auto"

    def resolve_grad_two_phase(self) -> bool:
        if self.grad_two_phase not in ("auto", "on", "off"):
            raise ValueError(
                f"grad_two_phase must be 'auto' | 'on' | 'off', got "
                f"{self.grad_two_phase!r}")
        return self.grad_two_phase == "on"

    # Phase-2 ray source for the two-phase structure.  'exact': bounce rays
    # are recomputed differentiably from each level's surface, so the
    # reflected-ray-origin vertex-grad term flows (full-gradient contract).
    # 'recorded': phase 2 consumes the stop-gradded phase-1 rays — drops that
    # one vertex term (material/light grads stay exact) and saves the
    # reflect-chain recompute and its VJP.  'auto' = 'exact'; optimize() and
    # the benchmark select 'recorded' when no vertex params are being
    # differentiated (the dropped term is then zero anyway).
    two_phase_rays: str = "auto"

    def resolve_two_phase_rays(self) -> str:
        if self.two_phase_rays not in ("auto", "exact", "recorded"):
            raise ValueError(
                f"two_phase_rays must be 'auto' | 'exact' | 'recorded', got "
                f"{self.two_phase_rays!r}")
        return "exact" if self.two_phase_rays == "auto" else self.two_phase_rays
