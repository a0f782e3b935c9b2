"""Command-line interface.

Reference capability: the interactive app loop (``src/main.cpp:722-939``)
— scene picker, render-to-file button with timing printout, light editor, effect
checkboxes.  Headless equivalent: every ImGui tunable is a flag; ``render`` writes
the image and prints the wall-clock time like the reference's
"Time to render image: ... milliseconds" (main.cpp:796).
"""
from __future__ import annotations

import argparse
import sys
import time


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="cornell_box",
                   help="preset name (see --list-scenes) ")
    p.add_argument("--data-dir", default=None, help="OBJ/MTL directory")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--max-bounces", type=int, default=2)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "brute", "bvh", "cuda"])
    p.add_argument("--spp", type=int, default=200,
                   help="soft-shadow samples per spherical-light shading")
    p.add_argument("--aa", action="store_true", help="2x2 supersampling")
    p.add_argument("--bloom", action="store_true")
    p.add_argument("--motion-blur", action="store_true")
    p.add_argument("--reference-quirks", action="store_true",
                   help="reproduce documented reference bugs for pixel parity")
    p.add_argument("--seed", type=int, default=0)
    # Camera (defaults = reference main.cpp:730-731).
    p.add_argument("--look-at", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--euler-deg", type=float, nargs=3, default=[20.0, 20.0, 0.0])
    p.add_argument("--dist", type=float, default=3.0)
    p.add_argument("--fovy-deg", type=float, default=50.0)
    # Light editor (the ImGui panel, main.cpp:812-876).  Lights are addressed
    # by a unified index: point lights first, then spherical — the same order
    # as the reference's "Selected light" combo.  Removes apply first (each
    # re-indexing, like repeated button presses), then adds, then the
    # --light-pos/--light-color/--light-radius edit of --light-index.
    p.add_argument("--light-index", type=int, default=0,
                   help="which light --light-pos/--light-color/--light-radius "
                        "edit (point lights first, then spherical)")
    p.add_argument("--light-pos", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"),
                   help="override position of the selected light")
    p.add_argument("--light-color", type=float, nargs=3, default=None,
                   metavar=("R", "G", "B"),
                   help="override color of the selected light")
    p.add_argument("--light-radius", type=float, default=None,
                   help="override radius of the selected spherical light")
    p.add_argument("--add-point-light", type=float, nargs=6, action="append",
                   default=None, metavar=("X", "Y", "Z", "R", "G", "B"),
                   help="append a point light (repeatable)")
    p.add_argument("--add-spherical-light", type=float, nargs=7, action="append",
                   default=None,
                   metavar=("X", "Y", "Z", "RADIUS", "R", "G", "B"),
                   help="append a spherical light (repeatable)")
    p.add_argument("--remove-light", type=int, action="append", default=None,
                   metavar="INDEX", help="remove the light at INDEX (repeatable)")


def _build(args):
    import jax

    from . import Camera, RenderConfig, load_scene
    from .scene.lights import apply_edits

    scene = load_scene(args.scene, data_dir=args.data_dir)
    scene = apply_edits(
        scene,
        removes=args.remove_light or (),
        add_points=args.add_point_light or (),
        add_sphericals=args.add_spherical_light or (),
        index=args.light_index,
        position=args.light_pos,
        color=args.light_color,
        radius=args.light_radius,
    )
    camera = Camera.default(look_at=args.look_at, euler_deg=args.euler_deg,
                            dist=args.dist, fovy_deg=args.fovy_deg,
                            aspect=args.width / args.height)
    cfg = RenderConfig(
        width=args.width, height=args.height, max_depth=args.max_bounces,
        anti_aliasing=args.aa, bloom=args.bloom, motion_blur=args.motion_blur,
        soft_shadow_samples=args.spp, backend=args.backend,
        reference_quirks=args.reference_quirks,
    )
    key = jax.random.PRNGKey(args.seed)
    return scene, camera, cfg, key


def cmd_render(args) -> int:
    import jax

    from . import render
    from .utils.image import write_bmp, write_png

    scene, camera, cfg, key = _build(args)
    # Warm-up compile, then timed render (parity with the reference's chrono around
    # renderRayTracing, main.cpp:792-796 — compile time excluded like its BVH build).
    img = render(scene, camera, cfg, key=key)
    jax.block_until_ready(img)
    from .utils.profiling import profiler_trace

    with profiler_trace(getattr(args, "profile", None)):
        t0 = time.perf_counter()
        img = render(scene, camera, cfg, key=key)
        jax.block_until_ready(img)
        ms = (time.perf_counter() - t0) * 1e3
    print(f"Time to render image: {ms:.2f} milliseconds")
    rays = cfg.width * cfg.height
    print(f"{rays / (ms / 1e3):.3e} primary rays/s")
    if args.output.lower().endswith(".bmp"):
        write_bmp(args.output, img)
    else:
        write_png(args.output, img)
    print(f"wrote {args.output}")
    return 0


def cmd_optimize(args) -> int:
    from .optim.inverse import optimize
    from .utils.image import read_image, write_png

    scene, camera, cfg, key = _build(args)
    target = read_image(args.target)
    if target.shape[:2] != (cfg.height, cfg.width):
        print(f"error: target is {target.shape[1]}x{target.shape[0]}, "
              f"render is {cfg.width}x{cfg.height}", file=sys.stderr)
        return 2
    params, losses = optimize(
        scene, camera, target, cfg, steps=args.steps, learning_rate=args.lr,
        checkpoint_path=args.checkpoint, key=key,
    )
    print(f"final loss: {losses[-1]:.6e}")
    if args.output:
        from . import render
        from .optim.inverse import apply_material_params

        img = render(apply_material_params(scene, params), camera, cfg, key=key)
        write_png(args.output, img)
        print(f"wrote {args.output}")
    return 0


def cmd_bench(args) -> int:
    from .utils.bench import run_bench

    result = run_bench(scene=args.scene, width=args.width, height=args.height,
                       backend=args.backend)
    import json

    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="cgrt", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_render = sub.add_parser("render", help="render a scene to an image file")
    _add_common(p_render)
    p_render.add_argument("--output", "-o", default="render.png")
    p_render.add_argument("--profile", default=None, metavar="DIR",
                          help="write a jax.profiler trace of the timed render")
    p_render.set_defaults(fn=cmd_render)

    p_opt = sub.add_parser("optimize", help="inverse rendering against a target image")
    _add_common(p_opt)
    p_opt.add_argument("--target", required=True, help="target image path")
    p_opt.add_argument("--steps", type=int, default=100)
    p_opt.add_argument("--lr", type=float, default=1e-2)
    p_opt.add_argument("--checkpoint", default=None)
    p_opt.add_argument("--output", "-o", default=None)
    p_opt.set_defaults(fn=cmd_optimize)

    p_bench = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    _add_common(p_bench)
    p_bench.set_defaults(fn=cmd_bench)

    p_list = sub.add_parser("list-scenes", help="list preset scenes")
    p_list.set_defaults(fn=lambda a: (print("\n".join(
        __import__("cg_raytracer").SCENE_NAMES)), 0)[1])

    args = parser.parse_args(argv)
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
