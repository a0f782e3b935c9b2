#!/usr/bin/env python
"""Driver benchmark: prints ONE JSON line with the headline metric.

Headline (BASELINE.json): primary rays/s per device, forward+backward, Cornell
box (mirror) at 1024x1024, vs the reference's forward-only 3.8 M rays/s CPU
baseline (report.pdf Table 2 via BASELINE.md).  The line names the device it
ran on.

The headline differentiates the FULL parameter set (materials + lights +
vertices) — the two-phase structure is gradient-exact for all of it (the
reflected-ray chain is threaded differentiably).  The material-only contract
rides along as ``materials_only_*`` keys: phase 2 can consume the recorded
rays when the vertex term is structurally zero.
"""
import json
import sys


def main() -> int:
    from cg_raytracer.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from cg_raytracer.utils.bench import run_bench

    result = run_bench(scene="cornell_box", width=1024, height=1024,
                       include_bwd=True, iters=3, include_vertex_params=True)
    mat = run_bench(scene="cornell_box", width=1024, height=1024,
                    include_bwd=True, iters=3)
    line = {
        "metric": result["metric"] + " [full-gradient contract]",
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": result["vs_baseline"],
        "materials_only_value": mat["value"],
        "materials_only_vs_baseline": mat["vs_baseline"],
        "device": result["device"],
    }
    if "pct_of_roofline" in result:
        line["pct_of_roofline"] = round(result["pct_of_roofline"], 2)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
