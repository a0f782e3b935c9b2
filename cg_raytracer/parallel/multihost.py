"""Multi-host launch support.

Reference capability: none (single process; SURVEY §2 parallelism table).  This is
the framework's multi-host layer: ``jax.distributed.initialize`` turns the same
``Mesh``-based code from parallel/sharding.py into a multi-host program — XLA
routes collectives within a host over NVLink and between hosts over the
network.  Renders are
re-runnable at pixel-tile granularity, so failure recovery = re-run the failed
host's tiles (SURVEY §5 failure-detection row).
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize JAX's distributed runtime (no-op when single-process).

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID when args
    are omitted, mirroring the standard pod-slice launch contract.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return  # single-process run
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "rays"):
    """1-D mesh over every device of every host."""
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def host_local_rows(height: int) -> slice:
    """The image-row slice this host owns under row sharding — for assembling
    outputs without an all-gather (each host writes its own tile to disk)."""
    n = jax.process_count()
    i = jax.process_index()
    per = -(-height // n)
    return slice(i * per, min((i + 1) * per, height))


def render_with_recovery(scene, camera, cfg, tile_rows: int = 64,
                         max_retries: int = 2, key=None, bvh=None,
                         render_tile=None, log_fn=None):
    """Row-tile render loop with re-run-on-failure (SURVEY §5 failure row).

    Renders the frame as ceil(H / tile_rows) independent row tiles via
    ``models.whitted.render_rows``; a tile that raises is re-rendered up to
    ``max_retries`` times before the error propagates.  This is the recovery
    contract of a multi-host render: tiles are pure functions of (scene,
    camera, rows), so a failed/preempted host's rows can be re-run anywhere.

    ``render_tile(rows: slice) -> [k, W, 3]`` overrides the tile renderer
    (used by tests to inject faults, or by a scheduler to route retries to a
    different host).  Returns (image [H, W, 3] np.ndarray, failures) where
    failures is a list of (rows, attempt, error_repr) for every failed attempt
    that was subsequently recovered.
    """
    import numpy as _np

    from ..models.whitted import make_backend, render_rows

    if render_tile is None:
        backend = make_backend(scene, cfg, bvh=bvh)

        def render_tile(rows):
            return render_rows(scene, camera, cfg, rows, backend=backend,
                               key=key)

    img = _np.zeros((cfg.height, cfg.width, 3), _np.float32)
    failures = []
    for start in range(0, cfg.height, tile_rows):
        rows = slice(start, min(start + tile_rows, cfg.height))
        for attempt in range(max_retries + 1):
            try:
                img[rows] = _np.asarray(render_tile(rows))
                break
            except Exception as e:  # noqa: BLE001 — any tile failure retries
                failures.append((rows, attempt, repr(e)))
                if log_fn:
                    log_fn(f"tile rows {rows.start}:{rows.stop} failed "
                           f"(attempt {attempt + 1}/{max_retries + 1}): {e!r}")
                if attempt == max_retries:
                    raise
    return img, failures
