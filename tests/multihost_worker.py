"""Worker process for the 2-process jax.distributed simulation test.

Launched by tests/test_multihost.py with JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID set (the pod-slice launch contract that
``initialize_distributed`` reads).  MUST call initialize before any other JAX
API touches the backend, so keep imports minimal up top.

Each process:
1. initializes the distributed runtime (2 processes x 2 virtual CPU devices),
2. checks the global mesh spans all 4 devices,
3. runs a cross-process collective (sum over a process-sharded global array),
4. renders its ``host_local_rows`` tile and writes it to the scratch dir,
5. process 0 waits for both tiles, assembles them, and verifies the result
   against a single-process full render — the documented no-all-gather
   multi-host output path.
"""
import importlib.util
import os
import sys
import time

import numpy as np

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)

# Importing the cg_raytracer package initializes the XLA backend (module-
# level jnp constants in ops/intersect.py), which must not happen before
# jax.distributed.initialize.  Load the multihost module standalone first.
_spec = importlib.util.spec_from_file_location(
    "mh", os.path.join(REPO, "cg_raytracer", "parallel", "multihost.py"))
_mh = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mh)
initialize_distributed = _mh.initialize_distributed
global_mesh = _mh.global_mesh
host_local_rows = _mh.host_local_rows

initialize_distributed()  # reads the JAX_* env contract

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import cg_raytracer as cgrt  # noqa: E402
from cg_raytracer.models.whitted import render_rows  # noqa: E402


def main(out_dir: str) -> int:
    pid = jax.process_index()
    nproc = jax.process_count()
    assert nproc == 2, f"expected 2 processes, got {nproc}"
    assert len(jax.devices()) == 4 and len(jax.local_devices()) == 2

    mesh = global_mesh()
    assert mesh.devices.size == 4

    # Cross-process collective: global sum of a process-sharded array must see
    # every host's shard (runs over the simulated DCN).
    local = np.full((2,), float(pid + 1), np.float32)  # proc 0 -> 1s, 1 -> 2s
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("rays")), local)
    total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(arr)
    assert float(total) == 6.0, f"cross-process sum {float(total)} != 6.0"

    # Host-local row tile render + file-based assembly (no all-gather).
    h = w = 32
    cfg = cgrt.RenderConfig(width=w, height=h, backend="brute")
    scene = cgrt.load_scene("cornell_box")
    cam = cgrt.Camera.default()
    rows = host_local_rows(h)
    assert (rows.stop - rows.start) == h // 2
    tile = np.asarray(render_rows(scene, cam, cfg, rows))
    np.save(os.path.join(out_dir, f"tile_{pid}.npy"), tile)

    if pid == 0:
        other = os.path.join(out_dir, "tile_1.npy")
        deadline = time.time() + 60
        while not os.path.exists(other):
            if time.time() > deadline:
                raise TimeoutError("peer tile never appeared")
            time.sleep(0.1)
        time.sleep(0.2)  # let the peer's write finish
        full = np.asarray(cgrt.render(scene, cam, cfg))
        img = np.concatenate([tile, np.load(other)], axis=0)
        np.testing.assert_allclose(img, full, atol=1e-6)
        np.save(os.path.join(out_dir, "assembled.npy"), img)
    print(f"proc {pid}: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
