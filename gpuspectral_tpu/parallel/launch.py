"""Multi-process launch helpers (SURVEY.md §5.8).

The reference has zero multi-device capability; this build scales with the
standard JAX multi-process recipe:

  * every process runs the SAME program; this module's `initialize()`
    wires `jax.distributed` from explicit arguments — on GPU hosts nothing
    supplies them, so the launcher passes the coordinator address
    (`host:port`), the process count and this process's id,
  * the global (tiles x spp) mesh spans all devices; `shard_map` programs in
    parallel/dist.py are process-count agnostic,
  * scene/BVH load happens per process (replicated arrays), image tiles land
    sharded; `gather_image` pulls the full frame to process 0 only at IO
    time,
  * failure model: JAX multi-process fail-stop + the checkpoint/resume layer
    (io/checkpoint.py) — a crashed long render restarts exactly from the
    running mean (SURVEY.md §5.3-5.4).

Local simulation: `GPUSPECTRAL_FAKE_HOSTS=N` (+ `GPUSPECTRAL_FAKE_HOST_ID`,
`GPUSPECTRAL_COORDINATOR`) with the CPU backend runs N real OS processes
through the same `jax.distributed` + gloo-collectives code paths —
exercised by tests/test_multihost.py (SURVEY.md §4 test strategy).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed.  Pass all three arguments explicitly
    (GPU hosts supply none of them), or simulate several hosts on CPU
    with GPUSPECTRAL_FAKE_HOSTS=N / GPUSPECTRAL_FAKE_HOST_ID=i /
    GPUSPECTRAL_COORDINATOR=host:port (gloo collectives over localhost)."""
    fake = int(os.environ.get("GPUSPECTRAL_FAKE_HOSTS", "0"))
    if fake > 1:
        num_processes = fake
        process_id = int(os.environ["GPUSPECTRAL_FAKE_HOST_ID"])
        coordinator = os.environ.get("GPUSPECTRAL_COORDINATOR", "127.0.0.1:9473")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if num_processes is not None and num_processes <= 1:
        return
    kw = {}
    if coordinator:
        kw["coordinator_address"] = coordinator
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)


def replicate_pytree(mesh: Mesh, tree):
    """Turn host-local (per-process) arrays into fully-replicated *global*
    arrays so shard_map programs accept them under multi-process execution.
    Every process must hold identical values (true for scenes: each host
    loads the same file — the reference's per-host asset loading model)."""
    if jax.process_count() <= 1:
        return tree
    rep = NamedSharding(mesh, P())

    def conv(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, rep, lambda idx: x[idx])

    return jax.tree_util.tree_map(conv, tree)


def global_sharded(mesh: Mesh, value: np.ndarray, spec: P):
    """Build a global array sharded by `spec` from a full host-side value
    (each process materializes only its addressable shards)."""
    value = np.asarray(value)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(value.shape, sh, lambda idx: value[idx])


def pod_mesh(spp_shards: int = 1) -> Mesh:
    """Global (tiles, spp) mesh over every device of every process."""
    devs = jax.devices()
    n = len(devs)
    assert n % spp_shards == 0, (n, spp_shards)
    arr = np.asarray(devs).reshape(n // spp_shards, spp_shards)
    return Mesh(arr, ("tiles", "spp"))


def is_coordinator() -> bool:
    return jax.process_index() == 0


def gather_image(img) -> Optional[np.ndarray]:
    """Pull a (possibly sharded) global image to the coordinator host.
    Returns None on non-coordinator hosts."""
    from jax.experimental import multihost_utils

    if jax.process_count() > 1:
        img = multihost_utils.process_allgather(img, tiled=True)
    if not is_coordinator():
        return None
    return np.asarray(img)
