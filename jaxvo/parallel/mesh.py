"""Device-mesh plumbing: the distributed backend the reference never had.

The reference is single-threaded CPU C++ (SURVEY.md §2: no NCCL/MPI/threads
anywhere); scaling here rides ``jax.sharding.Mesh`` + ``shard_map`` with XLA
collectives, which XLA hands to NCCL: NVLink between the GPUs of one host,
the network between hosts — no hand-written transport.

Axes used by the engine:
  * ``lm``   — the landmark/map axis (the CP/sequence-parallel analog):
               sharded matcher columns, sharded BA landmark blocks
  * ``batch``— independent sequences / RANSAC hypothesis groups (DP analog)
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def maybe_distributed_init():
    """Initialize jax.distributed when launched multi-host (no-op otherwise).

    Opt-in via the standard coordinator env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); called at CLI startup.  A failed
    initialization RAISES — a silently single-process run of a job the
    user launched as multi-host would shard nothing and psum with itself.
    """
    global _DIST_INITIALIZED
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr and not _DIST_INITIALIZED:
        # NOTE: must run before anything touches the XLA backend
        # (jax.devices()/process_count() would lock in single-process mode)
        jax.distributed.initialize(
            coordinator_address=addr,
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ["JAX_PROCESS_ID"]),
        )
        _DIST_INITIALIZED = True
    return jax.process_count()


_DIST_INITIALIZED = False


def local_mesh(n_devices: int | None = None, axis: str = "lm") -> Mesh:
    """1-D mesh over (up to) the locally visible devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def mesh_2d(n_batch: int, n_lm: int) -> Mesh:
    """(batch, lm) mesh for combined DP x landmark sharding."""
    devs = np.array(jax.devices()[: n_batch * n_lm]).reshape(n_batch, n_lm)
    return Mesh(devs, ("batch", "lm"))
