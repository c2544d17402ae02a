"""Multi-process attach (SURVEY.md §5.8).

The reference scales with MPI ranks; here a multi-process run is the same
program started once per process with ``initialize()`` called first — JAX
then exposes every device of every process through ``jax.devices()`` and
the standard domain mesh (gcm_tpu.parallel.sharding) spans processes
transparently, with XLA routing the halo collectives between them.

Single-process runs: ``initialize()`` is a no-op.
"""

from __future__ import annotations

import os
from typing import Optional


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed for a multi-process run.

    Explicit arguments win; without ``coordinator``, the environment's
    ``COORDINATOR_ADDRESS`` names it. With neither this is a no-op.
    Returns True if distributed mode was entered.
    """
    import jax

    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return True


def process_info():
    import jax

    return {"process_index": jax.process_index(),
            "process_count": jax.process_count(),
            "local_devices": len(jax.local_devices()),
            "global_devices": len(jax.devices())}
