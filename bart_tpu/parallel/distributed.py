"""Multi-host initialization.

Replacement for the reference's mpiexec/MPICH launch (reference:
BART.py:576-580; SURVEY.md section 2.5): every host runs the same
program; ``init_distributed()`` wires them into one JAX process group,
after which the (chain, wn) mesh spans all hosts' devices and the
identical retrieval code runs unchanged — no process-pair messaging
anywhere.

Launch (per host):

    python -m bart_tpu -c cfg  # with JAX_COORDINATOR_ADDRESS etc. set

or call init_distributed(coordinator, num_processes, process_id).
"""

from __future__ import annotations

import os

__all__ = ["init_distributed", "is_multihost"]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed from explicit arguments or the
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    variables (nothing is discovered: without a coordinator address
    this is a single-process run).  Returns True if a multi-process
    group was formed."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return False
    kwargs = {"coordinator_address": coordinator_address}
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(
            num_processes or os.environ["JAX_NUM_PROCESSES"]
        )
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(
            process_id if process_id is not None
            else os.environ["JAX_PROCESS_ID"]
        )
    jax.distributed.initialize(**kwargs)
    return jax.process_count() > 1


def is_multihost() -> bool:
    import jax

    return jax.process_count() > 1
