"""Multi-host process bootstrap (SURVEY.md §2.4/§5 "Distributed
communication backend").

All data movement in this engine is XLA collectives over a Mesh; the only
host-side distributed machinery needed is process bootstrap + checkpoint
coordination, which this module wraps:

  - `initialize()`: jax.distributed.initialize (coordinator address/process
    id from env or args) — after it, jax.devices() spans all hosts and the
    same shard_map code paths (parallel/dist_ba.py) run across hosts, with
    intra-host traffic on NVLink and cross-host on the network; collective timeouts
    surface as errors = the failure-detection signal, recovery = restart
    from the latest checkpoint (slam/checkpoint.py).
  - `is_coordinator()`: gate for writing checkpoints/metrics once.

On a single process (this round's CI and the 8-virtual-device CPU mesh) the
functions are no-ops, so the calling code is identical either way.
"""

from __future__ import annotations

import os

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Initialize multi-process JAX if configured; returns True if a
    multi-process runtime was actually started."""
    addr = coordinator_address or os.environ.get("SLAM_COORDINATOR")
    if addr is None:
        return False
    n = num_processes or int(os.environ.get("SLAM_NUM_PROCESSES", "1"))
    pid = process_id if process_id is not None else int(
        os.environ.get("SLAM_PROCESS_ID", "0"))
    if n <= 1:
        return False
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=n, process_id=pid)
    return True


def is_coordinator() -> bool:
    return jax.process_index() == 0
