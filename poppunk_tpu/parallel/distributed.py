"""Multi-host initialisation and hierarchical meshes.

The reference is strictly single-process (SURVEY.md §5.8); scaling the
genome axis across several hosts is this framework's replacement for its
manual batch scripts. Wire-up:

- every host calls :func:`init_distributed` (jax.distributed handshake);
- :func:`pod_mesh` builds a ('q', 'r') mesh whose ``r`` axis is laid out
  within each host (reference sketch shards ride the fast intra-host
  interconnect) and ``q`` across hosts (query batches are data-parallel;
  the only cross-host traffic is the small distance-tile gather);
- the sharded distance path (parallel/dists.py) is topology-agnostic —
  it takes whatever mesh it is given.

Tested two ways: single-process virtual meshes (the driver's dryrun and
most of the suite), and a true two-controller run — two OS processes,
four virtual CPU devices each, gloo collectives between them
(tests/test_distributed.py) — which is the CPU stand-in for a multi-host
cluster and exercises the real cross-process gather path.
"""

import os
import sys

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialise jax.distributed across hosts.

    No-op when single-process (the common case in tests / one-host runs).
    Arguments default from the standard environment variables
    (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    num_processes = num_processes or _env_int("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int(
        "PROCESS_ID")
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    sys.stderr.write(
        f"jax.distributed initialised: process {jax.process_index()} of "
        f"{jax.process_count()}, {jax.local_device_count()} local / "
        f"{jax.device_count()} global devices\n")
    return True


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def pod_mesh(n_q=None):
    """A ('q', 'r') mesh over ALL global devices, r contiguous within each
    process (host-local reference shards; q crosses hosts).

    n_q defaults to the process count, giving each host one query shard
    and an r axis entirely inside its host.
    """
    devices = jax.devices()
    n_dev = len(devices)
    if n_q is None:
        n_q = jax.process_count() if n_dev % jax.process_count() == 0 else 1
    if n_dev % n_q != 0:
        raise ValueError(f"n_q={n_q} must divide device count {n_dev}")
    dev_array = np.asarray(devices).reshape(n_q, n_dev // n_q)
    return Mesh(dev_array, axis_names=("q", "r"))


def is_primary():
    """True on the process that should write output files."""
    return jax.process_index() == 0
