"""Multi-process runtime layer (SURVEY §2e row 1).

The reference has no distributed runtime at all (fork/exec + temp files,
C-Sibelia.py:289,556); this framework introduces one:

  * ``init_distributed()`` — `jax.distributed.initialize` from env or
    args, so N processes form a single SPMD program.  Env:
    SIBELIA_TPU_COORD (host:port), SIBELIA_TPU_NPROCS,
    SIBELIA_TPU_PROC_ID, and optionally SIBELIA_TPU_LOCAL_DEVICES (the
    card ids this process owns, comma-separated).  A no-op when unset
    (single-process).
  * ``host_chip_mesh()`` — the ('host', 'chip') mesh over all global
    devices, process-major: row h holds process h's devices.
  * ``seq_mesh()`` — the flat 1-axis mesh the sharded enumeration uses;
    identical (process-major) device order.

Each process owns its own cards: a JAX process reserves most of the
memory of every card it can see, so N processes sharing a host must not
all open every card.  By default process p takes card p modulo the
host's card count (one process per card).

Multi-process behavior is CI-testable without a cluster: N processes on
one machine, each with XLA_FLAGS=--xla_force_host_platform_device_count=C,
form an N*C-device CPU mesh (tests/test_multihost.py; SURVEY §4).
"""
from __future__ import annotations

import glob
import os

import numpy as np

import jax
from jax.sharding import Mesh

_NVIDIA_CARDS = "/dev/nvidia[0-9]*"  # one device node per card


def local_device_ids(process_id: int) -> list[int] | None:
    """Cards this process owns: SIBELIA_TPU_LOCAL_DEVICES if set, else
    card (process_id mod card count) on an NVIDIA host, else None (no
    cards to split, e.g. a CPU-only host)."""
    env = os.environ.get("SIBELIA_TPU_LOCAL_DEVICES")
    if env:
        return [int(x) for x in env.split(",")]
    n_cards = len(glob.glob(_NVIDIA_CARDS))
    return [process_id % n_cards] if n_cards else None


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize the multi-process JAX runtime.  Returns True when a
    multi-process runtime was started, False for single-process runs."""
    coordinator = coordinator or os.environ.get("SIBELIA_TPU_COORD")
    if num_processes is None:
        num_processes = int(os.environ.get("SIBELIA_TPU_NPROCS", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("SIBELIA_TPU_PROC_ID", "-1") or -1)
    if not coordinator or num_processes <= 1 or process_id < 0:
        return False
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids(process_id))
    return True


def host_chip_mesh(n_hosts: int | None = None,
                   chips_per_host: int | None = None) -> Mesh:
    """('host', 'chip') mesh over all global devices, process-major.

    jax.devices() orders devices by owning process, so row h of the mesh
    holds process h's devices: collectives on the 'chip' axis stay inside
    one process, only the 'host' axis crosses processes."""
    devs = jax.devices()
    if n_hosts is None:
        n_hosts = jax.process_count()
    if chips_per_host is None:
        chips_per_host = len(devs) // n_hosts
    grid = np.asarray(devs[:n_hosts * chips_per_host]).reshape(
        n_hosts, chips_per_host)
    return Mesh(grid, ("host", "chip"))


def seq_mesh(n_devices: int | None = None) -> Mesh:
    """Flat sequence-shard mesh over global devices (process-major order:
    neighbor shards share a process except at process boundaries)."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.asarray(devs[:n_devices]), ("seq",))
