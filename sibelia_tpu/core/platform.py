"""Backend classification for the compute dispatch decisions.

The pipeline has two implementations of every hot step: a device array
program (JAX/XLA) and a native host kernel.  Device paths run when JAX's
default backend is a GPU; everything else (no accelerator, or an
explicit all-CPU ``JAX_PLATFORMS`` pin) runs the native host kernels.

``device_dispatch()`` centralizes the decision.  ``SIBELIA_TPU_DEVICE=1``
forces device paths on any backend, ``SIBELIA_TPU_DEVICE=0`` forces host
paths.
"""
from __future__ import annotations

import os

# <repo>/.jax_cache: a fixed path, so every run of this checkout finds the
# programs an earlier run compiled (the path is part of the cache key)
_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def backend_name() -> str:
    """JAX's default backend.  Initialization errors propagate: a card
    that fails to come up must not turn into a silent host run."""
    import jax

    return jax.default_backend()


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory: ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it
    itself, and no other directory is configured), else
    ``<repo>/.jax_cache``.  Must run before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    return _CACHE_DIR


# --------------------------------------------------------------------------
# Host<->device round-trip accounting (SIBELIA_TPU_COUNT_SYNCS=1): every
# device-path call site notes its blocking transfers, so a run can show
# that its device path ran and how many round trips it paid.
# --------------------------------------------------------------------------

SYNC_COUNTS: dict = {}


def note_sync(tag: str, n: int = 1) -> None:
    if os.environ.get("SIBELIA_TPU_COUNT_SYNCS") == "1":
        SYNC_COUNTS[tag] = SYNC_COUNTS.get(tag, 0) + n


def device_dispatch() -> bool:
    """True when data-heavy pipeline steps should run on the JAX device."""
    env = os.environ.get("SIBELIA_TPU_DEVICE")
    if env is not None:
        return env != "0"
    # an explicit CPU pin decides without importing (and initializing)
    # jax on the pure-host path
    plist = [p.strip() for p in os.environ.get("JAX_PLATFORMS", "").split(",")
             if p.strip()]
    if plist and all(p == "cpu" for p in plist):
        return False
    return backend_name() == "gpu"
