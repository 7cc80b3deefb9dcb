"""Multi-host entry points: global meshes spanning hosts × cards.

The reference is single-process (SURVEY.md §2: no distributed backend);
this module is the framework's multi-host story, designed around a
two-level network:

* **NVLink** within a host (every card reaches every other at the same
  rate, hundreds of GB/s, µs latency) carries the per-Krylov-step
  collectives: halo ``ppermute`` for the stencil/banded matvec and the one
  Gram–Schmidt ``psum`` per step.
* **The network between hosts** (tens of GB/s, tens of µs latency) must
  NOT sit inside the per-step latency path. Two supported layouts:

  1. ``make_global_mesh`` — one logical row axis spanning every card of
     every host, **process-major ordered** so the 1-D halo exchange's
     neighbor hops stay inside a host except at the host boundary (one
     network hop per host pair per matvec — bandwidth-bound,
     overlappable), while the per-step ``psum`` crosses the network once
     per Lanczos step. Right when a single state vector exceeds one
     host's device memory.
  2. ``make_host_data_mesh`` — 2-D (hosts="data") × (cards="shard"):
     operator rows sharded within a host only; independent right-hand
     sides (or φ orders / time batches) data-parallel across hosts. The
     Krylov body then has NO cross-host collective at all — the
     recommended production layout whenever the state fits one host
     (put the latency-critical axis on NVLink, the embarrassingly
     parallel axis on the network).

``initialize_distributed`` wires up ``jax.distributed`` from explicit
arguments or the standard environment (no-op when single-process). All
mesh constructors work unchanged in a single process — on the virtual
``xla_force_host_platform_device_count`` CPU mesh they emulate the
multi-host shape, so the full program (shardings + collectives) is
compile-validated without a cluster (tests/test_parallel.py,
__graft_entry__).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = ["initialize_distributed", "make_global_mesh",
           "make_host_data_mesh"]


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None) -> bool:
    """Initialize ``jax.distributed`` for a multi-host run.

    Arguments default to the standard cluster environment variables
    (``JAX_COORDINATOR_ADDRESS`` etc.), exactly as
    ``jax.distributed.initialize`` resolves them. Safe to call when
    already initialized or single-process (returns False without
    touching anything in that case).
    """
    # IMPORTANT: do not touch jax.process_count()/devices() first — any
    # backend query initializes XLA and makes jax.distributed.initialize
    # unusable for the rest of the process.
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
        return True
    except (RuntimeError, ValueError) as e:
        if "already" in str(e).lower():
            return False      # launcher initialized it — fine
        if coordinator_address is None and num_processes is None:
            # Single-process (no coordinator configured): run locally.
            return False
        raise                 # a REQUESTED multi-host init must not
                              # silently degrade to N disconnected runs


def _device_grid(n_hosts: int | None):
    """Devices as a (hosts, chips_per_host) ndarray, process-major.

    Multi-process: one row per process (jax.devices() is already
    process-major). Single process: emulate ``n_hosts`` rows by splitting
    the local devices (virtual-mesh testing).
    """
    devs = jax.devices()
    nproc = jax.process_count()
    if nproc > 1:
        if n_hosts is not None and n_hosts != nproc:
            raise ValueError(
                f"n_hosts={n_hosts} but {nproc} processes are attached")
        n_hosts = nproc
    elif n_hosts is None:
        n_hosts = 1
    if len(devs) % n_hosts:
        raise ValueError(
            f"{len(devs)} devices do not divide over {n_hosts} hosts")
    return np.asarray(devs).reshape(n_hosts, -1)


def make_global_mesh(n_hosts: int | None = None,
                     axis_name: str = "shard") -> Mesh:
    """ONE logical row axis over every card of every host (layout 1).

    Process-major ordering means consecutive mesh positions are
    consecutive cards of one host: a 1-D nearest-neighbor halo exchange
    leaves the host only at host boundaries. Drop-in wherever a 1-D mesh is
    accepted (``expv_sharded``, ``make_expv_step``, ``shard_operator``).
    """
    grid = _device_grid(n_hosts)
    return Mesh(grid.reshape(-1), (axis_name,))


def make_host_data_mesh(n_hosts: int | None = None,
                        data_axis: str = "data",
                        shard_axis: str = "shard") -> Mesh:
    """2-D (hosts → ``data``) × (cards → ``shard``) mesh (layout 2).

    Shard operator rows over ``shard`` (within a host), batch independent
    RHS / workloads over ``data`` (across hosts). With ``expv_batched`` /
    ``shard_operator`` this runs the whole Krylov iteration without any
    cross-host collective in the loop body.
    """
    grid = _device_grid(n_hosts)
    if grid.shape[0] == 1 and jax.process_count() == 1 and n_hosts is None:
        # Single host: still return a 2-D mesh (1, chips) so callers are
        # layout-independent.
        pass
    return Mesh(grid, (data_axis, shard_axis))
