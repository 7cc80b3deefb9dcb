"""Distributed building blocks: mesh helpers + halo-exchange local operators.

The reference is single-process shared-memory (SURVEY.md §2: no MPI/NCCL
anywhere); this layer is the new framework's first-class distributed design.
State vectors and the Krylov basis are **row-partitioned** over a 1-D device
mesh; the small Hessenberg/tridiagonal reduced problem stays replicated
(the reference's host/device split, src/arnoldi.jl:293-296, mapped to
shards/replicated). Collectives:

* Gram–Schmidt dots and norms → one ``psum`` per Krylov step (ops/krylov.py
  ``axis_name`` path — the CGS/CGS2 batched-dot design exists precisely so
  the sharded iteration costs a single all-reduce).
* Stencil (banded) matvec → nearest-neighbor halo exchange via
  ``lax.ppermute``, i.e. neighbor copies over NVLink, never an
  all-gather.

These building blocks are *shard_map-inner* components; user-facing entry
points that close over the mesh live in parallel/krylov.py.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.sparse import BandedOperator
from ..utils.linop import LinearOperator

__all__ = ["make_mesh", "shard_vector", "LocalBandedOperator",
           "shard_banded"]


def make_mesh(n_devices: int | None = None, axis_name: str = "shard") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but only {len(devs)} "
                "device(s) are visible; for a virtual CPU mesh set "
                "XLA_FLAGS=--xla_force_host_platform_device_count=N and "
                "JAX_PLATFORMS=cpu before jax initializes a backend")
        devs = devs[:n_devices]
    return Mesh(devs, (axis_name,))


def shard_vector(x, mesh: Mesh, axis_name: str | None = None):
    """Place a global vector with rows sharded over the mesh axis."""
    axis = axis_name or mesh.axis_names[0]
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


@jax.tree_util.register_pytree_node_class
class LocalBandedOperator(LinearOperator):
    """The per-shard view of a row-partitioned ``BandedOperator``.

    Valid only inside ``shard_map`` over ``axis_name``. ``matvec`` takes the
    local x-shard, exchanges a halo of width h = max|offset| with the two
    ring neighbors via ``lax.ppermute`` (missing neighbors contribute
    zeros — matching the Dirichlet truncation of the global stencil), then
    applies each diagonal as a static slice of the extended vector: zero
    gathers, one neighbor hop each way.

    diags_local: (k, n_local) shard of the global diagonal storage.
    n_global / axis_name / offsets are static.
    """

    def __init__(self, diags_local, offsets, n_global: int, axis_name: str,
                 is_hermitian: bool = False):
        self.diags = jnp.asarray(diags_local)
        self.offsets = tuple(int(o) for o in offsets)
        self.n_global = int(n_global)
        self.axis_name = axis_name
        self.is_hermitian = bool(is_hermitian)
        self.halo = max((abs(o) for o in self.offsets), default=0)

    @property
    def shape(self):
        # The *global* operator size: callers (e.g. `min(m, n)` clamps)
        # reason about the global problem.
        return (self.n_global, self.n_global)

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def nnz(self) -> int:
        return len(self.offsets) * self.n_global

    def matvec(self, x):
        n_local = x.shape[0]
        h = self.halo
        if h > n_local:
            raise ValueError(
                f"halo width {h} exceeds local shard size {n_local}; "
                "use fewer shards or a wider shard")
        ns = lax.psum(1, self.axis_name)
        idx = lax.axis_index(self.axis_name)
        if h > 0 and ns > 1:
            # left_halo[d] = last h entries of shard d-1 (zeros at d=0).
            left = lax.ppermute(x[-h:], self.axis_name,
                                [(d, d + 1) for d in range(ns - 1)])
            # right_halo[d] = first h entries of shard d+1 (zeros at d=ns-1).
            right = lax.ppermute(x[:h], self.axis_name,
                                 [(d + 1, d) for d in range(ns - 1)])
        else:
            left = jnp.zeros((h,), dtype=x.dtype)
            right = jnp.zeros((h,), dtype=x.dtype)
        xe = jnp.concatenate([left, x, right]) if h > 0 else x

        ig = idx * n_local + jnp.arange(n_local)   # global row indices
        y = jnp.zeros_like(x, dtype=jnp.result_type(self.dtype, x.dtype))
        for k, o in enumerate(self.offsets):
            xs = lax.dynamic_slice_in_dim(xe, h + o, n_local)
            valid = (ig + o >= 0) & (ig + o < self.n_global)
            y = y + jnp.where(valid, self.diags[k] * xs, 0)
        return y

    def opnorm_hint(self):
        local = jnp.max(jnp.sum(jnp.abs(self.diags), axis=0))
        return lax.pmax(local, self.axis_name)

    def tree_flatten(self):
        return (self.diags,), (self.offsets, self.n_global, self.axis_name,
                               self.is_hermitian)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], aux[2], is_hermitian=aux[3])


def shard_banded(op: BandedOperator, mesh: Mesh,
                 axis_name: str | None = None):
    """Split a global BandedOperator for a shard_map over ``mesh``.

    Returns ``(diags_sharded, make_local)`` where ``diags_sharded`` is the
    device-placed (k, n) diagonal array (sharded on axis 1) and
    ``make_local(diags_local)`` constructs the per-shard operator inside the
    mapped function.
    """
    axis = axis_name or mesh.axis_names[0]
    n = op.shape[0]
    nshards = mesh.shape[axis]
    if n % nshards:
        raise ValueError(f"n={n} must divide evenly over {nshards} shards")
    diags_sharded = jax.device_put(
        op.diags, NamedSharding(mesh, P(None, axis)))

    offsets, herm = op.offsets, op.is_hermitian

    def make_local(diags_local) -> LocalBandedOperator:
        return LocalBandedOperator(diags_local, offsets, n, axis,
                                   is_hermitian=herm)

    return diags_sharded, make_local
