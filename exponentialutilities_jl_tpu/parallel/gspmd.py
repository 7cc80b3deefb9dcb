"""GSPMD auto-sharded path: distribute the ENTIRE stack with sharding
annotations alone.

Complement to the explicit shard_map layer (parallel/krylov.py): place the
operator's arrays and the state vector with row shardings and call the
ordinary single-device APIs (`expv`, `phiv`, `expv_timestep`, `kiops`) —
XLA partitions every jitted program and inserts the collectives itself
(psum for the Gram–Schmidt dots, collective-permute for the stencil rolls).
The host-side adaptive drivers (Niesen–Wright, KIOPS) therefore inherit
multi-chip execution with no distributed-specific code: their device
kernels are jitted functions of sharded arrays.

Use the explicit shard_map path when you need guaranteed communication
shapes (halo-only ppermute); use this path for everything above raw expv —
it is the idiomatic "annotate shardings, let XLA insert collectives"
recipe.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.sparse import BandedOperator, BlockELLOperator, SparseELLOperator
from ..utils.linop import DenseOperator, LinearOperator

__all__ = ["shard_operator"]


def shard_operator(op: LinearOperator, mesh: Mesh,
                   axis_name: str | None = None) -> LinearOperator:
    """Return a copy of ``op`` whose arrays are row-sharded over ``mesh``.

    Pass the result (with a vector sharded via ``shard_vector``) to any
    API in the package; all jitted compute auto-partitions.
    """
    axis = axis_name or mesh.axis_names[0]
    if isinstance(op, BandedOperator):
        diags = jax.device_put(op.diags, NamedSharding(mesh, P(None, axis)))
        return BandedOperator(diags, op.offsets, is_hermitian=op.is_hermitian)
    if isinstance(op, SparseELLOperator):
        sh = NamedSharding(mesh, P(axis, None))
        return SparseELLOperator(jax.device_put(op.data, sh),
                                 jax.device_put(op.cols, sh),
                                 is_hermitian=op.is_hermitian)
    if isinstance(op, BlockELLOperator):
        sh = NamedSharding(mesh, P(axis, None, None, None))
        return BlockELLOperator(
            jax.device_put(op.blocks, sh),
            jax.device_put(op.bcols, NamedSharding(mesh, P(axis, None))),
            is_hermitian=op.is_hermitian)
    if isinstance(op, DenseOperator):
        return DenseOperator(
            jax.device_put(op.A, NamedSharding(mesh, P(axis, None))),
            is_hermitian=op.is_hermitian)
    raise TypeError(f"cannot shard operator of type {type(op).__name__}")
