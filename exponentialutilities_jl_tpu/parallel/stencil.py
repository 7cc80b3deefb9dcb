"""Row-partitioned stencil operators: plane-halo exchange over the mesh.

The d-D grid is sharded along its outermost axis (axis 0); each shard owns
a contiguous slab of planes. A stencil offset with axis-0 component q
needs up to h0 = max|q| halo planes from each ring neighbor — exchanged
with ``lax.ppermute`` (one neighbor copy; missing neighbors at the global
boundary contribute zeros, which is exactly the Dirichlet truncation).
Within-plane offsets are handled by zero-padding the local slab, same as
the single-device ``StencilOperator``.

This is the scalable form of BASELINE config #5 (10M-row 3-D Laplacian
row-partitioned with halo exchange): per-card traffic is x + y + two
boundary planes, and the halo is not yet overlapped with the interior
compute.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.stencil import StencilOperator
from ..utils.linop import LinearOperator

__all__ = ["LocalStencilOperator", "shard_stencil"]


@jax.tree_util.register_pytree_node_class
class LocalStencilOperator(LinearOperator):
    """Per-shard view of a ``StencilOperator`` sharded on grid axis 0.

    Valid only inside ``shard_map`` over ``axis_name``. The local grid is
    (s0_local, s1, …); matvec exchanges h0 halo planes each way.
    """

    def __init__(self, coeffs, local_shape, offsets, s0_global: int,
                 axis_name: str, is_hermitian: bool = False):
        self.coeffs = jnp.asarray(coeffs)
        self.local_shape = tuple(int(s) for s in local_shape)
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        self.s0_global = int(s0_global)
        self.axis_name = axis_name
        self.is_hermitian = bool(is_hermitian)
        self.h0 = max((abs(off[0]) for off in self.offsets), default=0)

    @property
    def shape(self):
        n = self.s0_global * math.prod(self.local_shape[1:])
        return (n, n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def nnz(self) -> int:
        return len(self.offsets) * self.shape[0]

    def matvec(self, x):
        shape = self.local_shape
        d = len(shape)
        X = x.reshape(shape)
        h0 = self.h0
        if h0 > shape[0]:
            raise ValueError(
                f"axis-0 halo {h0} exceeds local slab depth {shape[0]}")
        ns = lax.psum(1, self.axis_name)
        if h0 > 0 and ns > 1:
            # upper halo: last h0 planes of the previous shard (zeros at 0).
            up = lax.ppermute(X[-h0:], self.axis_name,
                              [(i, i + 1) for i in range(ns - 1)])
            down = lax.ppermute(X[:h0], self.axis_name,
                                [(i + 1, i) for i in range(ns - 1)])
            Xe0 = jnp.concatenate([up, X, down], axis=0)
        else:
            z = jnp.zeros((h0,) + shape[1:], X.dtype)
            Xe0 = jnp.concatenate([z, X, z], axis=0) if h0 else X
        # pad the remaining axes (Dirichlet zeros)
        h = [h0] + [max(abs(off[a]) for off in self.offsets)
                    for a in range(1, d)]
        Xp = jnp.pad(Xe0, [(0, 0)] + [(hh, hh) for hh in h[1:]])
        y = None
        for k, off in enumerate(self.offsets):
            sl = (slice(h0 + off[0], h0 + off[0] + shape[0]),) + tuple(
                slice(h[a] + off[a], h[a] + off[a] + shape[a])
                for a in range(1, d))
            term = self.coeffs[k] * Xp[sl]
            y = term if y is None else y + term
        return y.reshape(-1).astype(jnp.result_type(self.dtype, x.dtype))

    def opnorm_hint(self):
        return jnp.sum(jnp.abs(self.coeffs))

    def tree_flatten(self):
        return (self.coeffs,), (self.local_shape, self.offsets,
                                self.s0_global, self.axis_name,
                                self.is_hermitian)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], aux[2], aux[3],
                   is_hermitian=aux[4])


def shard_stencil(op: StencilOperator, mesh: Mesh,
                  axis_name: str | None = None):
    """Split a StencilOperator for shard_map over ``mesh`` (grid axis 0).

    Returns ``(coeffs, make_local)``: coeffs is the tiny replicated
    coefficient vector, ``make_local(coeffs)`` builds the per-shard
    operator. The state vector must be sharded so each device owns
    s0/nshards contiguous planes (i.e. plain row sharding of the flat
    vector).
    """
    axis = axis_name or mesh.axis_names[0]
    nshards = mesh.shape[axis]
    s0 = op.grid_shape[0]
    if s0 % nshards:
        raise ValueError(
            f"grid axis 0 ({s0}) must divide evenly over {nshards} shards")
    local_shape = (s0 // nshards,) + op.grid_shape[1:]
    coeffs = jax.device_put(op.coeffs, NamedSharding(mesh, P()))
    offsets, herm = op.offsets, op.is_hermitian

    def make_local(c) -> LocalStencilOperator:
        return LocalStencilOperator(c, local_shape, offsets, s0, axis,
                                    is_hermitian=herm)

    return coeffs, make_local
