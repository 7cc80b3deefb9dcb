"""Distributed Krylov actions: row-partitioned ``expv`` / ``phiv`` over a mesh.

The whole Krylov iteration runs inside ONE ``shard_map`` region per call:
the basis V lives row-sharded ((m+1, n_local) per device), the stencil
matvec exchanges halos with its neighbours (parallel/ops.py), every
orthogonalization step costs exactly one ``psum`` (batched CGS dots,
ops/krylov.py), and the m×m reduced problem (tridiagonal eigensolve /
Padé exp) is computed redundantly-replicated on every device — the mesh
mapping of the reference's device/host split (src/arnoldi.jl:293-296:
large O(n) on device, small O(m²) on host).

This is the layer the reference does not have (it is single-process;
SURVEY.md §2 "Parallelism & distributed-communication inventory").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.expv import expv_from_basis
from ..models.phiv import phiv_from_basis
from ..ops.sparse import BandedOperator
from ..ops.stencil import StencilOperator
from .ops import shard_banded, shard_vector
from .stencil import shard_stencil

__all__ = ["expv_sharded", "phiv_sharded", "make_expv_step",
           "expv_chebyshev_sharded"]


def _shard_op(op, mesh: Mesh, axis: str):
    """Dispatch: (params, make_local, param_spec) for a shardable operator."""
    if isinstance(op, BandedOperator):
        params, make_local = shard_banded(op, mesh, axis)
        return params, make_local, P(None, axis)
    if isinstance(op, StencilOperator):
        params, make_local = shard_stencil(op, mesh, axis)
        return params, make_local, P()
    raise TypeError(
        f"no sharding rule for operator type {type(op).__name__}; "
        "use a BandedOperator or StencilOperator (or the GSPMD path, "
        "parallel/gspmd.py)")


def _sharded_call(op, mesh: Mesh, axis_name: str | None, body):
    """Run ``body(local_op, b_local) -> row-sharded result`` under shard_map."""
    axis = axis_name or mesh.axis_names[0]
    params, make_local, pspec = _shard_op(op, mesh, axis)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(pspec, P(axis)),
        out_specs=P(axis))
    def run(params_local, b_local):
        return body(make_local(params_local), b_local)

    return run, params


def expv_sharded(t, op, b, mesh: Mesh, *, m: int = 30,
                 tol: float = 1e-7, iop: int = 0, reorth: bool = True,
                 hermitian: bool | None = None,
                 axis_name: str | None = None, two_pass: bool = False):
    """``exp(tA) b`` with A row-partitioned over ``mesh``.

    ``b`` may be a global (replicated or host) array or already sharded;
    the result is row-sharded the same way. One compiled program covers
    any device count of the same mesh shape. ``two_pass=True`` uses the
    storage-free Lanczos (Hermitian only) — per-shard memory O(n_local)
    instead of O(m·n_local), the scale-out form for huge n.
    """
    from ..models.expv import build_subspace

    axis = axis_name or mesh.axis_names[0]
    herm = op.is_hermitian if hermitian is None else hermitian
    t = jnp.asarray(t)
    if two_pass and not herm:
        raise NotImplementedError("two_pass requires a Hermitian operator")

    def body(lop, b_local):
        if two_pass:
            from ..models.expv import _expv_two_pass
            return _expv_two_pass(lop, b_local, t, m, axis_name=axis)
        Ks = build_subspace(lop, b_local, m, tol=tol, iop=iop,
                            reorth=reorth, hermitian=herm, axis_name=axis)
        return expv_from_basis(t, Ks)

    run, params = _sharded_call(op, mesh, axis, body)
    return run(params, shard_vector(b, mesh, axis))


def phiv_sharded(t, op, b, k: int, mesh: Mesh, *,
                 m: int = 30, tol: float = 1e-7, iop: int = 0,
                 correct: bool = False, reorth: bool = True,
                 hermitian: bool | None = None,
                 axis_name: str | None = None):
    """Row-partitioned ``[φ_0(tA)b … φ_k(tA)b]`` (n, k+1), sharded on rows."""
    from ..models.expv import build_subspace

    axis = axis_name or mesh.axis_names[0]
    herm = op.is_hermitian if hermitian is None else hermitian
    t = jnp.asarray(t)
    params, make_local, pspec = _shard_op(op, mesh, axis)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(pspec, P(axis)),
        out_specs=(P(axis), P()))
    def run(params_local, b_local):
        lop = make_local(params_local)
        Ks = build_subspace(lop, b_local, m, tol=tol, iop=iop,
                            reorth=reorth, hermitian=herm, axis_name=axis)
        w, err = phiv_from_basis(t, Ks, k, correct=correct)
        return w, err

    return run(params, shard_vector(b, mesh, axis))


def expv_chebyshev_sharded(t, op, b, mesh: Mesh, *, bounds=None,
                           tol: float = 1e-7, m: int | None = None,
                           axis_name: str | None = None):
    """Row-partitioned Chebyshev ``exp(tA) b`` (models/chebyshev.py) —
    the ideal sharded action: the recurrence has NO inner products, so
    the per-iteration communication is exactly the operator's halo
    exchange (one ``ppermute`` for banded/stencil) and nothing else.
    The Krylov paths pay one ``psum`` latency per iteration on top;
    here the collective count per iteration is the matvec's alone.

    ``bounds`` defaults to the GLOBAL operator's Gershgorin hint
    (exact for stencil/banded containers — no probe run needed).
    Hermitian only; b may be global or sharded; result is row-sharded.
    """
    import numpy as np

    from ..models.chebyshev import _chebyshev_apply_scan, _full_exp_coeffs

    if not op.is_hermitian:
        raise ValueError("expv_chebyshev_sharded requires a Hermitian "
                         "operator")
    axis = axis_name or mesh.axis_names[0]
    if bounds is None:
        hint = getattr(op, "spectral_bounds_hint", None)
        bounds = hint() if callable(hint) else None
        if bounds is None:
            raise ValueError(
                "no spectral_bounds_hint on this operator — pass "
                "bounds=(lo, hi) explicitly (e.g. from "
                "models.chebyshev.spectral_bounds on the global operator)")
    lo, hi = float(bounds[0]), float(bounds[1])
    if hi - lo <= 0:
        raise ValueError(f"empty spectral interval {bounds}")
    full, c, h = _full_exp_coeffs(t, lo, hi, tol, m)
    b = jnp.asarray(b)
    cdt = jnp.result_type(
        b.dtype, jnp.complex64 if np.iscomplexobj(full) else b.dtype)
    coeffs = jnp.asarray(full, cdt)

    def body(lop, b_local):
        return _chebyshev_apply_scan(lop, b_local, coeffs, c, 1.0 / h)

    run, params = _sharded_call(op, mesh, axis, body)
    return run(params, shard_vector(b, mesh, axis))


def make_expv_step(op, mesh: Mesh, *, m: int = 30,
                   tol: float = 1e-7, hermitian: bool | None = None,
                   axis_name: str | None = None):
    """AOT-style factory: returns ``(step, diags_sharded)`` where
    ``step(t, diags_sharded, b_sharded)`` is the fully jitted sharded expv.

    This is the production-serving shape: one compile, then repeated calls
    with donated/resident shards (the analogue of the reference's
    cache-reuse contract, test/basictests.jl:944-947).
    """
    from ..models.expv import build_subspace

    axis = axis_name or mesh.axis_names[0]
    herm = op.is_hermitian if hermitian is None else hermitian
    params, make_local, pspec = _shard_op(op, mesh, axis)

    @jax.jit
    def step(t, params_, b):
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(pspec, P(axis)),
            out_specs=P(axis))
        def run(params_local, b_local):
            lop = make_local(params_local)
            Ks = build_subspace(lop, b_local, m, tol=tol, hermitian=herm,
                                axis_name=axis)
            return expv_from_basis(t, Ks)
        return run(params_, b)

    return step, params
