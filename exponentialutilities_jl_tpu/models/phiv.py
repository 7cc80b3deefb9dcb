"""Krylov φ-function actions: ``phiv(t, A, b, k) ≈ [φ_0(tA)b … φ_k(tA)b]``.

Capability parity with the reference's phiv layer (reference:
src/krylov_phiv.jl:471-599): reduce to ``phiv_dense`` on the masked t·H_m
(the (m+k)² augmented-matrix exponential), combine with the basis by a matmul,
optionally apply the Niesen–Wright last-Arnoldi-vector correction (formula
(10) of arXiv:0907.4631) and return the a-posteriori error estimate
``|β · h_{m+1,m} · t · C2[end, end]|`` used by the adaptive drivers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.precision import mxu_full_precision

from ..ops.krylov import KrylovBasis
from ..ops.phi_dense import phiv_dense
from ..utils.linop import LinearOperator, aslinearoperator
from .expv import build_subspace

__all__ = ["phiv", "phiv_from_basis", "make_phiv"]


@functools.partial(jax.jit, static_argnames=("k", "correct"))
@mxu_full_precision
def _phiv_combine(t, Ks: KrylovBasis, C2, k: int, correct: bool):
    """Basis combination + correction + error estimate, given the (m, k+1)
    reduced-φ columns C2."""
    m = Ks.m
    t = jnp.asarray(t)
    dt = C2.dtype
    beta = Ks.beta.astype(dt)
    w = jnp.einsum("mk,mn->nk", C2, Ks.V[:m].astype(dt)) * beta

    # Indices of the "last" effective row: the reference's H[end, end] is the
    # residual β_m = H[m_used, m_used-1]; C2[end, :] is row m_used-1.
    last = jnp.maximum(Ks.m_used - 1, 0)
    h_res = Ks.H[last + 1, last].astype(dt)
    c_last = C2[last, :]                              # (k+1,)
    betah = beta * h_res * t.astype(dt)

    if correct and k >= 1:
        # w[:, i] += βh·C2[end, i+1]·v_last for i = 0..k-1 (reference:
        # src/krylov_phiv.jl:588-596, Niesen-Wright (10)).
        vlast = Ks.V[Ks.m_used].astype(dt)            # (n,)
        coeffs = jnp.concatenate([c_last[1:], jnp.zeros((1,), dt)]) * betah
        w = w + vlast[:, None] * coeffs[None, :]

    err = jnp.abs(betah * c_last[k])
    zero = Ks.beta > 0
    w = jnp.where(zero, w, jnp.zeros_like(w))
    err = jnp.where(zero, err, jnp.zeros_like(err))
    return w, err


@functools.partial(jax.jit, static_argnames=("k", "correct", "differentiable"))
@mxu_full_precision
def _phiv_from_basis_device(t, Ks: KrylovBasis, k: int, correct: bool,
                            differentiable: bool = False):
    m = Ks.m
    t = jnp.asarray(t)
    dt = jnp.result_type(Ks.V.dtype, Ks.H.dtype, t.dtype)
    Hm = (t.astype(dt) * Ks.H[:m, :m].astype(dt))
    e1 = jnp.zeros((m,), dtype=dt).at[0].set(1)
    C2 = phiv_dense(Hm, e1, k, differentiable=differentiable)  # (m, k+1)
    return _phiv_combine(t, Ks, C2, k, correct)


def phiv_from_basis(t, Ks: KrylovBasis, k: int, *, correct: bool = False,
                    reduced: str = "device", differentiable: bool = False):
    """``(w, err)`` from a prebuilt basis (reference: ``_phiv!``,
    src/krylov_phiv.jl:566-599).

    w: (n, k+1) matrix of φ_j(tA)b columns. err: scalar error estimate for
    φ_{k-1} (the reference's adaptive-driver signal). ``reduced="host"``
    stages the small augmented exponential on the host in full f64 between
    the jitted device programs (ops/host_reduced.py).
    """
    if reduced == "host":
        from ..ops.host_reduced import host_phiv_e1
        m = Ks.m
        C2 = host_phiv_e1(Ks.H[:m, :m], t, k)
        return _phiv_combine(t, Ks, C2, k, correct)
    return _phiv_from_basis_device(t, Ks, k, correct, differentiable)


@functools.partial(jax.jit, static_argnames=("k", "m", "tol", "iop",
                                             "reorth", "hermitian", "correct"))
def _phiv_fused(op, t, b, k: int, m: int, tol: float, iop: int,
                reorth: bool, hermitian: bool, correct: bool):
    Ks = build_subspace(op, b, m, tol=tol, iop=iop, reorth=reorth,
                        hermitian=hermitian)
    return _phiv_from_basis_device(t, Ks, k, correct)


def make_phiv(op, k: int, *, m: int = 30, tol: float = 1e-7, iop: int = 0,
              reorth: bool = True, hermitian: bool | None = None,
              correct: bool = False):
    """Production-serving factory: ``fn(t, b) -> (w, err)`` fused into ONE
    compiled program (see ``make_expv``)."""
    from ..utils.linop import aslinearoperator as _aslo
    op = _aslo(op) if not isinstance(op, LinearOperator) else op
    m_ = min(m, op.shape[0])
    herm = op.is_hermitian if hermitian is None else hermitian

    def fn(t, b):
        return _phiv_fused(op, t, jnp.asarray(b), k, m_, tol, iop, reorth,
                           herm, correct)

    return fn


def phiv(t, A, b, k: int, *, m: int = 30, tol: float = 1e-7, iop: int = 0,
         correct: bool = False, errest: bool = False, reorth: bool = True,
         hermitian: bool | None = None, reduced: str = "device",
         two_pass: bool = False, differentiable: bool = False):
    """Compute ``[φ_0(tA)b … φ_k(tA)b]`` with a Krylov approximation
    (reference: ``phiv``, src/krylov_phiv.jl:519-531). ``k ≥ 1``.

    Returns the (n, k+1) matrix, or ``(w, err)`` when ``errest=True``.
    ``differentiable=True`` makes the reduced augmented exponential
    reverse-AD-safe (bounded masked squaring; same convention as ``expm``);
    device reduced path only (tests/test_ad.py).
    """
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    b = jnp.asarray(b)
    from ..ops.sparse import hoist_conjugation
    op, b, post = hoist_conjugation(op, b)
    if post is not None:
        # sorted-conjugated container → solve in the sorted basis
        # (every φ_k commutes with the conjugation)
        out = phiv(t, op, b, k, m=m, tol=tol, iop=iop, correct=correct,
                   errest=errest, reorth=reorth, hermitian=hermitian,
                   reduced=reduced, two_pass=two_pass,
                   differentiable=differentiable)
        if errest and isinstance(out, tuple):
            return (post(out[0]),) + out[1:]
        return post(out)
    m = min(m, op.shape[0])
    if two_pass:
        herm = op.is_hermitian if hermitian is None else hermitian
        if not herm:
            raise NotImplementedError(
                "two_pass phiv requires a Hermitian operator (Lanczos)")
        if reduced == "host":
            w, err = _phiv_two_pass_host(op, b, t, m, k)
        else:
            w, err = _phiv_two_pass(op, b, t, m, k)
        return (w, err) if errest else w
    Ks = build_subspace(op, b, m, tol=tol, iop=iop, reorth=reorth,
                        hermitian=hermitian)
    w, err = phiv_from_basis(t, Ks, k, correct=correct, reduced=reduced,
                             differentiable=differentiable)
    return (w, err) if errest else w


def _phiv_two_pass_host(op, b, t, m: int, k: int):
    """Two-pass φ-actions with the reduced augmented exponential
    host-staged in f64 (``reduced="host"``)."""
    import numpy as np

    from ..ops.host_reduced import host_phiv_e1
    from ..ops.krylov import lanczos_coeffs, lanczos_replay

    b = jnp.asarray(b)
    alphas, betas, beta0, m_used, broke = lanczos_coeffs(op, b, m)
    a_h = np.asarray(alphas, np.float64)
    b_h = np.asarray(betas, np.float64)
    T = np.diag(a_h) + np.diag(b_h[:-1], 1) + np.diag(b_h[:-1], -1)
    C2 = np.asarray(host_phiv_e1(T, t, k))            # (m, k+1) f64→dtype
    coeffs = jnp.asarray(C2 * float(beta0), b.dtype)
    w = lanczos_replay(op, b, coeffs, alphas, betas, m)
    ju = int(m_used)
    last = max(ju - 1, 0)
    h_res = float(b_h[min(ju, m - 1)]) if ju < m else float(b_h[m - 1])
    err = jnp.asarray(abs(float(beta0) * h_res * float(np.asarray(t))
                          * C2[last, k]))
    zero = beta0 > 0
    w = jnp.where(zero, w, jnp.zeros_like(w))
    err = jnp.where(zero, err, jnp.zeros_like(err))
    return w, err


@functools.partial(jax.jit, static_argnames=("m", "k", "axis_name"))
def _phiv_two_pass(op, b, t, m: int, k: int, axis_name: str | None = None):
    """Storage-free Hermitian φ-actions: (w (n, k+1), err) without the
    (m+1, n) basis — pass 1 records the Lanczos (α, β), the reduced
    augmented exponential gives per-order combination coefficients, pass 2
    regenerates the basis vectors and accumulates all k+1 columns at once
    (same rationale as models/expv._expv_two_pass)."""
    from ..ops.krylov import lanczos_coeffs, lanczos_replay

    b = jnp.asarray(b)
    t = jnp.asarray(t)
    alphas, betas, beta0, m_used, broke = lanczos_coeffs(
        op, b, m, axis_name=axis_name)
    dt = jnp.result_type(b.dtype, t.dtype)
    T = (jnp.diag(alphas) + jnp.diag(betas[:-1], 1)
         + jnp.diag(betas[:-1], -1)).astype(dt)
    e1 = jnp.zeros((m,), dtype=dt).at[0].set(1)
    C2 = phiv_dense(t.astype(dt) * T, e1, k)          # (m, k+1)
    coeffs = C2 * beta0.astype(dt)                     # (m, k+1)
    w = lanczos_replay(op, b, coeffs, alphas, betas, m,
                       axis_name=axis_name)             # (n, k+1), one pass

    last = jnp.maximum(m_used - 1, 0)
    h_res = jnp.where(m_used < m, betas[jnp.minimum(m_used, m - 1)],
                      betas[m - 1]).astype(dt)
    err = jnp.abs(beta0.astype(dt) * h_res * t.astype(dt) * C2[last, k])
    zero = beta0 > 0
    w = jnp.where(zero, w, jnp.zeros_like(w))
    err = jnp.where(zero, err, jnp.zeros_like(err))
    return w, err
