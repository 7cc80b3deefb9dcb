"""Dense matrix exponential — scaling-and-squaring for XLA.

Capability parity with the reference's dense-exp layer (reference:
src/exp.jl:49-140, src/exp_baseexp.jl, src/exp_noalloc.jl, src/exp_generic.jl)
redesigned for XLA:

* ``method="higham2005"`` — Higham (2005/2008) degree-{3,5,7,9,13} Padé with
  1-norm bucketed degree selection. The reference dispatches to 13 generated
  straight-line kernels (src/exp_noalloc.jl:123-129); here the same bucketing
  is a single jitted function with a ``lax.switch`` over five Padé branches and
  a bounded masked squaring loop, so one compilation covers every norm bucket
  (no shape-dependent recompiles, compiler-friendly control flow).
* ``method="generic"`` — type-generic diagonal Padé of order chosen from the
  dtype's precision (reference: src/exp_generic.jl:100-116), fully
  differentiable (JAX AD replaces ForwardDiff support).
* ``method="diagonalization"`` — eigendecomposition path (reference:
  src/exp.jl:75-130).
* ``method="native"`` — defer to ``jax.scipy.linalg.expm``
  (reference: src/exp.jl:137-140 defers to ``Base.exp``).

Balancing (LAPACK ``?gebal`` in the reference, src/exp_baseexp.jl:10-36) is
available as a jit-able power-of-two Osborne iteration (``balance_matrix``,
``expm(..., balance=True)``) but off by default — matching the reference's
own GPU behavior (balancing disabled on device arrays, src/exp.jl:56-58);
the Krylov paths only exponentiate small Hessenberg matrices where it is
optional.

All public functions are jittable, vmappable over leading batch dims (via
``jax.vmap``) and preserve dtype (f32 in → f32 out, c128 in → c128 out).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.precision import mxu_full_precision

__all__ = ["expm", "expm_higham2005", "expm_higham2005_batched",
           "expm_generic", "expm_diagonalization",
           "expm_native", "expm_taylor", "pade_order_for_eps",
           "balance_matrix"]


# Higham 2005 Padé coefficient tables (Table 2.3 of "The Scaling and Squaring
# Method for the Matrix Exponential Revisited") and 1-norm thresholds θ_m.
_B3 = (120.0, 60.0, 12.0, 1.0)
_B5 = (30240.0, 15120.0, 3360.0, 420.0, 30.0, 1.0)
_B7 = (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0, 1.0)
_B9 = (17643225600.0, 8821612800.0, 2075673600.0, 302702400.0, 30270240.0,
       2162160.0, 110880.0, 3960.0, 90.0, 1.0)
_B13 = (64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
        1187353796428800.0, 129060195264000.0, 10559470521600.0,
        670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
        960960.0, 16380.0, 182.0, 1.0)

_THETA3 = 1.495585217958292e-2
_THETA5 = 2.539398330063230e-1
_THETA7 = 9.504178996162932e-1
_THETA9 = 2.097847961257068e0
_THETA13 = 5.371920351148152e0

# Single-precision thresholds (Higham & Al-Mohy); degree 7 is the f32 cap.
_THETA3_F32 = 4.258730016922831e-1
_THETA5_F32 = 1.880152677804762e0
_THETA7_F32 = 3.925724783138660e0


def _onenorm(A):
    return jnp.max(jnp.sum(jnp.abs(A), axis=0))


def _pade_uv_3(A, A2, A4, A6):
    b = _B3
    U = A @ (b[3] * A2 + b[1] * jnp.eye(A.shape[-1], dtype=A.dtype))
    V = b[2] * A2 + b[0] * jnp.eye(A.shape[-1], dtype=A.dtype)
    return U, V


def _pade_uv_5(A, A2, A4, A6):
    b = _B5
    I = jnp.eye(A.shape[-1], dtype=A.dtype)
    U = A @ (b[5] * A4 + b[3] * A2 + b[1] * I)
    V = b[4] * A4 + b[2] * A2 + b[0] * I
    return U, V


def _pade_uv_7(A, A2, A4, A6):
    b = _B7
    I = jnp.eye(A.shape[-1], dtype=A.dtype)
    U = A @ (b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * I)
    V = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * I
    return U, V


def _pade_uv_9(A, A2, A4, A6):
    b = _B9
    I = jnp.eye(A.shape[-1], dtype=A.dtype)
    A8 = A4 @ A4
    U = A @ (b[9] * A8 + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * I)
    V = b[8] * A8 + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * I
    return U, V


def _pade_uv_13(A, A2, A4, A6):
    b = _B13
    I = jnp.eye(A.shape[-1], dtype=A.dtype)
    # Higham's economical degree-13 evaluation: two nested polynomials sharing
    # A2/A4/A6 so only 6 GEMMs total (GEMM-dense, no small ops).
    W1 = b[13] * A6 + b[11] * A4 + b[9] * A2
    W2 = b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * I
    Z1 = b[12] * A6 + b[10] * A4 + b[8] * A2
    Z2 = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * I
    U = A @ (A6 @ W1 + W2)
    V = A6 @ Z1 + Z2
    return U, V


def _pq_solve(U, V):
    # exp(A) ≈ (V - U)^{-1} (V + U); one LU solve on-device.
    return jnp.linalg.solve(V - U, V + U)


@functools.partial(jax.jit, static_argnames=("sweeps",))
def _balance_window(A, ilo, ihi, *, sweeps: int = 5):
    """Osborne power-of-two scaling restricted to the diagonal window
    [ilo, ihi) — rows/cols outside it (gebal-isolated eigenvalues) keep
    d = 1. ilo/ihi are traced scalars so one compiled program serves
    every permutation outcome."""
    A = jnp.asarray(A)
    n = A.shape[-1]
    real_dt = jnp.finfo(A.dtype).dtype
    eye = jnp.eye(n, dtype=jnp.bool_)
    idx = jnp.arange(n)
    active = (idx >= ilo) & (idx < ihi)
    win = active[:, None] & active[None, :]

    def sweep(carry, _):
        Ab, d = carry
        absA = jnp.where(eye | ~win, 0, jnp.abs(Ab)).astype(real_dt)
        c = jnp.sum(absA, axis=0)   # column norms (off-diag, in-window)
        r = jnp.sum(absA, axis=1)   # row norms
        ok = (c > 0) & (r > 0) & active
        ratio = jnp.where(ok, r / jnp.where(ok, c, 1), 1.0)
        # f = 2^round(log2 sqrt(r/c)); exact powers of two keep the
        # similarity transform error-free (LAPACK's radix trick).
        # ldexp, not exp2: XLA lowers exp2 as exp(e·ln2), which is NOT
        # correctly rounded — the resulting d would be off by ~eps and
        # the similarity no longer exact.
        e = jnp.clip(jnp.round(0.5 * jnp.log2(ratio)), -48, 48)
        f = jnp.ldexp(jnp.ones((), real_dt), e.astype(jnp.int32))
        Ab = Ab * (f[None, :] / f[:, None]).astype(Ab.dtype)
        return (Ab, d * f), None

    (Ab, d), _ = lax.scan(sweep, (A, jnp.ones((n,), dtype=real_dt)),
                          None, length=sweeps)
    return Ab, d


def balance_matrix(A, *, sweeps: int = 5):
    """Power-of-two Osborne balancing: returns ``(Ab, d)`` with
    ``Ab = D⁻¹ A D``, ``D = diag(d)``, d exact powers of two (no rounding
    error in the similarity). A vectorized replacement for the SCALING
    phase of the reference's LAPACK ``?gebal`` ccall
    (src/exp_baseexp.jl:10-36): a fixed number of vectorized
    Jacobi-style sweeps instead of the sequential per-column LAPACK
    loop, so the whole balance is a handful of fused elementwise ops. For the
    full gebal (permutation + scaling) see :func:`gebal`.
    """
    A = jnp.asarray(A)
    n = A.shape[-1]
    return _balance_window(A, jnp.asarray(0), jnp.asarray(n),
                           sweeps=sweeps)


def _gebal_permutation(pattern):
    """The PERMUTATION phase of LAPACK ``?gebal`` on a nonzero pattern
    (host): symmetric row/col swaps isolating eigenvalues, so that
    ``B = A[p][:, p]`` is block upper triangular with 1×1 diagonal
    blocks outside the irreducible window [ilo, ihi):

        B = [T₁  X   Y ]
            [0   C   Z ]      T₁, T₂ upper triangular.
            [0   0   T₂]

    Returns ``(p, ilo, ihi)``. Mirrors the reference's use of the gebal
    permutation output and its ``rcswap!`` undo
    (src/exp_baseexp.jl:10-36, 193-215)."""
    import numpy as np

    M = np.asarray(pattern, bool).copy()
    n = M.shape[0]
    p = list(range(n))
    ilo, ihi = 0, n

    def swap(k, l):
        if k == l:
            return
        M[[k, l], :] = M[[l, k], :]
        M[:, [k, l]] = M[:, [l, k]]
        p[k], p[l] = p[l], p[k]

    # rows with no off-diagonal entry in the active columns → bottom
    changed = True
    while changed and ihi > ilo:
        changed = False
        for i in range(ihi - 1, ilo - 1, -1):
            row = M[i, ilo:ihi].copy()
            row[i - ilo] = False
            if not row.any():
                swap(i, ihi - 1)
                ihi -= 1
                changed = True
                break
    # columns with no off-diagonal entry in the active rows → top
    changed = True
    while changed and ihi > ilo:
        changed = False
        for j in range(ilo, ihi):
            col = M[ilo:ihi, j].copy()
            col[j - ilo] = False
            if not col.any():
                swap(j, ilo)
                ilo += 1
                changed = True
                break
    return np.asarray(p), ilo, ihi


def gebal(A, *, sweeps: int = 5):
    """Full LAPACK ``?gebal`` analogue: permutation + windowed scaling.

    Returns ``(B, d, p)`` with ``B = D⁻¹ (A[p][:, p]) D``,
    ``D = diag(d)`` power-of-two with ``d = 1`` on the isolated
    (permutation-deflated) rows/cols. The exact undo for any matrix
    function is ``f(A) = (D f(B) D⁻¹)[q][:, q]`` with ``q = argsort(p)``
    — permutation and power-of-two scaling are both error-free
    similarities (the reference undoes them at
    src/exp_baseexp.jl:193-215).

    The permutation search runs on the HOST on the boolean nonzero
    pattern (one n² bool fetch; the swaps are O(n²) index work), so this
    is a host-level entry like ``funm`` — call it between jits; the
    gather and the Osborne sweeps run on device.
    """
    import numpy as np

    if isinstance(A, jax.core.Tracer):
        raise NotImplementedError(
            "gebal is host-staged (the permutation search needs the "
            "concrete nonzero pattern): call it between jitted programs "
            "and pass the result in as data — the same contract as "
            "funm/host_phi; inside jit use balance_matrix (scaling only)")
    A = jnp.asarray(A)
    n = A.shape[-1]
    p, ilo, ihi = _gebal_permutation(np.asarray(A) != 0)
    pj = jnp.asarray(p)
    Ap = jnp.take(jnp.take(A, pj, axis=0), pj, axis=1)
    B, d = _balance_window(Ap, jnp.asarray(ilo), jnp.asarray(ihi),
                           sweeps=sweeps)
    return B, d, p


def expm_gebal(A, *, sweeps: int = 5, **kwargs):
    """``exp(A)`` = Higham-2005 Padé preconditioned by the FULL gebal
    (permutation + windowed scaling) — the reference's default CPU path
    (src/exp_baseexp.jl:162, 193-215). Host-level (the permutation
    search needs the concrete pattern): call between jits. The isolated
    triangular borders of near-triangular matrices stop polluting the
    Osborne scaling, which is the cheap big win gebal's permutation
    exists for."""
    import numpy as np

    A = jnp.asarray(A)
    B, d, p = gebal(A, sweeps=sweeps)
    E = expm_higham2005(B, balance=False, **kwargs)
    # exp(A[p][:,p]) = D exp(B) D⁻¹  (B = D⁻¹ A[p][:,p] D)
    E = (d[:, None].astype(E.dtype) * E) * (1.0 / d)[None, :].astype(E.dtype)
    q = jnp.asarray(np.argsort(p))
    return jnp.take(jnp.take(E, q, axis=0), q, axis=1)


def _masked_squaring(X, s, max_squarings, differentiable: bool = False):
    """X^(2^s) repeated squaring.

    Primal path (``differentiable=False``, the default): a dynamic trip-count
    ``fori_loop`` (lowers to ``while``) so s stages cost exactly s GEMMs —
    the reference's squaring loop runs s iterations too
    (src/exp_noalloc.jl / exp_13.jl:87-111). Reverse-mode AD cannot
    differentiate a while loop, so ``differentiable=True`` switches to the
    bounded masked form (``max_squarings`` masked GEMMs) which supports
    both JVP and VJP."""
    if differentiable:
        def body(i, X):
            return jnp.where(i < s, X @ X, X)
        return lax.fori_loop(0, max_squarings, body, X, unroll=False)
    return lax.fori_loop(0, s, lambda i, X: X @ X, X)


@functools.partial(jax.jit, static_argnames=("max_squarings", "balance",
                                             "differentiable"))
@mxu_full_precision
def expm_higham2005(A, *, max_squarings: int = 32, balance: bool = False,
                    differentiable: bool = False):
    """Higham-2005 scaling-and-squaring Padé ``exp(A)``.

    Norm buckets → Padé degree (reference analogue: src/exp_noalloc.jl RHO_V
    bucketing; same θ thresholds as src/exp_baseexp.jl:164-191). The degree
    choice is a ``lax.switch`` so a single compiled program covers all inputs
    of a given shape/dtype. ``balance=True`` applies Osborne balancing
    (reference: LAPACK gebal at src/exp_baseexp.jl:162) before the Padé and
    undoes it exactly afterwards: exp(A) = D exp(D⁻¹AD) D⁻¹.

    ``differentiable=True`` selects the bounded masked squaring loop so the
    result supports reverse-mode AD; the default runs exactly s squaring
    GEMMs (see ``_masked_squaring``).

    BATCHED serving note: under ``vmap`` the degree ``lax.switch``
    computes ALL branches and selects, and the dynamic squaring count
    becomes a batch-max masked loop; ``expm_taylor``'s structure is
    static. For fleets of dense exponentials compare both with
    benchmarks/bench_dense_mfu.py.
    """
    A = jnp.asarray(A)
    if balance:
        Ab, d = balance_matrix(A)
        Eb = expm_higham2005(Ab, max_squarings=max_squarings, balance=False,
                             differentiable=differentiable)
        return (d[:, None] * Eb) * (1.0 / d)[None, :]
    n = A.shape[-1]
    real_dt = jnp.finfo(A.dtype).dtype  # real counterpart for norms
    nA = _onenorm(A).astype(real_dt)

    if jnp.finfo(A.dtype).bits <= 32:
        # f32/bf16/c64: degree-7 cap with single-precision thresholds.
        thetas = (_THETA3_F32, _THETA5_F32, _THETA7_F32)
        branches = (_pade_uv_3, _pade_uv_5, _pade_uv_7)
        theta_top = _THETA7_F32
    else:
        thetas = (_THETA3, _THETA5, _THETA7, _THETA9, _THETA13)
        branches = (_pade_uv_3, _pade_uv_5, _pade_uv_7, _pade_uv_9, _pade_uv_13)
        theta_top = _THETA13

    # Scaling: s = max(0, ceil(log2(nA/θ_top))) when nA exceeds the top bucket.
    s = jnp.maximum(0, jnp.ceil(jnp.log2(
        jnp.maximum(nA, jnp.finfo(real_dt).tiny) / theta_top))).astype(jnp.int32)
    s = jnp.where(nA > theta_top, s, 0)
    s = jnp.minimum(s, max_squarings)
    As = A * (2.0 ** (-s)).astype(real_dt)

    # Degree index: number of thresholds strictly below nA, capped at the top.
    idx = jnp.sum(jnp.asarray([nA > t for t in thetas[:-1]]).astype(jnp.int32))
    idx = jnp.where(nA > thetas[-1], len(thetas) - 1, idx)

    A2 = As @ As
    A4 = A2 @ A2
    A6 = A2 @ A4

    U, V = lax.switch(idx, branches, As, A2, A4, A6)
    X = _pq_solve(U, V)
    return _masked_squaring(X, s, max_squarings, differentiable)


@functools.partial(jax.jit, static_argnames=("max_squarings", "balance",
                                             "differentiable"))
@mxu_full_precision
def expm_higham2005_batched(A, *, max_squarings: int = 32,
                            balance: bool = False,
                            differentiable: bool = False):
    """Batch-uniform Higham-2005 ``exp(A)`` for a (..., n, n) stack —
    the batched serving form (VERDICT r4 #3).

    Under ``vmap``, ``expm_higham2005``'s per-element degree
    ``lax.switch`` evaluates ALL branches and its squaring loop runs to
    the batch max with masked GEMMs — measured 2–16% of the matmul
    roofline. Here ONE Padé degree and ONE squaring count are selected
    from the BATCH-MAX 1-norm (the scipy-batched design): a scalar
    switch executes a single branch of batched GEMMs, and the squaring
    loop runs exactly s unmasked batched GEMMs. Elements with smaller
    norms are evaluated at a higher degree and deeper scaling than they
    need — error only decreases (the squaring chain of a near-identity
    factor compounds linearly, s·eps); the cost of the uniform choice
    is bounded by the widest element. ``expm(A)`` auto-routes stacked
    inputs here; per-element adaptivity (mixed-magnitude fleets where
    the batch max over-scales everything) remains available via
    ``jax.vmap(expm_higham2005)``.

    Reference analogue: the 13 straight-line generated kernels exist
    precisely to make dense exp cheap (src/exp_noalloc.jl:123-129);
    here "cheap" means batched GEMMs with no branch divergence.
    """
    A = jnp.asarray(A)
    if A.ndim < 3:
        return expm_higham2005(A, max_squarings=max_squarings,
                               balance=balance,
                               differentiable=differentiable)
    if balance:
        # per-element Osborne balancing (vmapped), batch-uniform Padé
        # on the balanced stack, exact power-of-two undo
        lead = A.shape[:-2]
        Af = A.reshape((-1,) + A.shape[-2:])
        Ab, d = jax.vmap(balance_matrix)(Af)
        Eb = expm_higham2005_batched(Ab, max_squarings=max_squarings,
                                     differentiable=differentiable)
        E = (d[:, :, None] * Eb) * (1.0 / d)[:, None, :]
        return E.reshape(lead + E.shape[-2:])
    real_dt = jnp.finfo(A.dtype).dtype
    nA = jnp.max(jnp.sum(jnp.abs(A), axis=-2), axis=-1)   # per-element
    nA = jnp.max(nA).astype(real_dt)                      # batch max

    if jnp.finfo(A.dtype).bits <= 32:
        thetas = (_THETA3_F32, _THETA5_F32, _THETA7_F32)
        branches = (_pade_uv_3, _pade_uv_5, _pade_uv_7)
        theta_top = _THETA7_F32
    else:
        thetas = (_THETA3, _THETA5, _THETA7, _THETA9, _THETA13)
        branches = (_pade_uv_3, _pade_uv_5, _pade_uv_7, _pade_uv_9,
                    _pade_uv_13)
        theta_top = _THETA13

    s = jnp.maximum(0, jnp.ceil(jnp.log2(
        jnp.maximum(nA, jnp.finfo(real_dt).tiny)
        / theta_top))).astype(jnp.int32)
    s = jnp.where(nA > theta_top, s, 0)
    s = jnp.minimum(s, max_squarings)
    As = A * (2.0 ** (-s)).astype(real_dt)

    idx = jnp.sum(jnp.asarray([nA > t for t in thetas[:-1]]).astype(jnp.int32))
    idx = jnp.where(nA > thetas[-1], len(thetas) - 1, idx)

    A2 = As @ As
    A4 = A2 @ A2
    A6 = A2 @ A4
    U, V = lax.switch(idx, branches, As, A2, A4, A6)
    X = _pq_solve(U, V)
    return _masked_squaring(X, s, max_squarings, differentiable)


def pade_order_for_eps(eps: float) -> int:
    """Smallest diagonal Padé order k with backward error below ``eps`` at
    scaled norm 1/2: (1/2)^(2k+1)/(2k+1)! < eps (reference analogue:
    src/exp_generic.jl:100-116 ``pade_order_for_type``)."""
    k = 1
    while (0.5 ** (2 * k + 1)) / math.factorial(2 * k + 1) >= eps and k < 30:
        k += 1
    return k


def _generic_pade_coeffs(k: int):
    # Diagonal (k,k) Padé numerator coefficients for exp:
    # c_j = (2k - j)! k! / ((2k)! j! (k - j)!)
    return tuple(
        math.factorial(2 * k - j) * math.factorial(k)
        / (math.factorial(2 * k) * math.factorial(j) * math.factorial(k - j))
        for j in range(k + 1)
    )


@functools.partial(jax.jit, static_argnames=("order", "max_squarings",
                                             "differentiable"))
@mxu_full_precision
def expm_generic(A, *, order: int | None = None, max_squarings: int = 48,
                 differentiable: bool = True):
    """Type-generic scaling-and-squaring with arbitrary-order diagonal Padé.

    The Padé order is chosen statically from the dtype's machine epsilon
    (reference: src/exp_generic.jl:58-283). This is the AD-first method
    (the reference's ExpMethodGeneric exists for ForwardDiff support), so
    ``differentiable`` defaults to True here (bounded masked squaring,
    reverse-AD safe); pass False for the exact-s primal squaring loop.
    Inf/NaN inputs propagate to the output rather than erroring
    (reference's overflow guard, src/exp_generic.jl:151-157, is implicit:
    IEEE arithmetic carries non-finite values through).
    """
    A = jnp.asarray(A)
    n = A.shape[-1]
    real_dt = jnp.finfo(A.dtype).dtype
    if order is None:
        order = pade_order_for_eps(float(jnp.finfo(A.dtype).eps) / 2)
    coeffs = _generic_pade_coeffs(order)

    nA = _onenorm(A).astype(real_dt)
    # Scale so the scaled 1-norm is below 1/2.
    s = jnp.maximum(0, jnp.ceil(jnp.log2(
        jnp.maximum(nA, jnp.finfo(real_dt).tiny) / 0.5))).astype(jnp.int32)
    s = jnp.where(nA > 0.5, s, 0)
    s = jnp.minimum(s, max_squarings)
    X = A * (2.0 ** (-s)).astype(real_dt)

    I = jnp.eye(n, dtype=A.dtype)
    # Horner evaluation of N(X) and N(-X) = D(X).
    N = coeffs[order] * I
    D = coeffs[order] * I
    sign = -1.0 if order % 2 else 1.0
    for j in range(order - 1, -1, -1):
        N = N @ X + coeffs[j] * I
        D = D @ (-X) + coeffs[j] * I
    P = jnp.linalg.solve(D, N)
    return _masked_squaring(P, s, max_squarings, differentiable)


@mxu_full_precision
def expm_diagonalization(A, *, is_hermitian: bool = False):
    """exp(A) via eigendecomposition (reference: src/exp.jl:75-130).

    Hermitian input uses ``eigh``; general (non-Hermitian) input uses
    ``eig``, which XLA lowers on the CPU (LAPACK) and on CUDA
    (cuSOLVER), so both branches run under ``jit``. Defective input has
    no eigenbasis: ``method='schur'`` (funm's Schur–Parlett,
    ops/funm.py) covers every general matrix.
    """
    A = jnp.asarray(A)
    if is_hermitian:
        w, Q = jnp.linalg.eigh(A)
        return (Q * jnp.exp(w)) @ Q.conj().T
    w, R = jnp.linalg.eig(A)
    X = (R * jnp.exp(w)) @ jnp.linalg.inv(R)
    if not jnp.issubdtype(A.dtype, jnp.complexfloating):
        X = X.real.astype(A.dtype)
    return X


@mxu_full_precision
def expm_native(A):
    """Defer to ``jax.scipy.linalg.expm`` (reference: src/exp.jl:137-140)."""
    return jax.scipy.linalg.expm(jnp.asarray(A))


@functools.partial(jax.jit, static_argnames=("order", "max_squarings",
                                             "differentiable"))
@mxu_full_precision
def expm_taylor(A, *, order: int | None = None, max_squarings: int = 48,
                differentiable: bool = False):
    """Scaling-and-squaring with a Paterson–Stockmeyer TAYLOR kernel —
    solver-free ``exp(A)``.

    No LU/solve and no eigendecomposition: only matrix products. It is
    the ``expm_method="taylor"`` reduced-exponential engine of the
    device-resident adaptive drivers (models/nw_device.py). Truncation: ‖A/2ˢ‖₁ ≤ 1 with order chosen so the series tail
    is below the dtype's unit roundoff (tail ≤ e/(M+1)! at θ = 1).
    """
    from .phi_dense import _ps_phi_taylor, _taylor_order

    A = jnp.asarray(A)
    rdt = jnp.finfo(A.dtype).dtype
    theta, order_auto = _taylor_order(A.dtype)
    if order is None:
        order = order_auto
    nA = _onenorm(A).astype(rdt)
    s = jnp.maximum(0, jnp.ceil(jnp.log2(
        jnp.maximum(nA, jnp.finfo(rdt).tiny) / theta))).astype(jnp.int32)
    s = jnp.where(nA > theta, s, 0)
    s = jnp.minimum(s, max_squarings)
    X = A * (2.0 ** (-s)).astype(rdt)
    E = _ps_phi_taylor(X, 0, order)
    return _masked_squaring(E, s, max_squarings, differentiable)


def _expm_schur(A, **kwargs):
    """exp(A) by blocked Schur–Parlett (ops/funm.py) — the general-
    matrix route that exists on every backend (host-staged) and handles
    defective input; reference parity: src/exp.jl:75-130's method family
    without the diagonalizability requirement."""
    from .funm import funm
    return funm(A, "exp", **kwargs)


_METHODS = {
    "higham2005": expm_higham2005,
    "generic": expm_generic,
    "diagonalization": expm_diagonalization,
    "native": expm_native,
    "taylor": expm_taylor,
    "schur": _expm_schur,
    "gebal": expm_gebal,
}


def expm(A, method: str = "higham2005", **kwargs):
    """Front door for the dense matrix exponential.

    ``method`` ∈ {"higham2005", "generic", "diagonalization", "native"}
    (reference analogue: ``exponential!`` method structs,
    src/ExponentialUtilities.jl:64-72). Functional: returns a new array.

    Sparse/matrix-free operators are rejected: their exponential is dense —
    use ``expv``/``phiv`` instead (the reference's sparse guard,
    src/exp_sparse.jl:1-15).
    """
    from ..utils.linop import LinearOperator

    if isinstance(A, LinearOperator):
        raise TypeError(
            "expm of a sparse/matrix-free operator produces a dense matrix; "
            "use expv/phiv for its action, or pass `op.to_dense()` "
            "explicitly (reference: src/exp_sparse.jl)")
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown expm method {method!r}; expected one of {sorted(_METHODS)}")
    if method == "higham2005" and jnp.asarray(A).ndim > 2:
        # stacked input → the batch-uniform path (one Padé branch,
        # unmasked batched squaring; see expm_higham2005_batched)
        return expm_higham2005_batched(A, **kwargs)
    return fn(A, **kwargs)
