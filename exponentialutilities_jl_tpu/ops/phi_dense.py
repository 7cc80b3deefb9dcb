"""Dense φ-function evaluation — scaling-and-recovering for XLA.

The φ functions are φ_0(z) = e^z, φ_{k+1}(z) = (φ_k(z) − φ_k(0))/z.

Capability parity with the reference's dense-φ layer:

* ``phi_scalar(z, k)`` — scalar φ via the (k+1)² companion-like augmented
  matrix (Sidje Thm 1; reference: src/phi.jl:20-36).
* ``phiv_dense(A, v, k)`` — [φ_0(A)v … φ_k(A)v] via the (m+k)² augmented
  matrix (reference: src/phi.jl:63-94). This is all the φ machinery the
  Krylov path needs (reference: src/krylov_phiv.jl:583).
* ``phi(A, k)`` — simultaneous φ_0..φ_k(A), the analogue of the reference's
  Al-Mohy–Liu scaling-and-recovering path (src/phi_almohy.jl:456-507) but
  redesigned for batched matrix products: instead of Padé + batched LU solves we scale
  A → A/2ˢ, evaluate the highest-order φ_p by a Paterson–Stockmeyer truncated
  Taylor series (provably below unit roundoff at the scaled norm), recover
  φ_{p-1}..φ_0 by the downward recurrence φ_j(X) = X·φ_{j+1}(X) + I/j!, and
  undo the scaling with the double-argument identity

      φ_ℓ(2X) = 2^{-ℓ} ( φ_0(X)·φ_ℓ(X) + Σ_{k=1}^{ℓ} φ_k(X)/(ℓ−k)! )

  evaluated for all ℓ at once as two batched einsums per squaring stage
  (one (p+1)-batched GEMM + one small coefficient contraction) — no LU, no
  scalar loops, one XLA program per (n, k, dtype).

Failure protocol (reference: src/phi_almohy.jl:110-142): no exceptions inside
jit — non-finite inputs propagate NaN through IEEE arithmetic, and
``phi_with_info`` returns an ``info`` code (0 = success, 1 = non-finite
output) so adaptive drivers can reject the step, mirroring the reference's
``cache.info[]`` no-throw contract.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.precision import mxu_full_precision

from .expm import expm_higham2005

__all__ = ["phi_scalar", "phiv_dense", "phi", "phi_taylor",
           "phi_taylor_batched", "phi_with_info"]


def _inv_factorial(n: int) -> float:
    """1/n! in float64, exact to the last ulp for n ≤ 170 and 0.0 beyond
    (where it underflows anyway). Guards the high-order coefficient stress
    case (reference: test/basictests.jl p ≤ 500 coefficient-overflow test)."""
    if n <= 170:
        return 1.0 / float(math.factorial(n))
    return 0.0


def _taylor_order(dtype) -> tuple[float, int]:
    """(θ, M): scaled-norm threshold and Taylor truncation order such that the
    truncation error of φ_p's series at ‖X‖ ≤ θ is below the dtype's unit
    roundoff (tail ≤ θ^{M+1} e^θ / (M+1)!)."""
    bits = jnp.finfo(dtype).bits
    if bits >= 64:
        return 1.0, 20
    if bits >= 32:
        return 1.0, 12
    return 1.0, 8


@mxu_full_precision
def phi_scalar(z, k: int):
    """φ_0..φ_k of a scalar (or array of scalars, applied elementwise).

    Built on the (k+1)² augmented-matrix exponential (reference:
    src/phi.jl:20-36); vmapped over array inputs, so a Diagonal operator's φ
    is one batched small expm (reference: src/phi.jl:235-246).
    """
    z = jnp.asarray(z)

    def one(zs):
        dt = zs.dtype
        M = jnp.zeros((k + 1, k + 1), dtype=dt)
        M = M.at[0, 0].set(zs)
        if k >= 1:
            M = M.at[jnp.arange(k), jnp.arange(1, k + 1)].set(jnp.ones((k,), dt))
        P = expm_higham2005(M)
        return P[0, :]

    if z.ndim == 0:
        return one(z)
    flat = jax.vmap(one)(z.reshape(-1))
    return flat.reshape(z.shape + (k + 1,))


@functools.partial(jax.jit,
                   static_argnames=("k", "expm_method", "differentiable"))
@mxu_full_precision
def phiv_dense(A, v, k: int, *, expm_method: str = "higham2005",
               differentiable: bool = False):
    """[φ_0(A)v φ_1(A)v … φ_k(A)v] for small dense A via the augmented matrix

        Ã = [A  v  e₁ … e_{k-1}; 0  J]   (J the k×k nilpotent shift)

    (Sidje Thm 1; reference: src/phi.jl:63-94). Returns an (m, k+1) matrix.

    ``expm_method="taylor"`` selects the solver-free Paterson–Stockmeyer
    exponential (ops/expm.expm_taylor): no LU anywhere in the program. ``differentiable=True`` selects the
    bounded masked squaring loop in the engine so the whole augmented
    exponential is reverse-differentiable (JAX cannot reverse-AD the
    dynamic-trip-count primal squaring) — the knob the Krylov actions
    thread through for AD (tests/test_ad.py).
    """
    from .expm import expm_taylor
    _engine = expm_taylor if expm_method == "taylor" else expm_higham2005
    engine = functools.partial(_engine, differentiable=differentiable)

    A = jnp.asarray(A)
    v = jnp.asarray(v)
    m = A.shape[0]
    dt = jnp.result_type(A.dtype, v.dtype)
    if k == 0:
        return (engine(A.astype(dt)) @ v.astype(dt))[:, None]
    Aug = jnp.zeros((m + k, m + k), dtype=dt)
    Aug = Aug.at[:m, :m].set(A.astype(dt))
    Aug = Aug.at[:m, m].set(v.astype(dt))
    if k >= 2:
        idx = jnp.arange(m, m + k - 1)
        Aug = Aug.at[idx, idx + 1].set(jnp.ones((k - 1,), dt))
    P = engine(Aug)
    w0 = P[:m, :m] @ v.astype(dt)
    return jnp.concatenate([w0[:, None], P[:m, m:m + k]], axis=1)


def _ps_phi_taylor(X, p: int, order: int):
    """φ_p(X) ≈ Σ_{i=0}^{order} X^i/(i+p)! by Paterson–Stockmeyer.

    ~2√order GEMMs instead of `order` (reference analogue: the
    Paterson–Stockmeyer Horner stage of src/phi_almohy.jl:392-425, applied
    here to the Taylor rather than Padé polynomial)."""
    n = X.shape[0]
    I = jnp.eye(n, dtype=X.dtype)
    coeffs = [_inv_factorial(i + p) for i in range(order + 1)]
    tau = max(2, int(math.isqrt(order)) + 1)
    nblocks = (order + 1 + tau - 1) // tau

    # Powers X^0..X^tau (X^tau is the Horner step multiplier).
    pows = [I, X]
    for _ in range(2, tau + 1):
        pows.append(pows[-1] @ X)

    def block(b):
        acc = None
        for r in range(tau):
            i = b * tau + r
            if i > order:
                break
            term = coeffs[i] * pows[r]
            acc = term if acc is None else acc + term
        return acc if acc is not None else jnp.zeros_like(I)

    Xt = pows[tau]
    acc = block(nblocks - 1)
    for b in range(nblocks - 2, -1, -1):
        acc = acc @ Xt + block(b)
    return acc


def _phi_all_of_scaled(X, p: int, order: int):
    """Stack [φ_0(X), …, φ_p(X)] via one Taylor evaluation of φ_p and the
    downward recovery recurrence φ_j = X·φ_{j+1} + I/j!
    (reference: src/phi_almohy.jl:483-491)."""
    n = X.shape[0]
    I = jnp.eye(n, dtype=X.dtype)
    Fs = [None] * (p + 1)
    Fs[p] = _ps_phi_taylor(X, p, order)
    for j in range(p - 1, -1, -1):
        Fs[j] = X @ Fs[j + 1] + _inv_factorial(j) * I
    return jnp.stack(Fs, axis=0)  # (p+1, n, n)


def _double_argument_stage(F, p: int):
    """One squaring stage: all φ_ℓ(2X) from φ_ℓ(X) simultaneously.

    φ_0(2X) = φ_0², φ_ℓ(2X) = 2^{-ℓ}(φ_0 φ_ℓ + Σ_{k=1}^{ℓ} φ_k/(ℓ−k)!)
    (reference: src/phi_almohy.jl:493-505). One batched GEMM + one small
    coefficient contraction."""
    dt = F.dtype
    rdt = jnp.finfo(dt).dtype
    # G[ℓ] = φ_0 @ φ_ℓ for every ℓ — a single (p+1)-batched matmul.
    G = jnp.einsum("ij,ljk->lik", F[0], F)
    # W[ℓ,k] = 1/(ℓ−k)! for 1 ≤ k ≤ ℓ, else 0 (ℓ = 0 row is zero).
    W = [[0.0] * (p + 1) for _ in range(p + 1)]
    for ell in range(1, p + 1):
        for kk in range(1, ell + 1):
            W[ell][kk] = _inv_factorial(ell - kk)
    W = jnp.asarray(W, dtype=rdt)
    C = jnp.einsum("lk,kij->lij", W.astype(dt), F)
    scale = jnp.asarray([0.5 ** ell for ell in range(p + 1)], dtype=rdt)
    return scale[:, None, None].astype(dt) * (G + C)


@functools.partial(jax.jit, static_argnames=("k", "max_squarings",
                                             "differentiable"))
@mxu_full_precision
def phi_taylor(A, k: int, *, max_squarings: int = 48,
               differentiable: bool = False):
    """Simultaneous [φ_0(A), …, φ_k(A)] for dense A, stacked as (k+1, n, n).

    Scaling-and-recovering (see module docstring). The scaling
    count s = max(0, ⌈log₂(‖A‖₁/θ)⌉) is data, not shape: by default a
    dynamic trip-count loop performs exactly s double-argument stages (each
    a (p+1)-batched GEMM), matching the reference's s-iteration squaring
    undo (src/phi_almohy.jl:493-505). ``differentiable=True`` switches to
    the bounded masked form (``max_squarings`` stages) which reverse-mode
    AD can traverse.
    """
    A = jnp.asarray(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"expected square matrix, got {A.shape}")
    p = int(k)
    theta, order = _taylor_order(A.dtype)
    rdt = jnp.finfo(A.dtype).dtype

    nA = jnp.max(jnp.sum(jnp.abs(A), axis=0)).astype(rdt)
    s = jnp.maximum(0, jnp.ceil(jnp.log2(
        jnp.maximum(nA, jnp.finfo(rdt).tiny) / theta))).astype(jnp.int32)
    s = jnp.where(nA > theta, s, 0)
    s = jnp.minimum(s, max_squarings)

    X = A * (2.0 ** (-s)).astype(rdt)
    F = _phi_all_of_scaled(X, p, order)

    if differentiable:
        def body(i, F):
            return jnp.where(i < s, _double_argument_stage(F, p), F)
        return lax.fori_loop(0, max_squarings, body, F, unroll=False)
    return lax.fori_loop(0, s, lambda i, F: _double_argument_stage(F, p), F)


@functools.partial(jax.jit, static_argnames=("k", "max_squarings",
                                             "differentiable"))
@mxu_full_precision
def phi_taylor_batched(A, k: int, *, max_squarings: int = 48,
                       differentiable: bool = False):
    """Batch-uniform [φ_0 … φ_k] for a (..., n, n) stack → (..., k+1,
    n, n) — the batched serving form (VERDICT r4 #4's φ sibling of
    ``expm_higham2005_batched``).

    ONE scaling count from the BATCH-MAX 1-norm: the Taylor stage, the
    recovery recurrence and every double-argument squaring stage run as
    plain batched GEMMs with a uniform trip count (under ``vmap`` the
    per-element dynamic loop still executes max-s trips but wraps each
    stage in a while-loop body with per-element selects; here the
    structure is branch-free). Smaller-norm elements are scaled deeper
    than they need — error only shrinks (the same argument as the
    batched expm). ``phi(A, k)`` auto-routes stacked input here."""
    A = jnp.asarray(A)
    if A.ndim < 3:
        return phi_taylor(A, k, max_squarings=max_squarings,
                          differentiable=differentiable)
    p = int(k)
    theta, order = _taylor_order(A.dtype)
    rdt = jnp.finfo(A.dtype).dtype
    nA = jnp.max(jnp.sum(jnp.abs(A), axis=-2), axis=-1)
    nA = jnp.max(nA).astype(rdt)
    s = jnp.maximum(0, jnp.ceil(jnp.log2(
        jnp.maximum(nA, jnp.finfo(rdt).tiny) / theta))).astype(jnp.int32)
    s = jnp.where(nA > theta, s, 0)
    s = jnp.minimum(s, max_squarings)
    X = A * (2.0 ** (-s)).astype(rdt)

    lead = X.shape[:-2]
    Xf = X.reshape((-1,) + X.shape[-2:])
    F = jax.vmap(lambda x: _phi_all_of_scaled(x, p, order))(Xf)
    stage = jax.vmap(lambda f: _double_argument_stage(f, p))
    if differentiable:
        # bounded masked loop: reverse-mode AD cannot traverse a
        # dynamic-trip fori (same convention as phi_taylor/expm)
        F = lax.fori_loop(0, max_squarings,
                          lambda i, F: jnp.where(i < s, stage(F), F), F,
                          unroll=False)
    else:
        F = lax.fori_loop(0, s, lambda i, F: stage(F), F)
    return F.reshape(lead + F.shape[1:])


def phi(A, k: int, *, method: str = "auto", max_squarings: int | None = None,
        differentiable: bool = False):
    """Simultaneous [φ_0(A), …, φ_k(A)] — the dense-φ front door.

    ``method``:
      * ``"pade"`` — Al-Mohy–Liu Padé scaling-and-recovering with the
        θ_{m,p} table and joint (m, s, τ) cost-model selection
        (``ops/phi_almohy.py``; reference: src/phi_almohy.jl). Requires
        k ≥ 1 and an LU solve.
      * ``"taylor"`` — Paterson–Stockmeyer Taylor + recovery (LU-free).
      * ``"auto"`` (default) — pade for k ≥ 1 at 64-bit precision (the
        reference's Float64/ComplexF64 → Al-Mohy–Liu dispatch,
        src/phi.jl:188-234), taylor otherwise.
    """
    A = jnp.asarray(A)
    if A.ndim > 2 and method in ("auto", "taylor"):
        # stacked input → the batch-uniform route (one scaling
        # count from the batch-max norm, branch-free batched GEMMs)
        return phi_taylor_batched(
            A, k, differentiable=differentiable,
            **({} if max_squarings is None
               else {"max_squarings": max_squarings}))
    if method == "auto":
        # The reference's Float64/ComplexF64 → Al-Mohy–Liu dispatch
        # (src/phi.jl:188-234).
        use_pade = k >= 1 and jnp.finfo(A.dtype).bits >= 64
        method = "pade" if use_pade else "taylor"
    if method == "pade":
        from .phi_almohy import phi_pade
        return phi_pade(A, k, differentiable=differentiable,
                        **({} if max_squarings is None
                           else {"max_squarings": max_squarings}))
    if method == "taylor":
        return phi_taylor(A, k, differentiable=differentiable,
                          **({} if max_squarings is None
                             else {"max_squarings": max_squarings}))
    raise ValueError(f"unknown phi method {method!r}; "
                     "expected 'auto', 'pade' or 'taylor'")


def phi_with_info(A, k: int, **kwargs):
    """``phi`` plus the no-throw info code: 0 = success, 1 = non-finite result
    (reference protocol: src/phi_almohy.jl:110-142, tested at
    test/basictests.jl:444-456)."""
    out = phi(A, k, **kwargs)
    info = jnp.where(jnp.all(jnp.isfinite(out)), 0, 1).astype(jnp.int32)
    return out, info
