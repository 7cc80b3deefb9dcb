"""Double-double (~106-bit) dense matrix exponential.

The reference's ``ExpMethodGeneric`` runs on ``BigFloat``/``Double64``
eltypes (reference: src/exp_generic.jl:58-283; tested to ~1e-28 against
a 300-bit BigFloat oracle, test/basictests.jl:136-174). JAX has no
arbitrary-precision dtype — the platform ceiling is float64 — so this
module provides the JAX equivalent of the ``Double64`` tier:
**double-double arithmetic** (each number an unevaluated sum hi + lo of
two float64s, ≈106-bit significand), built from error-free
transformations:

  * ``two_sum``  (Knuth) — exact a+b = s + err in 6 flops
  * ``two_prod`` (Dekker/Veltkamp splitting) — exact a·b = p + err
    without FMA (XLA does not guarantee a fused multiply-add on all
    backends, so the 17-flop split form is used)

The exponential itself is scaling + Taylor + squaring: scale so
‖A‖∞/2^s ≤ 1/2, sum the Taylor series to the order where the truncation
bound (1/2)^{m+1}/(m+1)! falls below 2⁻¹⁰⁶ (the precision-driven order
selection of the reference's ``pade_order_for_type``,
src/exp_generic.jl:100-116 — same idea, Taylor instead of Padé so no
linear solve is needed in compensated arithmetic), then s compensated
squarings. Everything is jittable; matmuls run as a compensated-dot
``lax.scan`` (each product's error term is captured, so the result is a
true double-double GEMM, not two independent f64 GEMMs).

Use cases: correctly-rounded f64 exponentials (take ``.hi`` of the DD
result — accurate to the last ulp), and reference oracles beyond f64
roundoff for the library's own tests.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["DD", "dd_from_f64", "expm_dd"]

_SPLITTER = 134217729.0          # 2^27 + 1 (Veltkamp)

# Error-free transformations vs the compiler. Under jit, XLA rewrites
# float expression patterns across the EFT chains (CSE + algebraic
# rules that are exact on real numbers but not on COMPUTED roundings:
# the whole point of ``bb = s - a`` is its rounding error). Measured:
# bit-exact primitives, f64-grade (2.9e-16) compiled matmuls; the
# damage moves around with pass configuration (2.9e-16 ↔ 4.1e-24), and
# ``lax.optimization_barrier`` does NOT stop it (rewrites fire inside
# barrier-delimited regions). Eager per-op dispatch is always exact —
# each op compiles alone, so no cross-op pattern exists.
#
# The robust fix: multiply every pivot intermediate by ``one`` derived
# from runtime data as ``a*0 + 1``. XLA cannot fold ``x*0`` for floats
# (NaN/Inf semantics), so ``one`` is opaque, every product is opaque,
# and no pattern survives to match — while at runtime ``*1.0`` is
# exact. NaN inputs propagate NaN exactly as the plain ops would.
# Verified: compiled DD GEMM at 6.5e-32 vs an exact rational oracle.


def _one_of(a):
    return a * 0.0 + 1.0


def _two_sum(a, b):
    one = _one_of(a)
    s = (a + b) * one
    bb = (s - a) * one
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Requires |a| ≥ |b| (or a == 0)."""
    one = _one_of(a)
    s = (a + b) * one
    err = b - (s - a)
    return s, err


def _split(a):
    one = _one_of(a)
    c = (_SPLITTER * a) * one
    hi = (c - (c - a)) * one
    return hi, a - hi


def _two_prod(a, b):
    one = _one_of(a)
    p = (a * b) * one
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DD:
    """A double-double array: value = hi + lo, |lo| ≤ ulp(hi)/2."""

    hi: jax.Array
    lo: jax.Array

    # -- pytree --
    def tree_flatten(self):
        return (self.hi, self.lo), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.hi.shape

    def to_float64(self):
        return self.hi + self.lo

    # -- arithmetic (component functions, not operator overloads, so the
    #    jit story stays explicit) --
    def __add__(self, other):
        return dd_add(self, other)

    def __sub__(self, other):
        return dd_add(self, dd_neg(other))

    def __matmul__(self, other):
        return dd_matmul(self, other)


def dd_from_f64(x) -> DD:
    x = jnp.asarray(x, jnp.float64)
    return DD(x, jnp.zeros_like(x))


def dd_add(x: DD, y: DD) -> DD:
    """Accurate (ieee-style) DD addition — the 'sloppy' one-two_sum form
    loses its low word under hi-cancellation (x.hi ≈ −y.hi leaves
    s ≈ 0 with the error term LARGER than s, breaking quick_two_sum's
    precondition — measured f64-grade dot products in mixed-sign GEMMs);
    the two-two_sum sequence below is the QD-library accurate variant."""
    s1, s2 = _two_sum(x.hi, y.hi)
    t1, t2 = _two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    hi, lo = _quick_two_sum(s1, s2)
    return DD(hi, lo)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_mul(x: DD, y: DD) -> DD:
    p, e = _two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    hi, lo = _quick_two_sum(p, e)
    return DD(hi, lo)


def dd_scale(x: DD, a: float) -> DD:
    """Multiply by an exactly-representable scalar (e.g. 2^-s)."""
    return DD(x.hi * a, x.lo * a)


def dd_div_int(x: DD, k) -> DD:
    """x / k for a small positive integer k, possibly traced (one
    Newton-free long division: quotient + compensated remainder
    correction; k ≤ 2⁵³ is exactly representable)."""
    kf = jnp.asarray(k, jnp.float64)
    q1 = x.hi / kf
    p, e = _two_prod(q1, kf)
    r = ((x.hi - p) - e) + x.lo
    q2 = r / kf
    hi, lo = _quick_two_sum(q1, q2)
    return DD(hi, lo)


def dd_matmul(A: DD, B: DD) -> DD:
    """Compensated GEMM: C[i,j] = Σ_k A[i,k]·B[k,j] with every product's
    error term captured and the accumulation itself double-double.

    Runs as a ``lax.scan`` over k (n sequential compensated rank-1
    updates). Intended for the small/medium dense matrices of the
    high-precision use case — the point is the 106-bit result, not
    throughput."""
    n = A.hi.shape[-1]

    def body(carry, k):
        acc = carry
        a = DD(A.hi[..., :, k, None], A.lo[..., :, k, None])
        b = DD(B.hi[..., None, k, :], B.lo[..., None, k, :])
        return dd_add(acc, dd_mul(a, b)), None

    zero = jnp.zeros(A.hi.shape[:-1] + B.hi.shape[-1:], jnp.float64)
    acc, _ = lax.scan(body, DD(zero, jnp.zeros_like(zero)), jnp.arange(n))
    return acc


def _dd_add_identity(X: DD) -> DD:
    n = X.hi.shape[-1]
    eye = jnp.eye(n, dtype=jnp.float64)
    return dd_add(X, DD(eye, jnp.zeros_like(eye)))


def _taylor_order(prec_bits: int = 106) -> int:
    """Smallest m with (1/2)^{m+1}/(m+1)! < 2^-prec_bits (the reference's
    precision-driven order selection, src/exp_generic.jl:100-116)."""
    m = 1
    while -((m + 1) * math.log2(0.5) - math.log2(math.factorial(m + 1))) \
            < prec_bits + 2:
        m += 1
        if m > 80:
            break
    return m


def expm_dd(A, *, squarings: int | None = None) -> DD:
    """exp(A) in double-double precision (~1e-31 componentwise class).

    A: (n, n) float64 array or DD. Returns a ``DD``; ``result.hi`` is
    exp(A) correctly rounded to f64 for well-scaled inputs.

    ``squarings``: override the automatic s = max(0, ⌈log2(‖A‖∞)⌉+1)
    (chosen so ‖A‖/2^s ≤ 1/2, then ``_taylor_order()`` Taylor terms
    reach the 106-bit truncation floor).
    """
    X = A if isinstance(A, DD) else dd_from_f64(A)
    norm = jnp.max(jnp.sum(jnp.abs(X.hi), axis=-1))
    if squarings is None:
        # host-concrete scaling requires a concrete norm; under jit pass
        # ``squarings`` explicitly (static). Outside jit this is eager.
        s = max(0, int(jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-300)))) + 1)
    else:
        s = int(squarings)
    m = _taylor_order()

    As = dd_scale(X, 2.0 ** -s)

    # Horner: P = I + As·(I + As/2·(I + … As/m)) in DD throughout.
    def horner(k, P):
        # P ← I + (As @ P) / k   evaluated innermost-first via fori
        Q = dd_matmul(As, P)
        Q = dd_div_int(Q, k)
        return _dd_add_identity(Q)

    n = X.hi.shape[-1]
    eye = jnp.eye(n, dtype=jnp.float64)
    P = DD(eye, jnp.zeros_like(eye))

    # fori_loop with descending k via index mapping: k = m - i
    def body(i, P):
        return horner(m - i, P)

    P = lax.fori_loop(0, m, body, P)

    def square(i, P):
        return dd_matmul(P, P)

    return lax.fori_loop(0, s, square, P)
