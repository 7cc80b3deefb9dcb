"""Al-Mohy–Liu Padé-form simultaneous φ — cost-model parameter selection.

Implements Algorithm 5.1 of Al-Mohy & Liu, "A scaling and recovering
algorithm for the matrix phi-functions" (arXiv:2506.01193): scale A → A/2ˢ,
evaluate the [m/m] diagonal Padé approximant of φ_p at the scaled matrix by
Paterson–Stockmeyer, recover φ_{p-1}..φ_0 by the downward recurrence
R⁽ʲ⁾ = As·R⁽ʲ⁺¹⁾ + I/j!, and undo the scaling with the double-argument
formula — with the paper's θ_{m,p} backward-stability table, the η/α
1-norm-of-powers probes, and the joint (Padé degree m, scaling s,
Paterson–Stockmeyer block τ) cost-model selection.

Reference parity: src/phi_almohy.jl:30-51 (θ table), :270-306 (cost-model
selection), :327-368 (η/α probes + ℓ scaling floor), :392-425
(Paterson–Stockmeyer), :456-507 (in-place driver). The redesign for XLA:

* **Padé coefficients from first principles, exactly.** Instead of porting
  the float-accumulated Berland–Skaflestad–Wright recurrences, the [m/m]
  approximant of φ_p(z) = Σ zⁱ/(i+p)! is computed by solving the Padé
  linear conditions in exact rational arithmetic (`fractions.Fraction`,
  m ≤ 12 so the system is 12×12) at trace time, normalized so D(0) = 1,
  then cached per (m, p). No overflow for any p, bit-exact coefficients.
* **Degree/τ as compiled structure, s as data.** The eight admissible Padé
  degrees m_i = (i+3)²÷8 ∈ {1,2,3,4,6,8,10,12} each fix a static
  Paterson–Stockmeyer structure; the cost-model pick of i is a traced
  scalar driving a ``lax.switch`` over the eight branches, so a single
  compiled program covers every input norm. The scaling count s is data
  and the squaring undo runs exactly s double-argument stages (dynamic
  trip count; a masked bounded loop when ``differentiable=True``).
* **Batched N/D evaluation.** N(As) and D(As) are evaluated together as a
  (2, n, n) stack — every Horner fold is one 2-batched GEMM; the
  final Padé solve is one on-device LU solve with matrix RHS.
* **No-throw failure protocol.** Non-finite inputs propagate NaN through
  the probes (with guards so the traced s and branch index stay valid —
  no possible hang) and the solve; ``phi_pade_with_info`` returns
  info ≠ 0 exactly as the reference's ``cache.info[]`` contract
  (src/phi_almohy.jl:110-142).
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils.precision import mxu_full_precision
from .phi_dense import _double_argument_stage, _inv_factorial

__all__ = ["phi_pade", "phi_pade_with_info"]


# θ_{m,p}: largest 1-norm of the scaled matrix for which the [m/m] Padé
# approximant of φ_p is backward stable to double-precision unit roundoff.
# Published constants: Table 3.1 of Al-Mohy & Liu, arXiv:2506.01193 (rows
# m = 1..20, columns p = 1..10; for p > 7 the paper prescribes the p = 7
# column). Same table as reference src/phi_almohy.jl:30-51.
_PHI_THETA_MP = np.array([
    [1.999463452408407e-5, 3.7631213142601604e-5, 7.366006416045163e-5,
     1.4973317297025854e-4, 3.152443333771182e-4, 6.855209983764435e-4,
     1.5357294906993542e-3, 3.5357368946407606e-3, 8.345789028062234e-3,
     2.013882808928226e-2],
    [3.8062018282832713e-3, 6.090206286125726e-3, 9.869682746779615e-3,
     1.6211831146383013e-2, 2.6984240563843326e-2, 4.54757968381803e-2,
     7.749273259855331e-2, 1.3324895779231027e-1, 2.304625604362521e-1,
     3.988991104549146e-1],
    [3.971636005661334e-2, 5.806968886880692e-2, 8.534220076759817e-2,
     1.2612151517169362e-1, 1.8736524835661617e-1, 2.7955116495245524e-1,
     4.1822735418681667e-1, 6.258702800351991e-1, 9.335970443986562e-1,
     1.1616793320890249e0],
    [1.5442675548312682e-1, 2.1278117034577634e-1, 2.9371996708854947e-1,
     4.0617647304246707e-1, 5.623843002320996e-1, 7.787883505754265e-1,
     1.0464245027100287e0, 1.2572921799132364e0, 1.480350861451984e0,
     1.713871003185325e0],
    [3.7980898016147974e-1, 5.014624976587007e-1, 6.621033824456818e-1,
     8.739858777744354e-1, 1.110828442901451e0, 1.3375805277521873e0,
     1.5770955744229305e0, 1.8273848586096524e0, 2.08673114576671e0,
     2.3536689190936406e0],
    [7.26177195703321e-1, 9.281910159646274e-1, 1.1591052927815408e0,
     1.4012982671152012e0, 1.6570386251184455e0, 1.924026602416338e0,
     2.20029216725632e0, 2.4841706972729956e0, 2.7742685942850143e0,
     3.069426294589578e0],
    [1.1898666361923196e0, 1.4469917284172122e0, 1.7187282676344413e0,
     2.0024009817133357e0, 2.295729523138923e0, 2.5968019781751672e0,
     2.9040336511997444e0, 3.216121483847106e0, 3.531999855119243e0,
     3.8508005672569903e0],
    [1.7605812331512907e0, 2.060907194742016e0, 2.371480030315257e0,
     2.690078917436836e0, 3.014877598333601e0, 3.3443898815994957e0,
     3.677415494646134e0, 4.01299056190377e0, 4.350344448873932e0,
     4.688863279363638e0],
    [2.425818958547233e0, 2.7623053687512256e0, 3.105174730511504e0,
     3.4527057639100476e0, 3.8035234182863555e0, 4.156538184296475e0,
     4.510892686686127e0, 4.865916398054041e0, 5.2210881567935115e0,
     5.57600564043454e0],
    [3.173113456793749e0, 3.5393251225873685e0, 3.9086764034913664e0,
     4.279911937822335e0, 4.652058062541427e0, 5.024366624424222e0,
     5.396268333440519e0, 5.767334816025469e0, 6.1372481669904e0,
     6.505776744744432e0],
    [3.991025201329815e0, 4.3813599805888455e0, 4.772204432206606e0,
     5.162703837030561e0, 5.552220615863406e0, 5.940286915538899e0,
     6.326566605567779e0, 6.710825187972159e0, 7.092906173082131e0,
     7.4727126397309815e0],
    [4.869485489784578e0, 5.279199870248916e0, 5.687344501175957e0,
     6.09339280009268e0, 6.496977936247796e0, 6.8978550856394785e0,
     7.295871912058635e0, 7.690945666690415e0, 8.083045525424248e0,
     8.472179024890941e0],
], dtype=np.float64)
# Only rows m ≤ _PHI_M_MAX = 12 are ever consulted (the cost model caps the
# degree there to bound cond(D_m), paper §4), so rows 13..20 are omitted.

_PHI_M_MAX = 12
# Admissible degrees and their Paterson–Stockmeyer cost index i:
# m_i = (i+3)²÷8 (Fasi's optimal-degree sequence).
_PHI_IMAX = math.ceil(math.sqrt(8 * (_PHI_M_MAX + 1)) - 3) - 1   # = 7
_PHI_DEGREES = tuple((i + 3) ** 2 // 8 for i in range(_PHI_IMAX + 1))


def _phi_theta(m: int, p: int) -> float:
    """θ_{m,p} with the paper's p > 7 rule (p = 7 column reused)."""
    return float(_PHI_THETA_MP[m - 1, min(p, 7) - 1])


def _ps_tau(m: int, i: int) -> int:
    """Paterson–Stockmeyer block size τ for degree m at cost index i:
    the τ ∈ {⌊√2m⌋, ⌈√2m⌉} whose multiplication count
    π_m(τ) = τ−1+2⌊m/τ⌋−2·[τ|m] equals i (Fasi's cost identity; reference:
    src/phi_almohy.jl:296-305)."""
    tau = int(math.floor(math.sqrt(2 * m)))
    pi = tau - 1 + 2 * (m // tau) - 2 * (m % tau == 0)
    if pi != i:
        tau = int(math.ceil(math.sqrt(2 * m)))
    return tau


@functools.lru_cache(maxsize=None)
def _pade_coeffs(m: int, p: int) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """Exact [m/m] diagonal Padé coefficients of φ_p, D(0) = 1 normalized.

    Derived directly from the Padé conditions on the Taylor series
    c_i = 1/(i+p)!:  N(z) − φ_p(z)·D(z) = O(z^{2m+1}) with deg N = deg D = m.
    The order conditions for z^{m+1}..z^{2m} give an m×m linear system for
    d_1..d_m (d_0 = 1), solved in exact rational arithmetic; then
    n_j = Σ_{k=0}^{j} d_k c_{j−k}. Equivalent to the reference's
    renormalized Berland–Skaflestad–Wright recurrences
    (src/phi_almohy.jl:223-264) up to the common normalization, but exact
    for every (m, p) with no overflow.
    """
    c = [Fraction(1, math.factorial(i + p)) for i in range(2 * m + 1)]
    # Solve sum_{k=0}^{m} d_k c_{j-k} = 0 for j = m+1..2m, d_0 = 1.
    M = [[c[j - k] for k in range(1, m + 1)] for j in range(m + 1, 2 * m + 1)]
    rhs = [-c[j] for j in range(m + 1, 2 * m + 1)]
    d_tail = _fraction_solve(M, rhs)
    d = [Fraction(1)] + d_tail
    n = [sum(d[k] * c[j - k] for k in range(0, min(j, m) + 1))
         for j in range(m + 1)]
    return tuple(float(x) for x in n), tuple(float(x) for x in d)


def _fraction_solve(M, rhs):
    """Gaussian elimination with exact rationals (m ≤ 12, host-side,
    evaluated once per (m, p) and cached)."""
    m = len(rhs)
    A = [row[:] + [rhs[i]] for i, row in enumerate(M)]
    for col in range(m):
        piv = next(r for r in range(col, m) if A[r][col] != 0)
        A[col], A[piv] = A[piv], A[col]
        pv = A[col][col]
        A[col] = [x / pv for x in A[col]]
        for r in range(m):
            if r != col and A[r][col] != 0:
                f = A[r][col]
                A[r] = [x - f * y for x, y in zip(A[r], A[col])]
    return [A[r][m] for r in range(m)]


def _log_be_coeff(m: int, p: int) -> float:
    """log of the leading backward-error-series coefficient
    (m+p)!·m!/((2m+p)!·(2m+p+1)!), accumulated in log space so no
    intermediate overflows (paper Eq. (3.4))."""
    r = 0.0
    for j in range(1, m + 1):
        r -= math.log(m + p + j)
    for j in range(1, m + p + 2):
        r -= math.log(m + j)
    return r


def _onenorm(A):
    return jnp.max(jnp.sum(jnp.abs(A), axis=0))


def _normpow_nonneg(B, K: int):
    """Exact ‖Bᴷ‖₁ for entrywise-nonnegative B via K matvecs:
    ‖Bᴷ‖₁ = ‖(Bᵀ)ᴷ·𝟙‖_∞ (reference: src/phi_almohy.jl:311-322)."""
    v = jnp.ones((B.shape[0],), dtype=B.dtype)
    v = lax.fori_loop(0, K, lambda _, v: B.T @ v, v)
    return jnp.max(v)


def _scaling_floor(A, normT, m: int, p: int, phat: int):
    """Scaling floor t(m) from the first backward-error term (paper
    Eq. (3.12); reference ``_phi_ell``, src/phi_almohy.jl:327-343).
    Returns a traced non-negative int32 (0 on non-finite input — never
    throws, the NaN reaches the output instead)."""
    rdt = jnp.result_type(normT, jnp.float32)
    K = 2 * m + p + 1
    delta = (p - 1) * (p - phat) / p + 1 if p > 0 else 1.0
    t0 = jnp.where(normT > 1, jnp.log2(jnp.maximum(normT, 1e-300)), 0.0)
    scalefac = jnp.exp2(t0)
    normTs = normT / scalefac
    c = jnp.exp((_log_be_coeff(m, p)
                 - delta * jnp.log(jnp.maximum(normTs, 1e-300))) / K)
    absA = (c * jnp.abs(A) / scalefac).astype(rdt)
    alpha = _normpow_nonneg(absA, K)
    eps64 = float(np.finfo(np.float64).eps)
    t = jnp.log2(jnp.maximum(2 * alpha / eps64, 1e-300)) / (K - delta) + t0
    ok = jnp.isfinite(t) & (normT > 0)
    t = jnp.where(ok, jnp.maximum(jnp.ceil(t), 0.0), 0.0)
    return t.astype(jnp.int32)


def _select_parameters(A, p: int, max_squarings: int):
    """Joint (branch index i, scaling s) selection by the equivalent-GEMM
    cost model (paper §4; reference: _select_parameters_phi! +
    _phi_select_from_alpha, src/phi_almohy.jl:270-306,345-368).

    Structure (which i, hence m and τ) is decided by traced data feeding a
    ``lax.switch``; everything shape-affecting is static.
    Returns (i_star int32, s int32, normT).
    """
    rdt = jnp.finfo(jnp.result_type(A.dtype, jnp.float32)).dtype
    phat_top = p if _phi_theta(_PHI_M_MAX, p) >= 1 else 0
    r_max = int(math.floor(
        (1 + math.sqrt(1 + 4 * (2 * _PHI_M_MAX + phat_top + 1))) / 2))

    # η_j = ‖A^{j+1}‖₁^{1/(j+1)}, j = 1..r_max → α_r = max(η_r, η_{r+1}).
    etas = []
    P = A @ A
    etas.append(_onenorm(P).astype(rdt) ** (1.0 / 2.0))
    for j in range(2, r_max + 1):
        P = P @ A
        etas.append(_onenorm(P).astype(rdt) ** (1.0 / (j + 1)))
    eta = jnp.stack(etas)
    alpha = jnp.maximum(eta[:-1], eta[1:])          # (r_max - 1,)

    normT = _onenorm(A).astype(rdt)
    tvals = [ _scaling_floor(A, normT, m_i, p,
                             p if _phi_theta(m_i, p) >= 1 else 0)
              for m_i in _PHI_DEGREES ]

    # Cost matrix C[i, r-2] = i + p + s0·(p+1) where s0 is the scaling the
    # α_r bound would require at degree m_i (0 entries = inadmissible).
    rows = []
    for i, m_i in enumerate(_PHI_DEGREES):
        theta = _phi_theta(m_i, p)
        phat_i = p if theta >= 1 else 0
        t = tvals[i].astype(rdt)
        row = []
        for r in range(2, r_max + 1):
            if 2 * m_i + phat_i + 1 >= r * (r - 1):
                a = alpha[r - 2]
                ok = (a > 0) & jnp.isfinite(a)
                s0 = jnp.where(
                    ok, jnp.maximum(jnp.ceil(jnp.log2(
                        jnp.maximum(a, 1e-300) / theta)), t), t)
                row.append(i + p + s0 * (p + 1))
            else:
                row.append(jnp.zeros((), rdt))
        rows.append(jnp.stack(row))
    C = jnp.stack(rows)                              # (8, r_max - 1)

    pos = C > 0
    big = jnp.asarray(np.finfo(np.float64).max / 4, rdt)
    minval = jnp.min(jnp.where(pos, C, big))
    # Reference tie-break: last match in column-major traversal gives i.
    flat = C.T.reshape(-1)                           # column-major of C
    match = (flat == minval) & (flat > 0)
    L = flat.shape[0]
    last = (L - 1) - jnp.argmax(match[::-1].astype(jnp.int32))
    any_match = jnp.any(match)
    i_star = jnp.where(any_match, last % C.shape[0], 0).astype(jnp.int32)
    s_f = (minval - i_star.astype(rdt) - p) / (p + 1)
    s_f = jnp.round(s_f)
    s_ok = jnp.isfinite(s_f) & any_match
    s = jnp.clip(jnp.where(s_ok, s_f, 0.0), 0, max_squarings).astype(jnp.int32)
    return i_star, s, normT


def _ps_eval_nd(As, m: int, tau: int, p: int):
    """Evaluate N(As) and D(As) by Paterson–Stockmeyer in Horner form as a
    single (2, n, n) stack: exactly π_m(τ) = τ−1+2⌊m/τ⌋−2[τ|m] GEMM-stages,
    each Horner fold one 2-batched GEMM (reference:
    _paterson_stockmeyer!, src/phi_almohy.jl:392-425)."""
    n = As.shape[0]
    dt = As.dtype
    Nc, Dc = _pade_coeffs(m, p)
    I = jnp.eye(n, dtype=dt)
    pows = [I, As]
    for _ in range(2, tau + 1):
        pows.append(pows[-1] @ As)
    Pstack = jnp.stack(pows[:tau], axis=0)           # (τ, n, n): As^0..As^{τ-1}
    Atau = pows[tau]

    def block(i):
        # Σ_l coef[i·τ+l]·As^l for both polynomials: one coefficient
        # contraction over the shared power stack.
        lo = i * tau
        hi = min((i + 1) * tau, m + 1)
        W = np.zeros((2, tau))
        for l in range(hi - lo):
            W[0, l] = Nc[lo + l]
            W[1, l] = Dc[lo + l]
        Wj = jnp.asarray(W, dtype=jnp.finfo(dt).dtype).astype(dt)
        return jnp.einsum("bt,tij->bij", Wj, Pstack)

    nu = m // tau
    if m % tau == 0:
        top = jnp.stack([Nc[m] * Atau, Dc[m] * Atau], axis=0)
        ND = top + block(nu - 1)
        inext = nu - 2
    else:
        ND = block(nu)
        inext = nu - 1
    for i in range(inext, -1, -1):
        ND = jnp.einsum("bij,jk->bik", ND, Atau) + block(i)
    return ND[0], ND[1]


def _recover_all(X, As, p: int):
    """[φ_0..φ_p] of the scaled matrix from φ_p = X by the downward
    recurrence φ_j = As·φ_{j+1} + I/j! (reference: src/phi_almohy.jl:483-491)."""
    n = As.shape[0]
    I = jnp.eye(n, dtype=As.dtype)
    Fs = [None] * (p + 1)
    Fs[p] = X
    for j in range(p - 1, -1, -1):
        Fs[j] = As @ Fs[j + 1] + _inv_factorial(j) * I
    return jnp.stack(Fs, axis=0)


def _ns_solve(D, N, max_iters: int = 64):
    """X = D⁻¹N WITHOUT any LU/triangular solve — Newton–Schulz inverse
    iteration Y ← Y(2I − DY) followed by one refinement step on X.

    ``solve="newton"``: the Al-Mohy–Liu Padé path with no LU at all (the
    reference runs its Padé LU, src/phi_almohy.jl:432-446).

    Convergence: D_m(As) is well-conditioned BY DESIGN — the cost model
    caps the Padé degree at m ≤ 12 precisely to bound cond(D) (paper §4)
    — so the identity seed (D(0) = I and ‖As‖ ≤ θ keeps D near I)
    contracts in the common case; otherwise the classical transpose seed
    Y₀ = Dᴴ/(‖D‖₁‖D‖_∞) guarantees ‖I − Y₀D‖ < 1 for any nonsingular D.
    Quadratic convergence doubles correct digits per step; the loop exits
    on residual ≤ 4·eps. Non-finite D exits immediately and propagates
    NaN (the no-throw info protocol)."""
    n = D.shape[0]
    dt = D.dtype
    rdt = jnp.finfo(dt).dtype
    I = jnp.eye(n, dtype=dt)
    n1 = _onenorm(D).astype(rdt)
    ninf = jnp.max(jnp.sum(jnp.abs(D), axis=1)).astype(rdt)
    denom = jnp.maximum(n1 * ninf, jnp.finfo(rdt).tiny)
    Yt = D.conj().T / denom.astype(dt)
    r_eye = _onenorm(I - D).astype(rdt)
    Y0 = jnp.where(jnp.isfinite(r_eye) & (r_eye < 0.9), I, Yt)
    eps = jnp.asarray(jnp.finfo(rdt).eps, rdt)

    def cond(c):
        Y, E, it = c
        r = _onenorm(I - E).astype(rdt)
        return (r > 4 * eps) & (it < max_iters) & jnp.isfinite(r)

    def body(c):
        Y, E, it = c
        Y = Y @ (2.0 * I - E)
        return (Y, D @ Y, it + 1)

    Y, _, _ = lax.while_loop(cond, body,
                             (Y0, D @ Y0, jnp.asarray(0, jnp.int32)))
    X = Y @ N
    # one residual-correction step: washes the last O(eps·κ) of the
    # approximate inverse out of the solution
    return X + Y @ (N - D @ X)


@functools.partial(jax.jit, static_argnames=("k", "max_squarings",
                                             "differentiable", "solve"))
@mxu_full_precision
def _phi_pade_impl(A, k: int, max_squarings: int, differentiable: bool,
                   solve: str = "device"):
    p = int(k)
    A = jnp.asarray(A)
    rdt = jnp.finfo(A.dtype).dtype
    i_star, s, _ = _select_parameters(A, p, max_squarings)
    As = A * (2.0 ** (-s.astype(rdt)))

    branches = []
    for i, m_i in enumerate(_PHI_DEGREES):
        tau_i = _ps_tau(m_i, i)
        def mk(m_b=m_i, tau_b=tau_i):
            def branch(As):
                N, D = _ps_eval_nd(As, m_b, tau_b, p)
                if solve == "newton":
                    return _ns_solve(D, N)
                return jnp.linalg.solve(D, N)
            return branch
        branches.append(mk())
    X = lax.switch(i_star, branches, As)

    F = _recover_all(X, As, p)

    if differentiable:
        def body(i, F):
            return jnp.where(i < s, _double_argument_stage(F, p), F)
        F = lax.fori_loop(0, max_squarings, body, F, unroll=False)
    else:
        F = lax.fori_loop(0, s, lambda i, F: _double_argument_stage(F, p), F)
    return F


def phi_pade(A, k: int, *, max_squarings: int = 64,
             differentiable: bool = False, solve: str = "device"):
    """Simultaneous [φ_0(A), …, φ_k(A)] (stacked (k+1, n, n)) by the
    Al-Mohy–Liu Padé scaling-and-recovering algorithm with joint (m, s, τ)
    cost-model selection — the reference's primary dense-φ path
    (src/phi_almohy.jl).

    ``solve`` picks the Padé denominator engine:
      * ``"device"`` (default) — on-device LU (``jnp.linalg.solve``).
      * ``"newton"`` — solver-free Newton–Schulz inverse (``_ns_solve``).

    Requires k ≥ 1 (the reference's ``_phi_almohy!`` contract); use
    ``expm`` / ``phi`` for k = 0.
    """
    if k < 1:
        raise ValueError("phi_pade requires k >= 1; use expm/phi for k = 0")
    if solve not in ("device", "newton"):
        raise ValueError(f"unknown phi_pade solve {solve!r}; "
                         "expected 'device' or 'newton'")
    return _phi_pade_impl(A, k, max_squarings, differentiable, solve)


def phi_pade_with_info(A, k: int, **kwargs):
    """``phi_pade`` plus the no-throw info code: 0 = success, 1 = non-finite
    result (singular Padé denominator or NaN/Inf input; reference contract:
    src/phi_almohy.jl:110-142,432-446)."""
    out = phi_pade(A, k, **kwargs)
    info = jnp.where(jnp.all(jnp.isfinite(out)), 0, 1).astype(jnp.int32)
    return out, info
