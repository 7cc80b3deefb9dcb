"""Faber-series actions on a field-of-values ELLIPSE — the non-Hermitian
polynomial path without the Newton-basis conditioning cap.

The Leja module (models/leja.py) interpolates at real Leja points; its
Newton basis conditions the per-substep parameter z = |t|·s to ≲ 150
(measured envelope in its docstring), so stiff horizons substep linearly
in t·s past that. This module replaces the Newton basis with the FABER
basis of an ellipse enclosing the numerical range (field of values):

    E = { c + α·cosθ + i·β·sinθ },  c real, α ≥ β ≥ 0.

Under the exterior (Joukowski) map ψ(w) = c + γ(w + ρ/w), with
γ = (α+β)/2 and ρ = (α−β)/(α+β) ∈ [0, 1], the Faber polynomials of E are

    F_0 = 1,   F_k(ψ(w)) = w^k + ρ^k w^{−k}   (k ≥ 1),

which satisfy the Chebyshev-like three-term recurrence

    F_1(z) = (z − c)/γ,   F_{k+1}(z) = ((z − c)/γ)·F_k(z) − ρ·F_{k−1}(z)

(with the k = 1 step applied to 2·F_0; degenerate cases: β = 0 → ρ = 1
recovers 2·T_k on the interval — the Chebyshev module; β = α → ρ = 0
gives the monomial/Taylor basis on a disk). The payoff over Newton:
‖F_k‖_E = max_θ |w^k + ρ^k w^{−k}| ≤ 1 + ρ^k ≤ 2 (Kövari–Pommerenke for
convex domains gives the same 2), and for FoV(A) ⊆ E Crouzeix's theorem
bounds ‖F_k(A)‖ ≤ (1+√2)·2 — the recurrence iterates NEVER grow with the
degree, so one substep can carry z in the many-hundreds (tested ≥ 500)
where the Newton form has long lost the connection between its a-priori
tail bound and the achieved error.

Coefficients: f(z) ≈ a_0·F_0 + Σ_{k≥1} a_k·F_k with a_k the w^k Laurent
coefficient of f(ψ(w)) on |w| = 1 — one FFT of f sampled on the circle.
(For the ellipse, ψ(w) = ψ(ρ/w) forces the w^{−k} coefficient to equal
ρ^k·a_k, so the truncated Faber sum reproduces BOTH Laurent tails; this
is why the plain FFT rule is exact rather than an approximation of the
Faber integral.) The uniform tail bound is Σ_{k>m} |a_k|·(1 + ρ^k) — the
same sup-norm-weighted truncation protocol as the Leja module, with the
same raise-on-non-convergence contract.

The ellipse comes from ``fov_ellipse``: Hermitian/skew split A = H + S,
real extent from H (Gershgorin on containers, eigvalsh on dense), imaginary
half-extent from S (Gershgorin of S/i, zero diagonal). This encloses the
numerical range W(A) ⊆ [min λ(H), max λ(H)] × i·[−β, β] exactly
(W(A)'s projections ARE the extreme eigenvalues of H and S/i).

Reference context: like the Leja module this is "beyond" layer — the
reference's non-Hermitian action is Arnoldi (src/arnoldi.jl:285-364); the
reduction-free recurrence needs no per-step inner products
(cf. models/chebyshev.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils.linop import LinearOperator, aslinearoperator
from ..utils.precision import mxu_full_precision
from .leja import _truncate_dd, real_interval

__all__ = ["expv_faber", "phiv_faber", "phiv_timestep_faber",
           "fov_ellipse", "faber_coeffs"]

_MAX_DEGREE = 4096      # compile-size cap per substep, not a stability cap


def _banded_hs_gershgorin(op):
    """(real interval of H, imag half-extent of S) for a BandedOperator /
    diagonal-storage container via Gershgorin on the Hermitian/skew split
    (host numpy; one pass over the k·n diagonal data)."""
    diags = np.asarray(op.diags)
    offsets = tuple(op.offsets)
    n = diags.shape[1]
    by_off = {o: diags[i] for i, o in enumerate(offsets)}
    d0 = np.real(by_off.get(0, np.zeros(n)))
    radH = np.zeros(n)
    radS = np.zeros(n)
    for o in offsets:
        if o == 0:
            continue
        u = by_off[o]                       # A[i, i+o]
        v = by_off.get(-o)                  # A[i, i−o] → A[i+o, i] = v[i+o]
        # H[i, i+o] = (A[i,i+o] + conj(A[i+o,i]))/2, S likewise with −
        vt = np.zeros(n, dtype=diags.dtype)
        if v is not None:
            if o > 0:
                vt[:n - o] = v[o:]
            else:
                vt[-o:] = v[:n + o]
        h = 0.5 * np.abs(u + np.conj(vt))
        s = 0.5 * np.abs(u - np.conj(vt))
        radH += h
        radS += s
    # each symmetric pair (o, −o) contributes to BOTH the row at i and the
    # row at i+o; Gershgorin needs the per-row total — the loop above
    # visits o and −o separately, so rows already collect both sides.
    lo = float(np.min(d0 - radH))
    hi = float(np.max(d0 + radH))
    beta = float(np.max(radS + np.abs(np.imag(by_off.get(0, np.zeros(n))))))
    return (lo, hi), beta


def fov_ellipse(A) -> tuple[float, float, float]:
    """(c, α, β): an axis-aligned ellipse enclosing the numerical range
    W(A), from the Hermitian/skew split A = H + iS' (H, S' Hermitian):
    Re W(A) = [λmin(H), λmax(H)], Im W(A) = [λmin(S'), λmax(S')].

    Dense operators: exact (eigvalsh of H and S'). Diagonal-storage
    containers: Gershgorin enclosures of both parts (host, one pass).
    Only real-spectrum-centered ellipses are produced (c real; an
    asymmetric imaginary extent is enclosed by ±β)."""
    from ..utils.linop import DenseOperator

    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    if isinstance(op, DenseOperator):
        M = np.asarray(op.A)
        H = (M + M.conj().T) / 2
        S = (M - M.conj().T) / (2j)
        wh = np.linalg.eigvalsh(H)
        ws = np.linalg.eigvalsh(S)
        pad = 1e-3 * max(wh[-1] - wh[0], 1e-300)
        c = 0.5 * float(wh[0] + wh[-1])
        alpha = 0.5 * float(wh[-1] - wh[0]) + pad
        beta = float(max(abs(ws[0]), abs(ws[-1]))) * (1 + 1e-3)
        return c, alpha, beta
    if hasattr(op, "diags") and hasattr(op, "offsets"):
        (lo, hi), beta = _banded_hs_gershgorin(op)
        return 0.5 * (lo + hi), 0.5 * (hi - lo), beta
    if hasattr(op, "coeffs") and hasattr(op, "offsets"):
        # constant-coefficient stencil: H/S split per offset pair —
        # H[i, i+o] = (c_o + conj(c_{−o}))/2, S likewise with −; the
        # Gershgorin radii are offset sums (boundary rows only smaller)
        cmap = {tuple(off): complex(v) for off, v in
                zip(op.offsets, np.asarray(op.coeffs))}
        d0 = cmap.get(tuple([0] * len(op.grid_shape)), 0.0)
        radH = radS = 0.0
        for off, v in cmap.items():
            if all(o == 0 for o in off):
                continue
            w = np.conj(cmap.get(tuple(-o for o in off), 0.0))
            radH += abs((v + w) / 2)
            radS += abs((v - w) / 2)
        lo, hi = d0.real - radH, d0.real + radH
        return (0.5 * (lo + hi), 0.5 * (hi - lo),
                radS + abs(d0.imag))
    # stencil containers expose their banded view through gershgorin
    # helpers used by real_interval; fall back to a real interval with a
    # zero imaginary extent only for genuinely Hermitian operators.
    if getattr(op, "is_hermitian", False):
        lo, hi = real_interval(op)
        return 0.5 * (lo + hi), 0.5 * (hi - lo), 0.0
    raise TypeError(
        f"no fov_ellipse rule for {type(op).__name__}; pass "
        "ellipse=(c, alpha, beta) explicitly")


def _psi_samples(t, c, gamma, rho, nsamp: int):
    """t·ψ(e^{iθ}) on an nsamp uniform circle grid (numpy complex)."""
    th = 2.0 * np.pi * np.arange(nsamp) / nsamp
    w = np.exp(1j * th)
    return t * (c + gamma * (w + rho / w))


def faber_coeffs(fvals, rho, m: int):
    """First ``m`` Faber coefficients a_k from samples of f(ψ(·)) on the
    circle (FFT), plus the sup-norm weights (1 + ρ^k) of ‖F_k‖_E used by
    the truncation rule. ``len(fvals)`` should be ≥ 4·m so the ρ^k-damped
    w^{−k} Laurent tail cannot alias into the kept range."""
    nsamp = len(fvals)
    if nsamp < 2 * m:
        raise ValueError(f"need ≥ {2*m} samples for degree {m}")
    a = np.fft.fft(np.asarray(fvals)) / nsamp
    a = a[:m]
    sup = 1.0 + rho ** np.arange(m)
    return a, sup


@functools.partial(jax.jit, static_argnames=("m", "q"))
@mxu_full_precision
def _faber_apply(op, b, a, center, inv_gamma, rho, m: int, q: int):
    """q substeps of the degree-(m−1) Faber form — matvec + axpy only.
    ``a`` is (m,) → (n,) output, or (m, p) → (n, p) (all p coefficient
    columns accumulated in one pass; q must be 1 for matrix ``a``).

    Recurrence (module docstring): g_1 = Â·b, g_{k+1} = Â·g_k − ρ·g_{k−1}
    with g_0 = 2b inside the recurrence but paired with a_0·b in the sum
    (the classical half-weight of the k = 0 term)."""
    b = jnp.asarray(b)
    rdt = jnp.finfo(b.dtype).dtype
    center = jnp.asarray(center, rdt)
    inv_gamma = jnp.asarray(inv_gamma, rdt)
    rho = jnp.asarray(rho, rdt)
    cdt = a.dtype

    def Ahat(x):
        return inv_gamma * (op.matvec(x) - center * x)

    def accum(w, g, ak):
        if a.ndim == 1:
            return w + ak * g.astype(cdt)
        return w + g.astype(cdt)[:, None] * ak[None, :]

    def substep(v, _):
        z = (v * 0).astype(cdt)
        w0 = z if a.ndim == 1 else jnp.broadcast_to(
            z[:, None], v.shape + a.shape[1:])
        w0 = accum(w0, v, a[0])
        if m == 1:
            return (w0.astype(v.dtype) if a.ndim == 1 else v), w0
        g_prev = 2.0 * v          # g_0 inside the recurrence
        g_cur = Ahat(v)           # g_1

        def term(carry, k):
            gp, g, w = carry
            w = accum(w, g, a[k])
            g_next = Ahat(g) - rho * gp
            return (g, g_next, w), None

        (_, _, w), _ = lax.scan(term, (g_prev, g_cur, w0),
                                jnp.arange(1, m))
        return (w.astype(v.dtype) if a.ndim == 1 else v), w

    if a.ndim == 1:
        out, _ = lax.scan(substep, b, None, length=q)
        return out
    _, ws = lax.scan(substep, b, None, length=1)
    return ws[0]


def _resolve_ellipse(op, ellipse):
    if ellipse is not None:
        c, alpha, beta = (float(ellipse[0]), float(ellipse[1]),
                          float(ellipse[2]))
    else:
        c, alpha, beta = fov_ellipse(op)
    if beta > alpha:
        # Faber needs α ≥ β (foci on the real axis); a taller-than-wide
        # numerical range is enclosed by the containing disk (ρ = 0).
        alpha = beta
    gamma = 0.5 * (alpha + beta)
    rho = (alpha - beta) / (alpha + beta) if alpha + beta > 0 else 0.0
    return c, alpha, beta, gamma, rho


def _probe_degree_faber(z: float, tol: float) -> int:
    """Generous probe degree for per-substep z = |t|·γ·(1+ρ)/2-class
    parameters: the Faber tail of exp cuts at O(z) + margin (decay
    spectra cut earlier; the truncation rule finds that)."""
    return min(_MAX_DEGREE, int(np.ceil(
        3.0 * z + 2.5 * np.sqrt(max(z, 1.0) * np.log(1.0 / tol)) + 16)))


def expv_faber(t, A, b, *, ellipse=None, tol: float = 1e-7,
               m: int | None = None, max_z: float = 512.0):
    """``exp(tA) b`` by a Faber series on the field-of-values ellipse —
    single pass per substep, NO inner products, non-Hermitian allowed,
    and (unlike ``expv_leja``) no basis-conditioning degree cap: the
    recurrence iterates are bounded by ‖F_k(A)‖ ≤ 2(1+√2) for
    FoV(A) ⊆ E, so one substep can carry z = |t|·α/2 in the hundreds.

    Args:
      ellipse: (c, α, β) enclosing the numerical range (c real center,
        α/β real/imaginary semi-axes); None → ``fov_ellipse`` (exact on
        dense via the Hermitian/skew split, Gershgorin on containers).
      tol: coefficient tail cutoff (relative, sup-norm weighted).
      m: fixed degree override (bypasses the convergence raise).
      max_z: per-substep |t|·capacity budget (capacity = γ here); larger
        t substeps exactly (exp(tA) = exp(t/q·A)^q). The default is
        3–12× the Leja module's stable range — raise it further if the
        compile-size of a degree-~3·max_z scan is acceptable.
    """
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    b = jnp.asarray(b)
    setup = _faber_expv_setup(op, t, ellipse, tol, m, max_z,
                              complex_b=bool(np.iscomplexobj(b)))
    a, c, gamma, rho, q, m_used, log_sup = setup
    if a is None:                       # A ≈ cI (c already resolved)
        return (jnp.exp(jnp.asarray(float(t) * c, b.dtype)) * b)
    cdt = (jnp.result_type(b.dtype, jnp.complex64)
           if np.iscomplexobj(a) or np.iscomplexobj(b)
           else jnp.result_type(b.dtype))
    aj = jnp.asarray(a[:m_used], cdt)
    out = _faber_apply(op, b, aj, c, 1.0 / gamma, rho, m_used, q)
    # real input + real operator: exp(tA)b is real; drop the series'
    # roundoff-level imaginary dust only when the math says it is dust
    if not jnp.iscomplexobj(b) and jnp.iscomplexobj(out):
        out = jnp.real(out).astype(b.dtype)
    bnorm = float(jnp.linalg.norm(b))
    log_bound = q * (np.log(_CROUZEIX) + log_sup) \
        + np.log(max(bnorm, 1e-300))
    return _check_finite_faber(out, "expv_faber", log_bound)


def _faber_expv_setup(op, t, ellipse, tol, m, max_z, *,
                      complex_b: bool = False):
    """Host-side coefficient setup shared by :func:`expv_faber` and the
    sharded twin (parallel/poly.py). Returns
    ``(a, c, gamma, rho, q, m_used, log_sup)`` — Faber coefficients
    (realified when their imaginary part is roundoff dust and b is
    real), map parameters, substep count, degree, and log of the sup of
    |exp| on the ellipse boundary (for the Crouzeix guard). ``a`` is
    None when A ≈ cI (the caller shortcuts to exp(tc)·b with the
    already-resolved c — re-resolving would re-run the fov_ellipse
    probe)."""
    c, alpha, beta, gamma, rho = _resolve_ellipse(op, ellipse)
    tf = float(t)
    if gamma <= 0:
        return None, c, gamma, rho, 0, 0, 0.0

    q = max(1, int(np.ceil(abs(tf) * gamma / max_z)))
    tau = tf / q
    z = abs(tau) * gamma

    m_probe = _probe_degree_faber(z, tol)
    nsamp = 1 << int(np.ceil(np.log2(4 * m_probe)))
    with np.errstate(over="ignore"):
        vals = np.exp(_psi_samples(tau, c, gamma, rho, nsamp))
    if not np.isfinite(vals).all():
        raise FloatingPointError(
            f"expv_faber: exp overflows on the ellipse boundary "
            f"(max Re τ·z ≈ {tau * (c + alpha):.3g}) — shrink max_z")
    a, sup = faber_coeffs(vals, rho, m_probe)
    m_used = _truncate_dd(np.abs(a) * sup, tol, m_probe, m,
                          f"expv_faber (z = {z:.1f} per substep)")
    if not complex_b and abs(np.imag(a[:m_used])).max() <= \
            1e-12 * max(np.abs(a[:m_used]).max(), 1e-300):
        a = np.real(a)
    log_sup = np.log(max(float(np.abs(vals).max()), 1e-300))
    return a, c, gamma, rho, q, m_used, log_sup


_CROUZEIX = 1.0 + np.sqrt(2.0)     # ‖f(A)‖ ≤ (1+√2)·sup_{W(A)}|f|
_GUARD_SLACK = 64.0                # truncation + roundoff headroom


def _check_finite_faber(U, what: str, log_bound: float | None = None):
    """No-silent-failure protocol (single host sync): raise on non-finite
    results AND on results that violate the numerical-range bound
    ‖f(A)b‖ ≤ (1+√2)·sup_E|f|·‖b‖ (Crouzeix) implied by the CLAIMED
    ellipse — a finite-but-wrong answer from a non-enclosing ellipse
    exceeds its own ellipse's promise by many orders (measured: 1e18 at
    a 50×-shrunk ellipse), so the one extra norm comparison catches what
    the isfinite check cannot."""
    if not bool(jnp.all(jnp.isfinite(U))):
        raise FloatingPointError(
            f"{what} diverged (non-finite result): check the ellipse "
            "encloses the numerical range (pass ellipse=(c, α, β) from "
            "a trusted source, or widen it), or use the Krylov path")
    if log_bound is not None:
        nrm = float(jnp.max(jnp.linalg.norm(
            jnp.atleast_2d(U.T).T, axis=0)))
        if nrm > 0 and np.log(nrm) > log_bound + np.log(_GUARD_SLACK):
            raise FloatingPointError(
                f"{what}: result norm {nrm:.3e} exceeds the "
                f"numerical-range bound e^{log_bound:.3g} implied by the "
                "ellipse — the ellipse does not enclose the numerical "
                "range; widen it or use the Krylov path")
    return U


def phiv_faber(t, A, b, k: int, *, ellipse=None, tol: float = 1e-7,
               m: int | None = None, max_z: float = 512.0):
    """``[φ_0(tA)b … φ_k(tA)b]`` (n, k+1) by Faber series — all orders in
    one inner-product-free pass (coefficients of every φ_j share the
    recurrence vectors; cf. ``phiv_leja``). φ actions have no exact
    substepping: |t|·γ beyond ``max_z`` raises (use
    ``phiv_timestep_faber`` for stiff horizons)."""
    from .chebyshev import _phi_scalar_np

    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    b = jnp.asarray(b)
    c, alpha, beta, gamma, rho = _resolve_ellipse(op, ellipse)
    tf = float(t)
    if gamma <= 0:
        vals = _phi_scalar_np(np.asarray([tf * c]), k)[:, 0]
        return jnp.stack([jnp.asarray(v, b.dtype) * b for v in vals],
                         axis=-1)
    z = abs(tf) * gamma
    if z > max_z:
        raise ValueError(
            f"|t|·γ = {z:.1f} exceeds max_z = {max_z}: φ actions have "
            "no exact substepping — use phiv_timestep_faber for stiff "
            "horizons")
    m_probe = _probe_degree_faber(z, tol)
    nsamp = 1 << int(np.ceil(np.log2(4 * m_probe)))
    samples = _psi_samples(1.0, c, gamma, rho, nsamp)
    V = _phi_scalar_np(tf * samples, k)          # (k+1, nsamp)
    if not np.isfinite(V).all():
        raise FloatingPointError(
            "phiv_faber: φ overflows on the ellipse boundary — shrink t "
            "or use the Krylov path")
    D = np.stack([faber_coeffs(V[j], rho, m_probe)[0]
                  for j in range(k + 1)], axis=1)      # (m, k+1)
    sup = 1.0 + rho ** np.arange(m_probe)
    m_used = _truncate_dd(np.abs(D).max(axis=1) * sup, tol, m_probe, m,
                          f"phiv_faber (z = {z:.1f})")
    if not np.iscomplexobj(np.asarray(b)) and \
            abs(np.imag(D[:m_used])).max() <= \
            1e-12 * max(np.abs(D[:m_used]).max(), 1e-300):
        D = np.real(D)
        cdt = jnp.result_type(b.dtype)
    else:
        cdt = jnp.result_type(b.dtype, jnp.complex64)
    Dj = jnp.asarray(D[:m_used], cdt)
    W = _faber_apply(op, b, Dj, c, 1.0 / gamma, rho, m_used, 1)
    if not jnp.iscomplexobj(b) and jnp.iscomplexobj(W):
        W = jnp.real(W).astype(b.dtype)
    bnorm = float(jnp.linalg.norm(b))
    log_bound = (np.log(_CROUZEIX)
                 + np.log(max(float(np.abs(V).max()), 1e-300))
                 + np.log(max(bnorm, 1e-300)))
    return _check_finite_faber(W, "phiv_faber", log_bound)


@functools.partial(jax.jit, static_argnames=("p", "m", "q"))
@mxu_full_precision
def _nw_faber_scan(op, u0, B, D, center, inv_gamma, rho, t0, tau,
                   p: int, m: int, q: int):
    """q substeps of u(t+τ) = φ₀(τA)u + Σ_{j≥1} τ^j φ_j(τA) v_j(t) as ONE
    compiled ``lax.scan`` — the direct all-orders φ-combination of
    models/leja._nw_leja_scan (same cancellation-free rationale, that
    docstring) with the Faber three-term recurrence replacing the Newton
    form. ``D`` is (m, p+1), τ^j pre-folded."""
    import math as _math

    rdt = jnp.finfo(u0.dtype).dtype
    center = jnp.asarray(center, rdt)
    inv_gamma = jnp.asarray(inv_gamma, rdt)
    rho = jnp.asarray(rho, rdt)
    cdt = D.dtype
    mv = jax.vmap(op.matvec)

    def Ahat(X):
        return inv_gamma * (mv(X) - center * X)

    def substep(carry, _):
        u, tcur = carry
        cols = [u]
        for j in range(1, p + 1):
            vj = jnp.zeros_like(u)
            for l in range(0, p - j + 1):
                vj = vj + ((tcur ** l) / _math.factorial(l)) * B[:, j + l]
            cols.append(vj)
        Om = jnp.stack(cols, axis=0)                   # (p+1, n)

        w0 = (D[0].astype(cdt) @ Om.astype(cdt))
        if m == 1:
            return (w0.astype(u.dtype), tcur + tau), None
        g_prev = 2.0 * Om
        g_cur = Ahat(Om)

        def term(carry2, k2):
            gp, g, w = carry2
            w = w + D[k2].astype(cdt) @ g.astype(cdt)
            g_next = Ahat(g) - rho * gp
            return (g, g_next, w), None

        (_, _, u_next), _ = lax.scan(term, (g_prev, g_cur, w0),
                                     jnp.arange(1, m))
        return (u_next.astype(u.dtype), tcur + tau), None

    (u, _), _ = lax.scan(substep, (u0, jnp.asarray(t0, rdt)),
                         jnp.arange(q))
    return u


def phiv_timestep_faber(ts, A, B, *, ellipse=None, tol: float = 1e-7,
                        max_z: float = 512.0,
                        max_degree: int | None = None):
    """u(t) = Σ_j t^j φ_j(tA) b_j at snapshot times ``ts`` for
    NON-Hermitian A — the substepped direct φ-combination of
    ``phiv_timestep_leja`` with the Faber ellipse basis, which removes
    that driver's z ≈ 150 conditioning envelope: per-substep z defaults
    to 512 (measured stable well beyond; the bound is compile size, not
    numerics), so a t·s = 1100 horizon runs in 2–3 substeps instead of
    28. Also covers FAT ellipses (advection-dominated operators) that
    the real-interval Leja domain must reject.

    Hermitian A: prefer ``phiv_timestep_chebyshev``. Returns U
    (n, len(ts)) / (n,), matching ``phiv_timestep``.
    """
    from .chebyshev import _phi_scalar_np

    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    p = B.shape[1] - 1
    scalar_ts = np.ndim(ts) == 0
    ts_in = np.atleast_1d(np.asarray(ts, np.float64))
    order = np.argsort(ts_in, kind="stable")
    c, alpha, beta, gamma, rho = _resolve_ellipse(op, ellipse)
    if gamma <= 0:
        cols = []
        for t in ts_in:
            vals = _phi_scalar_np(np.asarray([t * c]), p)[:, 0]
            cols.append(sum((t ** j) * float(vals[j]) * B[:, j]
                            for j in range(p + 1)))
        U = jnp.stack(cols, axis=-1)
        return U[:, 0] if scalar_ts else U

    import math as _math
    Bnorms = [float(jnp.linalg.norm(B[:, j])) for j in range(p + 1)]

    def march(snaps, u0):
        u = u0
        outs = []
        caps = []          # host-tracked Crouzeix norm cap per snapshot
        cap = Bnorms[0]
        t_prev = 0.0
        memo = {}
        for t_snap in snaps:
            dt_int = float(t_snap) - t_prev
            if dt_int == 0.0:
                outs.append(u)
                caps.append(cap)
                continue
            q = max(1, int(np.ceil(abs(dt_int) * gamma / max_z)))
            tau = dt_int / q
            z = abs(tau) * gamma
            m_probe = _probe_degree_faber(z, tol)
            memo_key = (float(tau).hex(), m_probe)
            if memo_key in memo:
                D, sup, smax = memo[memo_key]
            else:
                nsamp = 1 << int(np.ceil(np.log2(4 * m_probe)))
                samples = _psi_samples(1.0, c, gamma, rho, nsamp)
                V = _phi_scalar_np(tau * samples, p)   # (p+1, nsamp)
                if not np.isfinite(V).all():
                    raise FloatingPointError(
                        "phiv_timestep_faber: φ overflows on the ellipse "
                        "boundary — shrink max_z")
                D = np.stack([faber_coeffs(V[j], rho, m_probe)[0]
                              for j in range(p + 1)], axis=1)
                D = D * (tau ** np.arange(p + 1))[None, :]
                sup = 1.0 + rho ** np.arange(m_probe)
                smax = np.abs(V).max(axis=1)           # sup_E |φ_j(τ·)|
                memo[memo_key] = (D, sup, smax)
            try:
                m_used = _truncate_dd(
                    np.abs(D).max(axis=1) * sup, tol, m_probe, None,
                    f"phiv_timestep_faber (z = {z:.1f} per substep)")
            except ValueError:
                if max_degree is None:
                    raise
                m_used = m_probe
            if max_degree is not None:
                m_used = min(m_used, max_degree)
            Dk = D[:m_used]
            if abs(np.imag(Dk)).max() <= 1e-12 * max(
                    np.abs(Dk).max(), 1e-300):
                Dk = np.real(Dk)
            Dj = jnp.asarray(Dk, jnp.result_type(u.dtype, Dk.dtype)
                             if np.iscomplexobj(Dk)
                             else jnp.result_type(u.dtype))
            u_next = _nw_faber_scan(op, u, B, Dj, c, 1.0 / gamma, rho,
                                    jnp.asarray(t_prev), jnp.asarray(tau),
                                    p=p, m=m_used, q=q)
            if jnp.iscomplexobj(u_next) and not jnp.iscomplexobj(u):
                u_next = jnp.real(u_next).astype(u.dtype)
            u = u_next
            # host-side Crouzeix norm cap (the _check_finite_faber bound):
            # ‖u(t+τ)‖ ≤ C·sup|φ0|·‖u‖ + Σ_j C·sup|φ_j|·|τ|^j·‖v_j(t)‖
            tcur = t_prev
            for _ in range(q):
                vb = [sum(abs(tcur) ** l / _math.factorial(l)
                          * Bnorms[j + l] for l in range(0, p - j + 1))
                      for j in range(1, p + 1)]
                cap = _CROUZEIX * (smax[0] * cap + sum(
                    smax[j] * abs(tau) ** j * vb[j - 1]
                    for j in range(1, p + 1)))
                tcur += tau
            outs.append(u)
            caps.append(cap)
            t_prev = float(t_snap)
        return outs, caps

    ts_sorted = ts_in[order]
    pos_idx = order[ts_sorted >= 0]
    neg_idx = order[ts_sorted < 0][::-1]
    u0 = B[:, 0]
    cols = [None] * len(ts_in)
    col_caps = [None] * len(ts_in)
    for idx_list in (pos_idx, neg_idx):
        if len(idx_list):
            outs, caps = march(ts_in[idx_list], u0)
            for i, u, cp in zip(idx_list, outs, caps):
                cols[int(i)] = u
                col_caps[int(i)] = cp
    U = jnp.stack(cols, axis=-1)
    U = _check_finite_faber(U, "phiv_timestep_faber")
    nrms = np.asarray(jnp.linalg.norm(U, axis=0))
    for i, cp in enumerate(col_caps):
        if np.isfinite(cp) and nrms[i] > _GUARD_SLACK * max(cp, 1e-300):
            raise FloatingPointError(
                f"phiv_timestep_faber: snapshot {i} norm {nrms[i]:.3e} "
                f"exceeds the numerical-range bound {cp:.3e} implied by "
                "the ellipse — the ellipse does not enclose the "
                "numerical range; widen it or use the Krylov path")
    return U[:, 0] if scalar_ts else U
