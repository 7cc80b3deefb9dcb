"""Real-Leja-point Newton interpolation for NON-Hermitian exp actions.

The Chebyshev module (models/chebyshev.py) gives single-pass,
inner-product-free ``exp(tA) b`` for Hermitian A. This module extends
the same execution shape — one matvec + axpy per degree, coefficients
known before the run — to non-Hermitian operators whose field of values
lies in a thin horizontal ellipse around a real interval [a, b]
(advection–diffusion and friends: the reference exercises this class
through ``expv_timestep`` on operators like
``test/basictests.jl``'s advection–diffusion; cf. config 4):

    p_m(A) b = Σ_k d_k ω_k,   ω_0 = b,  ω_{k+1} = (Â − ξ_k I) ω_k,

with Â = (A − cI)/s the interval mapped to [−2, 2] (capacity 1, so the
ω_k stay O(‖b‖)), ξ_k **Leja points** of [−2, 2] (maximal-product
ordering — the ordering is what makes Newton interpolation stable), and
d_k the divided differences of x ↦ exp(t(c + s·x)) at the ξ_k.

Divided differences are NOT computed by the recursive formula (it is
catastrophically unstable); they come from the exact identity

    d_k = [exp(Z)]_{k,0},   Z bidiagonal: Z_ii = t(c + s·ξ_i),
                            Z_{i+1,i} = t·s

(Opitz 1964: f of the Newton "shift" matrix carries the divided
differences of f in its first column), evaluated with scipy's f64 expm
on the host — an (m+1)² problem.

Large |t|·s is handled by exact substepping: exp(tA) = (exp(τA))^q with
τ = t/q chosen so the per-substep degree stays in the stable range; all
q substeps share one divided-difference table and run as a
``lax.scan`` over a scan — still zero inner products end-to-end.

Reference context: the reference has no polynomial-interpolation
action (its non-Hermitian path is Arnoldi, src/arnoldi.jl); this is the
"beyond" layer — the absence of per-step reductions can be worth more
than the Krylov basis' optimality.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils.linop import LinearOperator, aslinearoperator
from ..utils.precision import mxu_full_precision

__all__ = ["expv_leja", "phiv_leja", "phiv_timestep_leja", "leja_points",
           "real_interval"]

_MAX_DEGREE = 256          # per substep; z = |t|·s per substep kept ≲ 40


@functools.lru_cache(maxsize=8)
def _leja_points_sup(m: int, lo: float = -2.0, hi: float = 2.0,
                     grid: int = 20001):
    """First ``m`` Leja points of [lo, hi] plus the sup-norms
    S_k = max_x Π_{i<k}|x − ξ_i| of the Newton factor polynomials
    (needed for a sound truncation criterion: the uniform remainder is
    Σ_{k≥m}|d_k|·S_k, and S_k grows polynomially even at capacity 1).

    ξ_0 = hi, then greedily ξ_{k+1} = argmax Π|x − ξ_i| over a fine
    grid (log-sum form so the product never over/underflows).
    Deterministic, host-side, cached."""
    x = np.linspace(lo, hi, grid)
    pts = np.empty(m)
    logsup = np.empty(m)
    pts[0] = hi
    logsup[0] = 0.0                  # Π over empty set == 1
    logprod = np.log(np.abs(x - hi) + 1e-300)
    for k in range(1, m):
        j = int(np.argmax(logprod))
        pts[k] = x[j]
        logsup[k] = logprod[j]
        logprod += np.log(np.abs(x - x[j]) + 1e-300)
    return pts, np.exp(logsup)


def leja_points(m: int, lo: float = -2.0, hi: float = 2.0,
                grid: int = 20001):
    """First ``m`` Leja points of [lo, hi] (see ``_leja_points_sup``)."""
    return _leja_points_sup(m, lo, hi, grid)[0]


def real_interval(A) -> tuple[float, float]:
    """Enclosure of the REAL parts of A's spectrum.

    Containers (banded/stencil/variable-stencil) provide their per-row
    Gershgorin row sums (``_gershgorin_real`` — the same helper behind
    the Hermitian ``spectral_bounds_hint``); dense operators use the
    field-of-values real extent (eigvalsh of the Hermitian part) — it
    always encloses the spectrum's real parts, is the quantity
    interpolation convergence actually depends on, and is far tighter
    than Gershgorin for non-normal dense matrices (measured: triangular
    test matrix ±11.7 Gershgorin vs ±1.4)."""
    from ..utils.linop import DenseOperator

    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    if isinstance(op, DenseOperator):
        M = np.asarray(op.A)
        H = (M + M.conj().T) / 2
        w = np.linalg.eigvalsh(H)
        pad = 1e-3 * max(w[-1] - w[0], 1e-300)
        return float(w[0] - pad), float(w[-1] + pad)
    gersh = getattr(op, "_gershgorin_real", None)
    if callable(gersh):
        return gersh()
    raise TypeError(
        f"no real_interval rule for {type(op).__name__}; pass "
        "interval=(a, b) explicitly")


def _probe_degree(z: float, tol: float) -> int:
    """Generous dd-table probe degree for per-substep parameter z (one
    place for the 3.2/2.5/12 margin constants)."""
    return min(_MAX_DEGREE, int(np.ceil(
        3.2 * z + 2.5 * np.sqrt(max(z, 1.0) * np.log(1.0 / tol)) + 12)))


def _truncate_dd(mag, tol: float, m_probe: int, m_override, what: str):
    """Shared sup-norm-weighted tail truncation for divided-difference
    tables: smallest m whose dropped tail stays below ``tol`` relative
    to the largest term. Raises on non-convergence at the probe degree
    (never silently truncates) unless the caller fixed the degree
    explicitly."""
    if not np.isfinite(mag).all():
        # an overflowed divided-difference table (scipy expm of the
        # bidiagonal shift matrix overflows past exp(709) entries —
        # reachable on growth spectra with a raised max_z) must never
        # pass as converged: every comparison below would be False and
        # the fallback m_used=1 would return a finite but wrong
        # degree-0 interpolation. FloatingPointError (not ValueError)
        # so the max_degree cap in phiv_timestep_leja can never swallow
        # it — an overflowed table is divergence, not slow convergence.
        raise FloatingPointError(
            f"{what}: divided-difference table is non-finite "
            "(overflow in the host expm of the shift matrix) — shrink "
            "max_z so each substep's |tau|*s is smaller, or use the "
            "Krylov path")
    thresh = tol * max(float(mag.max()), 1e-300)
    keep = np.nonzero(np.maximum.accumulate(mag[::-1])[::-1] > thresh)[0]
    m_used = int(keep[-1]) + 1 if keep.size else 1
    if m_override is not None:
        return min(int(m_override), m_probe)
    if m_used >= m_probe:
        # the tail never fell below tol within the probe table (the
        # probe formula carries margin, so this means non-convergence,
        # not under-probing) — never silently truncate
        raise ValueError(
            f"{what}: Leja degree did not converge within the probe "
            f"degree {m_probe} — widen substepping (smaller max_z), "
            "check the interval encloses the spectrum, or use the "
            "Krylov path")
    return m_used


def _divided_differences(t, c, s, xi):
    """d_k = dd's of x ↦ exp(t(c + s·x)) at the Leja points xi, via the
    Opitz bidiagonal identity (module docstring), host f64."""
    import scipy.linalg as sla

    m = len(xi)
    Z = np.diag(t * (c + s * xi))
    Z += np.diag(np.full(m - 1, t * s), -1)
    return sla.expm(Z)[:, 0]


@functools.partial(jax.jit, static_argnames=("m", "q"))
@mxu_full_precision
def _leja_apply(op, b, d, xi, center, inv_s, m: int, q: int):
    """q substeps of the degree-(m−1) Newton form, all coefficients
    precomputed — matvec + axpy only. ``d`` may be (m,) → (n,), or
    (m, p) → (n, p) (all p combinations accumulated in the single
    Newton pass; q must be 1 for matrix d)."""
    b = jnp.asarray(b)
    rdt = jnp.finfo(b.dtype).dtype
    center = jnp.asarray(center, rdt)
    inv_s = jnp.asarray(inv_s, rdt)
    cdt = d.dtype

    def accum(w, om, dk):
        if d.ndim == 1:
            return w + dk * om.astype(cdt)
        return w + om.astype(cdt)[:, None] * dk[None, :]

    def substep(v, _):
        def term(carry, k):
            om, w = carry
            w = accum(w, om, d[k])
            om = inv_s * (op.matvec(om) - center * om) - xi[k] * om
            return (om, w), None

        z = (v * 0).astype(cdt)
        w0 = z if d.ndim == 1 else jnp.broadcast_to(
            z[:, None], v.shape + d.shape[1:])
        (_, w), _ = lax.scan(term, (v, w0), jnp.arange(m))
        return (w.astype(v.dtype) if d.ndim == 1 else v), w

    if d.ndim == 1:
        out, _ = lax.scan(substep, b, None, length=q)
        return out
    _, ws = lax.scan(substep, b, None, length=1)
    return ws[0]


def _leja_expv_setup(op, t, interval, tol, m, max_z):
    """Host-side coefficient setup shared by :func:`expv_leja` and the
    sharded twin (parallel/poly.py). Returns ``(d, xi, c, s, q)`` with
    ``d`` the truncated divided differences; ``d is None`` signals
    A ≈ cI (caller shortcut: exp(tc)·b)."""
    if interval is None:
        interval = real_interval(op)
    a_lo, b_hi = float(interval[0]), float(interval[1])
    tf = float(t)
    c = 0.5 * (b_hi + a_lo)
    s = 0.25 * (b_hi - a_lo)           # capacity of [a, b]
    if s <= 0:
        return None, None, c, s, 0
    q = max(1, int(np.ceil(abs(tf) * s / max_z)))
    tau = tf / q
    z = abs(tau) * s
    # Degree from the divided-difference tail: compute a generous table
    # and truncate where the trailing |d_k| stay below tol·max|d|.
    m_probe = _probe_degree(z, tol)
    xi, sup = _leja_points_sup(m_probe)
    d = _divided_differences(tau, c, s, xi)
    # uniform-remainder magnitudes: |d_k| · sup|Π_{i<k}(x − ξ_i)|
    m_used = _truncate_dd(np.abs(d) * sup, tol, m_probe, m,
                          f"expv_leja (z = {z:.1f} per substep)")
    return d[:m_used], xi[:m_used], c, s, q


def expv_leja(t, A, b, *, interval=None, tol: float = 1e-7,
              m: int | None = None, max_z: float = 40.0):
    """``exp(tA) b`` by Newton interpolation at real Leja points —
    single pass per substep, NO inner products, non-Hermitian allowed
    (module docstring; for Hermitian operators prefer
    ``expv_chebyshev``, whose interval is two-sided-tight).

    Args:
      interval: (a, b) enclosure of the spectrum's REAL parts; None →
        Gershgorin via ``real_interval`` (dense/banded/stencil).
      tol: divided-difference tail cutoff (per substep).
      m: fixed degree override.
      max_z: per-substep |t|·s budget; larger t substeps exactly
        (exp(tA) = exp(t/q·A)^q).
    """
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    b = jnp.asarray(b)
    d, xi, c, s, q = _leja_expv_setup(op, t, interval, tol, m, max_z)
    if d is None:                       # A ≈ cI (real-shift only)
        return (jnp.exp(jnp.asarray(float(t) * c, b.dtype)) * b)
    m_used = len(d)
    dj = jnp.asarray(d[:m_used], jnp.result_type(b.dtype))
    xj = jnp.asarray(xi[:m_used], jnp.finfo(b.dtype).dtype)
    return _leja_apply(op, b, dj, xj, c, 1.0 / s, m_used, q)


def _phi_divided_differences(t, c, s, xi, k: int):
    """dd's of x ↦ φ_j(t(c + s·x)) for ALL j=0..k at once: Opitz says
    they are the first column of φ_j(M), M the bidiagonal shift matrix
    with the mapped points — and [φ_0(M)e₁ … φ_k(M)e₁] is exactly the
    Sidje augmented-matrix exponential (ops/phi_dense.phiv_dense,
    reference src/phi.jl:63-94), here in host f64 via scipy."""
    import scipy.linalg as sla

    mm = len(xi)
    M = np.diag(t * (c + s * xi)) + np.diag(np.full(mm - 1, t * s), -1)
    if k == 0:
        return sla.expm(M)[:, :1]
    Aug = np.zeros((mm + k, mm + k))
    Aug[:mm, :mm] = M
    Aug[0, mm] = 1.0                     # v = e₁ column
    for j in range(k - 1):
        Aug[mm + j, mm + j + 1] = 1.0
    P = sla.expm(Aug)
    cols = [P[:mm, :mm][:, 0]] + [P[:mm, mm + j] for j in range(k)]
    return np.stack(cols, axis=1)        # (mm, k+1)


def phiv_leja(t, A, b, k: int, *, interval=None, tol: float = 1e-7,
              m: int | None = None, max_z: float = 40.0):
    """``[φ_0(tA)b … φ_k(tA)b]`` (n, k+1) by Newton interpolation at
    real Leja points — ALL orders in one inner-product-free pass,
    non-Hermitian allowed (cf. ``phiv_chebyshev`` for the Hermitian
    case). Unlike exp, φ actions do not substep exactly; |t|·s beyond
    ``max_z`` raises (use ``phiv_timestep``/``kiops`` there — their
    W-recurrence IS the correct φ substepping)."""
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    b = jnp.asarray(b)
    if interval is None:
        interval = real_interval(op)
    a_lo, b_hi = float(interval[0]), float(interval[1])
    tf = float(t)
    c = 0.5 * (b_hi + a_lo)
    s = 0.25 * (b_hi - a_lo)
    if s <= 0:
        from .chebyshev import _phi_scalar_np
        vals = _phi_scalar_np(np.asarray([tf * c]), k)[:, 0]
        return jnp.stack([jnp.asarray(v, b.dtype) * b for v in vals],
                         axis=-1)
    z = abs(tf) * s
    if z > max_z:
        raise ValueError(
            f"|t|·s = {z:.1f} exceeds max_z = {max_z}: φ actions have "
            "no exact substepping — use phiv_timestep/kiops for stiff "
            "horizons")
    m_probe = _probe_degree(z, tol)
    xi, sup = _leja_points_sup(m_probe)
    D = _phi_divided_differences(tf, c, s, xi, k)       # (m, k+1)
    m_used = _truncate_dd(np.abs(D).max(axis=1) * sup, tol, m_probe, m,
                          f"phiv_leja (z = {z:.1f})")
    Dj = jnp.asarray(D[:m_used], jnp.result_type(b.dtype))
    xj = jnp.asarray(xi[:m_used], jnp.finfo(b.dtype).dtype)
    return _leja_apply(op, b, Dj, xj, c, 1.0 / s, m_used, 1)


@functools.partial(jax.jit, static_argnames=("p", "m", "q"))
@mxu_full_precision
def _nw_leja_scan(op, u0, B, D, xi, center, inv_s, t0, tau,
                  p: int, m: int, q: int):
    """q substeps of u(t+τ) = φ₀(τA)u + Σ_{j≥1} τ^j φ_j(τA) v_j(t),
    v_j(t) = Σ_l (t^l/l!) b_{j+l}, as ONE compiled ``lax.scan``.

    This DIRECT φ-combination form deliberately avoids the W-recurrence
    the Krylov driver uses (timestepping._compute_W + (15)): the W
    vectors contain Aʲu terms of size (τ‖A‖)^j/j!·‖u‖ that must cancel
    in the update — measured 1.7e-2 f32 error at τ‖A‖ ≈ 160 vs the
    Krylov driver's 2.7e-5 (whose smaller adaptive τ hides the same
    cancellation). Here every column is O(‖B‖): no cancellation, at the
    cost of a (p+1)-wide batched matvec per Newton term — the one-pass
    all-orders trick only a known-coefficient method can afford
    (cf. phiv_leja). ``D`` is (m, p+1): column j the dd's of φ_j,
    pre-scaled by τ^j.
    """
    import math as _math

    rdt = jnp.finfo(u0.dtype).dtype
    center = jnp.asarray(center, rdt)
    inv_s = jnp.asarray(inv_s, rdt)
    cdt = D.dtype
    mv = jax.vmap(op.matvec)

    def substep(carry, k):
        u, tcur = carry
        # stacked columns [u, v_1 … v_p]: all O(‖u‖ + e^t‖B‖)
        cols = [u]
        for j in range(1, p + 1):
            vj = jnp.zeros_like(u)
            for l in range(0, p - j + 1):
                vj = vj + ((tcur ** l) / _math.factorial(l)) * B[:, j + l]
            cols.append(vj)
        Om = jnp.stack(cols, axis=0)           # (p+1, n)

        def term(inner, k2):
            om, w = inner
            w = w + D[k2].astype(cdt) @ om.astype(cdt)
            om = inv_s * (mv(om) - center * om) - xi[k2] * om
            return (om, w), None

        (_, u_next), _ = lax.scan(
            term, (Om, (u * 0).astype(cdt)), jnp.arange(m))
        return (u_next.astype(u.dtype), tcur + tau), None

    (u, _), _ = lax.scan(substep, (u0, jnp.asarray(t0, rdt)),
                         jnp.arange(q))
    return u


def phiv_timestep_leja(ts, A, B, *, interval=None, tol: float = 1e-7,
                       max_z: float = 40.0, max_degree: int | None = None):
    """u(t) = Σ_j t^j φ_j(tA) b_j at snapshot times ``ts`` for
    NON-Hermitian A (real-interval field-of-values class) — the
    Niesen–Wright substepped combination with the φ_p inner action as a
    Leja Newton pass instead of an Arnoldi build:

      * no orthogonalization, no inner products, no rejection loops —
        each snapshot interval runs as ONE compiled ``lax.scan`` over
        uniform substeps with τ·s ≤ ``max_z`` (a-priori
        divided-difference error control);
      * the reference's adaptive driver (src/krylov_phiv_adaptive.jl)
        remains the tool for spectra the real interval cannot describe
        or when no interval is available.

    Hermitian operators: prefer ``phiv_timestep_chebyshev`` (one pass,
    no substepping at all). Returns U (n, len(ts)) / (n,), matching
    ``phiv_timestep``.

    ``max_z`` trades accuracy for substep count (measured on the n=1500
    diffusion-dominated case, t·s = 1100): 40 → 2.5e-8 (f64) / 1.5e-5
    (f32), 150 → 1.8e-7 / 2.2e-5 (2.7× fewer substeps), 400 → 1.1e-4 —
    the Newton-basis conditioning grows with the per-substep degree, so
    beyond ~150 the a-priori tail control no longer reflects the
    achieved error. The default favors accuracy; raise to ~150 for f32
    serving.
    """
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    p = B.shape[1] - 1
    scalar_ts = np.ndim(ts) == 0
    ts_in = np.atleast_1d(np.asarray(ts, np.float64))
    order = np.argsort(ts_in, kind="stable")
    if interval is None:
        interval = real_interval(op)
    a_lo, b_hi = float(interval[0]), float(interval[1])
    c = 0.5 * (b_hi + a_lo)
    s = 0.25 * (b_hi - a_lo)
    if s <= 0:
        from .chebyshev import _phi_scalar_np
        cols = []
        for t in ts_in:
            vals = _phi_scalar_np(np.asarray([t * c]), p)[:, 0]
            cols.append(sum((t ** j) * float(vals[j]) * B[:, j]
                            for j in range(p + 1)))
        U = jnp.stack(cols, axis=-1)
        return U[:, 0] if scalar_ts else U

    def march(snaps, u0):
        """Evolve from t = 0 through the (monotone-away-from-zero)
        snapshot list; returns the per-snapshot states."""
        u = u0
        outs = []
        t_prev = 0.0
        dd_memo = {}
        for t_snap in snaps:
            dt_int = float(t_snap) - t_prev
            if dt_int == 0.0:
                outs.append(u)
                continue
            q = max(1, int(np.ceil(abs(dt_int) * s / max_z)))
            tau = dt_int / q
            z = abs(tau) * s
            m_probe = _probe_degree(z, tol)
            # per-call dd memo: equally spaced snapshots share one table
            # (scipy expm of a ~(m_probe+p)^2 bidiagonal per DISTINCT τ)
            # exact-float key: bitwise-equal linspace intervals still
            # hit, and distinct sub-1e-15 widths can never collide (an
            # absolute decimal rounding collided all |tau| < ~5e-16
            # onto the first entry's table)
            memo_key = (float(tau).hex(), m_probe)
            if memo_key in dd_memo:
                xi, sup, D = dd_memo[memo_key]
            else:
                xi, sup = _leja_points_sup(m_probe)
                if p == 0:
                    D = _divided_differences(tau, c, s, xi)[:, None]
                else:
                    D = _phi_divided_differences(tau, c, s, xi, p)
                D = D * (tau ** np.arange(p + 1))[None, :]  # fold τ^j
                dd_memo[memo_key] = (xi, sup, D)
            # max_degree is a CAP the caller opts into (accepting
            # truncation), not a fixed degree — the convergence raise
            # still fires when no cap was given.
            try:
                m_used = _truncate_dd(
                    np.abs(D).max(axis=1) * sup, tol, m_probe, None,
                    f"phiv_timestep_leja (z = {z:.1f} per substep)")
            except ValueError:
                if max_degree is None:
                    raise
                m_used = m_probe
            if max_degree is not None:
                m_used = min(m_used, max_degree)
            Dj = jnp.asarray(D[:m_used], jnp.result_type(u.dtype))
            xj = jnp.asarray(xi[:m_used], jnp.finfo(u.dtype).dtype)
            u = _nw_leja_scan(op, u, B, Dj, xj, c, 1.0 / s,
                              jnp.asarray(t_prev), jnp.asarray(tau),
                              p=p, m=m_used, q=q)
            outs.append(u)
            t_prev = float(t_snap)
        return outs

    # march positives forward and negatives backward, both from t = 0
    ts_sorted = ts_in[order]
    pos_idx = order[ts_sorted >= 0]
    neg_idx = order[ts_sorted < 0][::-1]       # toward −∞ from 0
    u0 = B[:, 0]
    cols = [None] * len(ts_in)
    for idx_list in (pos_idx, neg_idx):
        if len(idx_list):
            for i, u in zip(idx_list, march(ts_in[idx_list], u0)):
                cols[int(i)] = u
    U = jnp.stack(cols, axis=-1)
    # No-throw-NaN contract (the NW drivers' failure protocol,
    # reference src/phi_almohy.jl:110-142): real-Leja interpolation
    # DIVERGES when the field of values has imaginary extent comparable
    # to the interval (advection-dominated operators) — surface it,
    # never return NaN silently. One host sync for the whole solve.
    if not bool(jnp.all(jnp.isfinite(U))):
        raise FloatingPointError(
            "phiv_timestep_leja diverged (non-finite result): the "
            "operator's field of values likely has imaginary extent "
            "comparable to its real interval (advection-dominated). "
            "Use phiv_timestep / phiv_timestep_device (Krylov) for "
            "this operator class.")
    return U[:, 0] if scalar_ts else U
