"""Chebyshev matrix-function actions for Hermitian operators.

An alternative to the Krylov path for ``exp(tA) b``, ``φ_k(tA) b``
and general ``f(A) b`` when A is Hermitian with a known (or cheaply
estimated) spectral interval [λmin, λmax]:

    Ã = (A − cI)/h,   c = (λmax+λmin)/2,   h = (λmax−λmin)/2
    f(A) b = Σ_k  b_k · U_k(Ã) b        (Chebyshev-U expansion of f)

with U_k the Chebyshev polynomials of the second kind, generated by the
uniform three-term recurrence ``u_{k+1} = 2Ã u_k − u_{k−1}`` (u_{-1}=0,
u_0=b) — a pure matvec + axpy stream with

  * NO inner products (the Lanczos path pays one ``psum``/latency per
    iteration for α and β; Chebyshev pays none — the coefficients are
    known a priori),
  * ONE pass (the storage-free Lanczos expv needs two: coeffs + replay),
  * perfect SPMD scaling (no per-step collectives beyond the operator's
    own halo exchange).

The degree needed matches the Krylov dimension to within a small factor
(both are near-minimax polynomial approximations of f on the spectrum),
so Chebyshev does ~m matvecs where two-pass Lanczos does 2m, at lower
per-step cost. The price is needing the spectral interval: exact for
structured operators (Gershgorin), or estimated by a short Lanczos run
(``spectral_bounds``) with a residual-padded enclosure.

Coefficients:

  * exp: e^{zx} = Σ_k (I_k(z) − I_{k+2}(z)) U_k(x) (modified-Bessel
    identity; computed with scaled ``scipy.special.ive`` so the e^{tλmax}
    magnitude factors out exactly — no overflow in the selection logic).
  * any f (φ_k, …): Chebyshev-T interpolation coefficients from a cosine
    transform of f sampled at Chebyshev points, converted to the U basis
    by b_k = (a_k − a_{k+2})/2.

The reference has no Chebyshev path (its expv is Krylov-only); this
module is the "beyond" layer the north star asks for — same contract as
``expv``/``phiv`` (reference: src/krylov_phiv.jl:108-151, :519-599) with
the orthogonalization cost designed out.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils.linop import LinearOperator, aslinearoperator
from ..utils.precision import mxu_full_precision

__all__ = ["spectral_bounds", "expv_chebyshev", "phiv_chebyshev",
           "funm_chebyshev", "chebyshev_apply",
           "phiv_timestep_chebyshev"]

_M_MAX = 4096


def spectral_bounds(A, probe=None, *, k: int = 30, seed: int = 0,
                    pad_rel: float = 1e-3, nprobe: int = 2):
    """Enclosure (lo, hi) of a Hermitian operator's spectrum from ``k``
    storage-free Lanczos steps.

    Each extreme Ritz value θ is within its own residual
    β_k·|s_k| (s the last component of T's eigenvector) of an eigenvalue
    of A — and the extreme pairs converge fast, so that residual is tiny
    long before the interior does. The interval is the extreme Ritz
    values padded by their per-pair residuals plus ``pad_rel``·width of
    slack.

    ASSUMPTION: the per-pair residual bounds the distance to the
    NEAREST eigenvalue, not the extremal one — a probe nearly
    orthogonal to an extreme eigenvector gives a tiny residual around
    an interior Ritz value and an interval that fails to enclose. A
    random probe has overlap ~1/√n with every eigenvector, so a single
    probe is almost always fine; to harden it the default takes the
    UNION over ``nprobe`` independent random probes (the overlap
    failure must then repeat independently). When an explicit ``probe``
    is passed it is used alone. Downstream drivers carry a finiteness
    raise so a non-enclosing interval fails loudly, not silently.

    TIGHTNESS MATTERS as much as enclosure for the Chebyshev exp action:
    the truncation floor is relative to e^{t·hi}, so overshooting the top
    of the spectrum by δ multiplies the achievable accuracy by e^{t·δ}
    (padding by the raw β_k — O(‖A‖) for a non-converged recurrence —
    costs e^{t·O(‖A‖)}: measured 4.9e-6 instead of 1.2e-12 on a dense
    n=150 oracle). Failing to enclose, conversely, diverges; the
    per-pair residual is the right middle ground.

    Returns host floats (the interval is a static parameter of the
    subsequent Chebyshev apply).
    """
    from ..ops.krylov import lanczos_coeffs

    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    if not op.is_hermitian:
        raise ValueError("spectral_bounds requires a Hermitian operator")
    n = op.shape[0]
    k = min(k, n)
    if probe is None:
        probes = [jnp.asarray(
            np.random.default_rng(seed + i).standard_normal(n), op.dtype)
            for i in range(max(1, nprobe))]
    else:
        probes = [probe]

    lo = hi = None
    for pv in probes:
        alphas, betas, beta0, m_used, broke = lanczos_coeffs(op, pv, k)
        a = np.asarray(alphas, np.float64)
        b = np.asarray(betas, np.float64)
        mu = int(np.asarray(m_used))
        if mu == 0:
            continue
        T = (np.diag(a[:mu]) + np.diag(b[:mu - 1], 1)
             + np.diag(b[:mu - 1], -1))
        theta, S = np.linalg.eigh(T)
        # per-pair residual ‖A s − θ s‖ = β_k·|last eigenvector component|
        resid = (float(b[mu - 1]) if mu < n else 0.0) * np.abs(S[-1, :])
        lo_i = float(theta[0] - resid[0])
        hi_i = float(theta[-1] + resid[-1])
        lo = lo_i if lo is None else min(lo, lo_i)
        hi = hi_i if hi is None else max(hi, hi_i)
    if lo is None:
        return 0.0, 0.0
    pad = pad_rel * max(hi - lo, abs(hi), abs(lo), 1e-300)
    return lo - pad, hi + pad


def _t_to_u(a):
    """Chebyshev-T series coeffs (a_0 term NOT pre-halved) → U-basis.

    f = a_0 T_0 + Σ_{k≥1} a_k T_k  with  T_0 = U_0, T_k = (U_k − U_{k−2})/2
    → b_0 = a_0 − a_2/2, b_k = (a_k − a_{k+2})/2 (k ≥ 1).
    """
    a = np.asarray(a)
    ext = np.concatenate([a, np.zeros((2,) + a.shape[1:], a.dtype)])
    b = (ext[:-2] - ext[2:]) / 2.0
    b[0] = a[0] - ext[2] / 2.0
    return b


def _exp_ucoeffs(z, tol: float, m_fixed: int | None = None):
    """U-basis coefficients of e^{z x} on x ∈ [−1, 1], truncated so the
    dropped tail is ≤ tol·Σ|coeffs|; returns (coeffs, scale_exponent)
    with the true coefficients = coeffs · e^{scale_exponent} (the shared
    e^{|Re z|} magnitude kept symbolic so selection never overflows).

    Raises if the tail has not decayed below ``tol`` within the degree
    cap — a silently truncated expansion is catastrophically wrong
    (growth spectra need degree ≳ |z|). ``m_fixed`` bypasses both the
    tail selection and the raise (the caller explicitly chose a fixed
    degree and accepts its truncation error)."""
    import scipy.special as sps

    nmax = max(_M_MAX, (m_fixed or 0)) if m_fixed else _M_MAX
    orders = np.arange(nmax + 2)
    if np.iscomplexobj(np.asarray(z)):
        # scipy's ive scales by e^{-|Re z|} for complex arguments too
        iv = sps.ive(orders, complex(z))
        scale = abs(complex(z).real)
    else:
        iv = sps.ive(orders, float(z))
        scale = abs(float(z))
    b = iv[:-2] - iv[2:]                      # I_k − I_{k+2}, scaled
    if m_fixed is not None:
        return b[:m_fixed], scale
    mag = np.abs(b)
    total = mag.sum()
    if total == 0:
        return b[:1], scale
    # smallest m with tail below tolerance (superlinear decay past |z|)
    tail = np.cumsum(mag[::-1])[::-1]
    keep = np.nonzero(tail > tol * total)[0]
    m = int(keep[-1]) + 1 if keep.size else 1
    if m >= _M_MAX:
        raise ValueError(
            f"Chebyshev degree did not converge below the {_M_MAX} cap "
            f"at tol={tol:g} (|z| = {abs(z):.3g}; growth spectra need "
            "degree ≳ |z|) — split t into substeps "
            "(exp(tA) = exp(t/q·A)^q), pass a fixed degree m, or use "
            "the Krylov expv")
    return b[:m], scale


def _full_exp_coeffs(t, lo: float, hi: float, tol: float,
                     m: int | None):
    """Shared overflow-safe assembly of the TRUE e^{t·λ} expansion
    coefficients on [lo, hi] (used by ``expv_chebyshev`` and the
    sharded path — one implementation of the delicate scaling):
    returns (numpy coeffs incl. e^{t·c} amplitude/phase, center,
    halfwidth)."""
    tc = complex(t) if np.iscomplexobj(np.asarray(t)) else float(t)
    c = 0.5 * (hi + lo)
    h = 0.5 * (hi - lo)
    coeffs, scale = _exp_ucoeffs(tc * h, tol, m_fixed=m)
    amp = np.exp(np.real(tc) * c + scale)
    phase = (np.exp(1j * np.imag(tc) * c)
             if np.iscomplexobj(np.asarray(tc)) else 1.0)
    return coeffs * amp * phase, c, h


def _phi_scalar_np(z, p: int):
    """φ_0..φ_p at real/complex sample points z (numpy, f64): series for
    small |z| (the recurrence cancels there), exp-recurrence otherwise."""
    z = np.atleast_1d(np.asarray(
        z, np.complex128 if np.iscomplexobj(z) else np.float64))
    out = np.zeros((p + 1,) + z.shape, z.dtype)
    small = np.abs(z) < 0.5
    # upward recurrence φ_j = (φ_{j−1} − 1/(j−1)!)/z  (safe for |z| ≥ 0.5)
    zb = np.where(small, 1.0, z)
    out[0] = np.exp(z)
    acc = out[0]
    for j in range(1, p + 1):
        acc = (acc - 1.0 / math.factorial(j - 1)) / zb
        out[j] = acc
    # Taylor series φ_j(z) = Σ_i z^i/(i+j)! for the small samples
    if small.any():
        zs = z[small]
        for j in range(p + 1):
            s = np.zeros_like(zs)
            term = np.ones_like(zs) / math.factorial(j)
            for i in range(1, 30):
                s = s + term
                term = term * zs / (i + j)
            out[j][small] = s + term
    return out


def _fun_ucoeffs(f, tol: float, samples: int,
                 m_fixed: int | None = None):
    """U-basis coefficients of f on [−1, 1] via Chebyshev-point cosine
    transform (f may return a (p+1, samples) stack → (m, p+1) coeffs).

    If the coefficient tail has not fallen below ``tol`` near the sample
    count, the transform is ALIASED (the true expansion needs more
    degrees than sampled) — the sample count auto-doubles up to 8×, then
    raises rather than silently returning an inaccurate expansion.
    ``m_fixed`` bypasses tail selection and the guard (explicit
    fixed-degree request)."""
    import scipy.fft as sfft

    M = samples
    if m_fixed is not None:
        M = max(M, 2 * m_fixed)
    for _ in range(4):
        theta = (np.arange(M) + 0.5) * np.pi / M
        x = np.cos(theta)
        fx = np.asarray(f(x))                     # (..., M)
        # a_k = (2/M) Σ_j f(x_j) cos(k θ_j) — exactly DCT-II / M
        if np.iscomplexobj(fx):
            a = (sfft.dct(fx.real, type=2, axis=-1)
                 + 1j * sfft.dct(fx.imag, type=2, axis=-1)) / M
        else:
            a = sfft.dct(fx, type=2, axis=-1) / M
        a = np.moveaxis(np.atleast_2d(a), -1, 0)   # (M, p+1) or (M, 1)
        a[0] = a[0] / 2.0
        b = _t_to_u(a)
        if m_fixed is not None:
            # fixed degree still needs UNALIASED leading coefficients:
            # if the computed expansion is significant near the sample
            # count, the fold-back corrupts b[0..m_fixed-1] too —
            # resample until the tail is negligible (then truncate).
            mags = np.abs(b).max(axis=tuple(range(1, b.ndim)))
            if float(mags[-8:].max()) <= 1e-12 * float(mags.max()):
                return b[:m_fixed]
            M *= 2
            continue
        mag = np.abs(b).max(axis=tuple(range(1, b.ndim)))
        total = mag.sum()
        if total == 0:
            return b[:1]
        tail = np.cumsum(mag[::-1])[::-1]
        keep = np.nonzero(tail > tol * total)[0]
        m = int(keep[-1]) + 1 if keep.size else 1
        if m < M - 2:
            return b[:m]
        M *= 2                                    # aliased — resample
    if m_fixed is not None:
        # explicit fixed degree: the caller accepted truncation error,
        # return the best-effort (least-aliased) truncation
        return b[:m_fixed]
    raise ValueError(
        f"Chebyshev expansion did not converge below tol={tol:g} within "
        f"{M // 2} sample points — the function needs a higher degree "
        "than is practical on this interval (for stiff horizons use the "
        "substepped Krylov drivers)")


@jax.jit
@mxu_full_precision
def _chebyshev_apply_scan(op, b, coeffs, center, inv_h):
    """w = Σ_{k<m} coeffs[k]·U_k(Ã) b with Ã = inv_h·(A − center·I), as a
    matvec-only ``lax.scan`` (no reductions — cf. ops/krylov.lanczos_replay,
    whose recurrence shape this shares). coeffs (m,) or (m, p)."""
    b = jnp.asarray(b)
    rdt = jnp.finfo(b.dtype).dtype
    center = jnp.asarray(center, rdt)
    inv_h = jnp.asarray(inv_h, rdt)
    cdt = coeffs.dtype

    def accum(w, uc, cj):
        if coeffs.ndim == 1:
            return w + cj * uc.astype(cdt)
        return w + uc.astype(cdt)[:, None] * cj[None, :]

    def step(carry, cj):
        up, uc, w = carry
        w = accum(w, uc, cj)
        # u_{k+1} = 2Ã u_k − u_{k−1} (u_{−1} = 0 makes step 0 uniform:
        # U_1 = 2Ã U_0)
        y = (2.0 * inv_h) * (op.matvec(uc) - center * uc) - up
        return (uc, y, w), None

    # w0 derived from b (not a fresh zeros) so shard_map varying-axis
    # types match between carry input and output.
    z = (b * 0).astype(cdt)
    w0 = z if coeffs.ndim == 1 else jnp.broadcast_to(
        z[:, None], b.shape + coeffs.shape[1:])
    (_, _, w), _ = lax.scan(step, (jnp.zeros_like(b), b, w0), coeffs)
    return w


def chebyshev_apply(A, b, ucoeffs, bounds):
    """``Σ_k ucoeffs[k]·U_k(Ã) b`` for Ã the affine map of A onto the
    interval ``bounds``. ucoeffs (m,) or (m, p) (all p combinations in
    one matvec stream, like ops/krylov.lanczos_replay)."""
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    from ..ops.sparse import hoist_conjugation
    op, b, post = hoist_conjugation(op, b)
    if post is not None:
        # sorted-conjugated container: the whole U_k recurrence runs in
        # the sorted basis (polynomials commute with the conjugation)
        return post(chebyshev_apply(op, b, ucoeffs, bounds))
    lo, hi = bounds
    c = 0.5 * (hi + lo)
    h = 0.5 * (hi - lo)
    if h <= 0:
        raise ValueError(f"empty spectral interval {bounds}")
    coeffs = jnp.asarray(ucoeffs)
    return _chebyshev_apply_scan(op, jnp.asarray(b), coeffs, c, 1.0 / h)


def _check_finite(U, what: str):
    """No-silent-NaN protocol for the Chebyshev drivers (the same
    single-sync guard phiv_timestep_leja carries): a user-supplied or
    mis-estimated spectral interval that fails to enclose the spectrum
    makes the U_k recurrence diverge — surface it, never return
    inf/NaN silently. One host sync per driver call."""
    if not bool(jnp.all(jnp.isfinite(U))):
        raise FloatingPointError(
            f"{what} diverged (non-finite result): check that the "
            "spectral bounds enclose A's spectrum (pass bounds=(lo, hi) "
            "from a trusted source, or widen them), or use the Krylov "
            "path (expv/phiv/phiv_timestep)")
    return U


def _resolve_bounds(op, bounds):
    if bounds is not None:
        return float(bounds[0]), float(bounds[1])
    hint = getattr(op, "spectral_bounds_hint", None)
    if callable(hint):
        bh = hint()
        if bh is not None:
            return float(bh[0]), float(bh[1])
    return spectral_bounds(op)


def expv_chebyshev(t, A, b, *, bounds=None, m: int | None = None,
                   tol: float = 1e-7):
    """``exp(tA) b`` for Hermitian A by a Chebyshev expansion — single
    pass, no inner products (module docstring). ``t`` may be complex
    (complex coefficients over the real recurrence, like the reference's
    complex-t expv, src/krylov_phiv.jl:225-253).

    Args:
      bounds: (λmin, λmax) enclosure of A's spectrum; None → operator
        hint or a short-Lanczos estimate (``spectral_bounds``).
      m: fixed degree; None → chosen from the coefficient tail at `tol`.
      tol: relative truncation tolerance for the auto degree.
    """
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    if not op.is_hermitian:
        raise ValueError("expv_chebyshev requires a Hermitian operator "
                         "(use expv for general A)")
    b = jnp.asarray(b)
    lo, hi = _resolve_bounds(op, bounds)
    if hi - lo <= 0:                           # A = cI exactly
        tc = complex(t) if np.iscomplexobj(np.asarray(t)) else float(t)
        val = jnp.asarray(np.exp(tc * 0.5 * (hi + lo)))
        return val.astype(jnp.result_type(b.dtype, val.dtype)) * b
    full, c, h = _full_exp_coeffs(t, lo, hi, tol, m)
    cdt = jnp.result_type(b.dtype,
                          jnp.complex64 if np.iscomplexobj(full)
                          else b.dtype)
    return _check_finite(
        chebyshev_apply(op, b, jnp.asarray(full, cdt), (lo, hi)),
        "expv_chebyshev")


def phiv_chebyshev(t, A, b, k: int, *, bounds=None, m: int | None = None,
                   tol: float = 1e-7, samples: int = 1024):
    """``[φ_0(tA)b … φ_k(tA)b]`` (n, k+1) for Hermitian A — ALL orders in
    one matvec stream (the Krylov path needs the augmented reduced
    problem per order, reference src/krylov_phiv.jl:553-599; here each
    order is just one more coefficient column)."""
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    if not op.is_hermitian:
        raise ValueError("phiv_chebyshev requires a Hermitian operator")
    b = jnp.asarray(b)
    lo, hi = _resolve_bounds(op, bounds)
    tc = complex(t) if np.iscomplexobj(np.asarray(t)) else float(t)
    c = 0.5 * (hi + lo)
    h = 0.5 * (hi - lo)
    if h <= 0:
        vals = _phi_scalar_np(np.asarray([tc * c]), k)[:, 0]
        return jnp.stack([jnp.asarray(v) * b for v in vals], axis=-1)
    coeffs = _fun_ucoeffs(lambda x: _phi_scalar_np(tc * (c + h * x), k),
                          tol, samples, m_fixed=m)     # (m, k+1)
    cdt = jnp.result_type(b.dtype,
                          jnp.complex64 if np.iscomplexobj(coeffs)
                          else b.dtype)
    return _check_finite(
        chebyshev_apply(op, b, jnp.asarray(coeffs, cdt), (lo, hi)),
        "phiv_chebyshev")


@functools.partial(jax.jit, static_argnames=("m",))
@mxu_full_precision
def _chebyshev_combination_scan(op, Bt, C, center, inv_h, m: int):
    """W[s] = Σ_k Σ_j C[k,s,j]·U_k(Ã) Bt[j] — the stacked-column
    recurrence: one pass, (p+1) matvecs per term, a small (nt,p+1)@
    (p+1,n) matmul per step folds every snapshot's combination."""
    rdt = jnp.finfo(Bt.dtype).dtype
    center = jnp.asarray(center, rdt)
    inv_h = jnp.asarray(inv_h, rdt)
    nt = C.shape[1]
    cdt = C.dtype

    mv = jax.vmap(op.matvec)

    def step(carry, Ck):
        Up, Uc, W = carry
        W = W + Ck.astype(cdt) @ Uc.astype(cdt)
        Y = (2.0 * inv_h) * (mv(Uc) - center * Uc) - Up
        return (Uc, Y, W), None

    W0 = jnp.zeros((nt, Bt.shape[1]), cdt)
    (_, _, W), _ = lax.scan(step, (jnp.zeros_like(Bt), Bt, W0), C)
    return W


def phiv_timestep_chebyshev(ts, A, B, *, bounds=None, tol: float = 1e-7,
                            m: int | None = None, samples: int = 1024):
    """u(t) = Σ_j t^j φ_j(tA) b_j at snapshot times ``ts`` for Hermitian
    A — the Niesen–Wright linear-combination problem (reference:
    ``phiv_timestep!``, src/krylov_phiv_adaptive.jl:220-413) solved in
    ONE Chebyshev pass: no substepping, no rejection loops, no
    orthogonalization, every snapshot folded into the same recurrence as
    extra coefficient rows.

    Why this works even for stiff decay problems: the φ_j(tλ) of a
    decay semigroup have Chebyshev-U tails that cut off at degree
    O(√(t·‖A‖·ln(1/tol))) — the same polynomial-degree class a
    substepped Krylov driver pays in total matvecs, but here as a
    single jitted scan with a-priori (coefficient-tail) error control
    instead of per-substep a-posteriori estimates. The Krylov drivers
    remain the tool for non-Hermitian operators and for relative
    accuracy on growing modes.

    Args:
      ts: scalar or 1-D array of output times.
      A: Hermitian operator. B: (n, p+1) columns b_0..b_p.
      bounds / tol / m / samples: as in ``funm_chebyshev``.

    Returns U (n, len(ts)) (or (n,) for scalar ts), matching
    ``phiv_timestep``.
    """
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    if not op.is_hermitian:
        raise ValueError("phiv_timestep_chebyshev requires a Hermitian "
                         "operator (use phiv_timestep)")
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    p = B.shape[1] - 1
    scalar_ts = np.ndim(ts) == 0
    ts_arr = np.atleast_1d(np.asarray(ts, np.float64))
    nt = len(ts_arr)
    lo, hi = _resolve_bounds(op, bounds)
    c = 0.5 * (hi + lo)
    h = 0.5 * (hi - lo)

    if h <= 0:
        cols = []
        for t in ts_arr:
            vals = _phi_scalar_np(np.asarray([t * c]), p)[:, 0]
            wj = sum((t ** j) * float(vals[j]) * B[:, j]
                     for j in range(p + 1))
            cols.append(wj)
        U = jnp.stack(cols, axis=-1)
        return U[:, 0] if scalar_ts else U

    def f(x):
        # stacked (nt*(p+1), M): rows (s, j) = t_s^j · φ_j(t_s·λ(x))
        out = []
        for t in ts_arr:
            vals = _phi_scalar_np(t * (c + h * x), p)      # (p+1, M)
            out.append(vals * (t ** np.arange(p + 1))[:, None])
        return np.concatenate(out, axis=0)

    C = _fun_ucoeffs(f, tol, samples, m_fixed=m)     # (m, nt*(p+1))
    C = C.reshape(len(C), nt, p + 1)
    cdt = jnp.result_type(B.dtype,
                          jnp.complex64 if np.iscomplexobj(C) else B.dtype)
    Cj = jnp.asarray(C, cdt)
    W = _chebyshev_combination_scan(op, B.T, Cj,
                                    c, 1.0 / h, len(C))
    U = _check_finite(W.T, "phiv_timestep_chebyshev")     # (n, nt)
    return U[:, 0] if scalar_ts else U


def funm_chebyshev(f, A, b, *, bounds=None, m: int | None = None,
                   tol: float = 1e-7, samples: int = 1024):
    """``f(A) b`` for Hermitian A and ANY scalar function f — beyond the
    reference's exp/φ repertoire (cosm/sincm/sqrtm actions, spectral
    filters, …). ``f`` is a numpy-vectorized callable evaluated at
    Chebyshev points of the spectral interval on the host; the device
    work is the same matvec-only recurrence as ``expv_chebyshev``."""
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    if not op.is_hermitian:
        raise ValueError("funm_chebyshev requires a Hermitian operator")
    b = jnp.asarray(b)
    lo, hi = _resolve_bounds(op, bounds)
    c = 0.5 * (hi + lo)
    h = 0.5 * (hi - lo)
    if h <= 0:
        return jnp.asarray(np.asarray(f(np.asarray([c])))[..., 0]) * b
    coeffs = _fun_ucoeffs(lambda x: np.asarray(f(c + h * x)), tol,
                          samples, m_fixed=m)
    if coeffs.ndim == 2 and coeffs.shape[1] == 1:
        coeffs = coeffs[:, 0]
    cdt = jnp.result_type(b.dtype,
                          jnp.complex64 if np.iscomplexobj(coeffs)
                          else b.dtype)
    return chebyshev_apply(op, b, jnp.asarray(coeffs, cdt), (lo, hi))
