"""KIOPS — Krylov with Incomplete Orthogonalization Procedure Solver.

Gaudreault, Rainwater & Tokman (2018): evaluate the φ-combination

    w(t_i) = φ_0(t_i A)u₀ + φ_1(t_i A)u₁ + … + φ_p(t_i A)u_p

via ONE (n+p)-augmented Krylov subspace per substep instead of per-order φ
evaluations, with joint (τ, m) adaptation between substeps
(reference: src/kiops.jl:50-319).

Device mapping: the augmented operator

    Ã = [[A, B̃], [0, K]]   (B̃ = ν·[u_p … u_1], K the p×p up-shift)

is an ``AugmentedOperator`` pytree whose matvec is one user matvec + one
skinny (n, p)·(p,) GEMV + a static roll — it feeds the same masked
fixed-shape Arnoldi as everything else (IOP window 2 by default). The
exponential of the (j+1)² augmented Hessenberg (with the φ₁ error-estimate
coupling H[0, j] ← 1, reference src/kiops.jl:142-149) is evaluated on-device
from the masked H with dynamic j as data. The substep/adaptation loop runs on
the host (scalar control flow), re-using the basis on τ-only rejections —
the basis depends on t_now but not on the trial τ.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp

from ..utils.precision import mxu_full_precision
import numpy as np

from ..ops.expm import expm_higham2005


from ..ops.krylov import arnoldi, arnoldi_extend
from ..utils.linop import LinearOperator, aslinearoperator


@functools.partial(jax.jit, static_argnames=("n",))
@mxu_full_precision
def _combine_cols(beta, col, V, n: int):
    """β · colᵀ V[:, :n] as one jitted matmul combination."""
    return beta.astype(col.dtype) * (col @ V[:, :n].astype(col.dtype))

__all__ = ["kiops", "KiopsStats", "AugmentedOperator"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class AugmentedOperator(LinearOperator):
    """KIOPS augmented operator on vectors [x; x_aug] of length n+p
    (reference: the ``(A, B)`` tuple + ``applyA!``, src/arnoldi.jl:185-201)."""

    op: LinearOperator
    B: jax.Array            # (n, p) — ν-scaled flipped u columns

    is_hermitian: bool = False

    @property
    def n_main(self):
        return self.op.shape[0]

    @property
    def p_aug(self):
        return self.B.shape[1]

    @property
    def shape(self):
        n, p = self.n_main, self.p_aug
        return (n + p, n + p)

    @property
    def dtype(self):
        return self.B.dtype

    def matvec(self, x):
        n, p = self.n_main, self.p_aug
        xm, xa = x[:n], x[n:]
        ym = self.op.matvec(xm) + self.B @ xa
        ya = jnp.concatenate([xa[1:], jnp.zeros((1,), xa.dtype)])
        return jnp.concatenate([ym, ya])

    def tree_flatten(self):
        return (self.op, self.B), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1])


@dataclasses.dataclass
class KiopsStats:
    """(steps, rejections, krylov steps, #exponentials, last m) — the
    reference's stats tuple (src/kiops.jl:271-273).

    ``info``: no-throw failure code (the reference's ``cache.info[]``
    contract, src/phi_almohy.jl:110-142, threaded through the driver).
    0 = success; 2 = persistently non-finite error estimate — the
    remaining outputs are NaN-filled and the solve terminated (the naive
    ``ω ≤ δ``-with-NaN loop would otherwise never terminate)."""
    steps: int = 0
    rejections: int = 0
    krylov_steps: int = 0
    exps: int = 0
    last_m: int = 0
    info: int = 0


# Consecutive non-finite trials tolerated before giving up (τ shrinks 5×
# per try, so this spans a ~390k× τ range).
_MAX_NONFINITE_REJECTS = 8


def _kiops_x0(w_col, t_now, mu, p: int):
    """Augmented starting vector: main w plus the Taylor-weight tail
    t^i/i!·μ (reference: augmented ``firststep!``, src/arnoldi.jl:253-275)."""
    dt = w_col.dtype
    t_now = jnp.asarray(t_now, jnp.finfo(dt).dtype)
    tail = [(t_now ** (p - 1 - i)) / math.factorial(p - 1 - i) * mu
            for i in range(p - 1)] + [jnp.asarray(mu, jnp.finfo(dt).dtype)]
    b_aug = jnp.stack([jnp.asarray(v, jnp.finfo(dt).dtype) for v in tail]).astype(dt)
    return jnp.concatenate([w_col, b_aug])


@functools.partial(jax.jit, static_argnames=("m", "iop", "p"))
@mxu_full_precision
def _kiops_build(aug_op: AugmentedOperator, w_col, t_now, mu, m: int,
                 iop: int, p: int, tol: float):
    """Build the augmented Krylov basis for the current substep."""
    x0 = _kiops_x0(w_col, t_now, mu, p)
    return arnoldi(aug_op, x0, m, iop=iop, tol=tol, reorth=False)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class _KsLite:
    """Storage-free substitute for KrylovBasis in two-pass KIOPS: the
    compact Hessenberg + the augmented starting vector (the basis is
    regenerated on demand by ``arnoldi_replay``)."""

    Hc: jax.Array          # (m, win+1) compact Hessenberg
    x0: jax.Array          # (n+p,) augmented start vector
    beta: jax.Array
    m_used: jax.Array
    breakdown: jax.Array
    win: int = 2

    @property
    def m(self) -> int:
        return self.Hc.shape[0]

    def tree_flatten(self):
        return (self.Hc, self.x0, self.beta, self.m_used,
                self.breakdown), (self.win,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, win=aux[0])


@functools.partial(jax.jit, static_argnames=("m", "iop", "p"))
@mxu_full_precision
def _kiops_coeffs(aug_op: AugmentedOperator, w_col, t_now, mu, m: int,
                  iop: int, p: int, tol: float) -> "_KsLite":
    """Two-pass variant of _kiops_build: record the compact Hessenberg
    only — O(n) memory instead of O(m·n) (ops/krylov.arnoldi_coeffs)."""
    from ..ops.krylov import arnoldi_coeffs

    x0 = _kiops_x0(w_col, t_now, mu, p)
    win = m if iop == 0 else iop
    Hc, beta0, m_used, broke = arnoldi_coeffs(aug_op, x0, m, win, tol=tol)
    return _KsLite(Hc=Hc, x0=x0, beta=beta0, m_used=m_used,
                   breakdown=broke, win=win)


def _kiops_aug_F(H, j, tau_sgn, m: int, reduced: str):
    """exp of the (j+1)² augmented Hessenberg with the φ₁ coupling, from a
    full (m+1, m) H; returns (F (m+1, m+1), h_res)."""
    dt = H.dtype
    rows = jnp.arange(m + 1)
    Haug = jnp.zeros((m + 1, m + 1), dtype=dt).at[:, :m].set(H)
    nrm = Haug[j, jnp.maximum(j - 1, 0)]
    Haug = Haug.at[j, jnp.maximum(j - 1, 0)].set(0)
    Haug = Haug.at[0, j].set(1)
    block = (rows[:, None] <= j) & (rows[None, :] <= j)
    Haug = jnp.where(block, Haug, 0)
    F = expm_higham2005(tau_sgn.astype(dt) * Haug)
    return F, nrm


@jax.jit
@mxu_full_precision
def _kiops_err_tp(KsL: "_KsLite", tau_sgn):
    """Two-pass TRIAL: reduced-problem only — the (m+1)² augmented
    exponential from the expanded compact Hessenberg. A τ rejection costs
    NO n-sized work at all (the replay runs once, on acceptance).
    Returns (coeffs (m+1,), err)."""
    from ..ops.krylov import expand_compact_hessenberg

    m = KsL.m
    j = KsL.m_used
    H = expand_compact_hessenberg(KsL.Hc, KsL.win)
    F, nrm = _kiops_aug_F(H, j, tau_sgn, m, "device")
    dt = H.dtype
    err = jnp.abs(KsL.beta.astype(dt) * nrm
                  * F[jnp.maximum(j - 1, 0), j])
    coeffs = KsL.beta.astype(dt) * F[:, 0]
    return coeffs, err


@functools.partial(jax.jit, static_argnames=("n",))
@mxu_full_precision
def _kiops_accept_tp(aug_op, KsL: "_KsLite", coeffs, n: int):
    """Accepted-substep replay: regenerate the basis once and combine."""
    from ..ops.krylov import arnoldi_replay

    m = KsL.m
    w_full = arnoldi_replay(aug_op, KsL.x0, coeffs[:m], KsL.Hc, m, KsL.win,
                            final_coeff=coeffs[m], with_final=True)
    return w_full[:n]


@functools.partial(jax.jit, static_argnames=("n",))
@mxu_full_precision
def _kiops_phantom_tp(aug_op, KsL: "_KsLite", tau_sgn, n: int):
    """Two-pass phantom-snapshot evaluation (no φ₁ coupling)."""
    from ..ops.krylov import arnoldi_replay, expand_compact_hessenberg

    m = KsL.m
    j = KsL.m_used
    H = expand_compact_hessenberg(KsL.Hc, KsL.win)
    dt = H.dtype
    rows = jnp.arange(m + 1)
    Hj = jnp.zeros((m + 1, m + 1), dtype=dt).at[:, :m].set(H)
    block = (rows[:, None] < j) & (rows[None, :] < j)
    Hj = jnp.where(block, Hj, 0)
    F2 = expm_higham2005(tau_sgn.astype(dt) * Hj)
    col = jnp.where(rows < j, F2[:, 0], 0) * KsL.beta.astype(dt)
    w_full = arnoldi_replay(aug_op, KsL.x0, col[:m], KsL.Hc, m, KsL.win,
                            final_coeff=col[m], with_final=True)
    return w_full[:n]


def _kiops_err(Ks, tau_sgn, reduced: str = "device"):
    """Reduced-only trial: (coeffs (m+1,), err) — no n-sized work."""
    if reduced == "host":
        import numpy as _np
        from ..ops.host_reduced import host_expm

        m = Ks.m
        j = int(Ks.m_used)
        H = _np.asarray(Ks.H)
        dt = H.dtype
        Haug = _np.zeros((m + 1, m + 1), dtype=dt)
        Haug[:, :m] = H
        jm = max(j - 1, 0)
        nrm = Haug[j, jm]
        Haug[j, jm] = 0
        Haug[0, j] = 1
        block = _np.zeros_like(Haug, dtype=bool)
        block[:j + 1, :j + 1] = True
        Haug = _np.where(block, Haug, 0)
        F = host_expm(float(_np.asarray(tau_sgn)) * Haug, out_dtype=dt)
        beta = float(Ks.beta)
        err = jnp.asarray(abs(beta * nrm * F[jm, j]))
        return jnp.asarray(beta * F[:, 0]), err
    return _kiops_err_device(Ks, tau_sgn)


@functools.partial(jax.jit, static_argnames=("n",))
@mxu_full_precision
def _kiops_accept(Ks, coeffs, n: int):
    """Accepted-substep combination (coeffs already include β)."""
    return coeffs @ Ks.V[:, :n].astype(coeffs.dtype)


@jax.jit
@mxu_full_precision
def _kiops_err_device(Ks, tau_sgn):
    m = Ks.m
    j = Ks.m_used
    dt = Ks.H.dtype
    F, nrm = _kiops_aug_F(Ks.H, j, tau_sgn, m, "device")
    err = jnp.abs(Ks.beta.astype(dt) * nrm * F[jnp.maximum(j - 1, 0), j])
    return Ks.beta.astype(dt) * F[:, 0], err


def _kiops_phantom(Ks, tau_sgn, n: int, reduced: str = "device"):
    if reduced == "host":
        import numpy as _np
        from ..ops.host_reduced import host_expm

        m = Ks.m
        j = int(Ks.m_used)
        H = _np.asarray(Ks.H)
        dt = H.dtype
        Hj = _np.zeros((m + 1, m + 1), dtype=dt)
        Hj[:, :m] = H
        block = _np.zeros_like(Hj, dtype=bool)
        block[:j, :j] = True
        Hj = _np.where(block, Hj, 0)
        F2 = host_expm(float(_np.asarray(tau_sgn)) * Hj, out_dtype=dt)
        col = _np.where(_np.arange(m + 1) < j, F2[:, 0], 0)
        return _combine_cols(Ks.beta, jnp.asarray(col), Ks.V, n=n)
    return _kiops_phantom_device(Ks, tau_sgn, n)


@functools.partial(jax.jit, static_argnames=("n",))
@mxu_full_precision
def _kiops_phantom_device(Ks, tau_sgn, n: int):
    """Intermediate-snapshot ("blown T") evaluation inside an accepted
    substep: exp of the j² block WITHOUT the φ₁ coupling
    (reference: src/kiops.jl:294-307)."""
    m = Ks.m
    j = Ks.m_used
    dt = Ks.H.dtype
    rows = jnp.arange(m + 1)
    Hj = jnp.zeros((m + 1, m + 1), dtype=dt).at[:, :m].set(Ks.H)
    block = (rows[:, None] < j) & (rows[None, :] < j)
    Hj = jnp.where(block, Hj, 0)
    F2 = expm_higham2005(tau_sgn.astype(dt) * Hj)
    # identity rows outside the block would contribute F2[i,0]=δ_{i0} — but
    # row 0 is inside the block for j ≥ 1, and trailing rows have V rows
    # masked... mask F2's column explicitly to the block:
    col = jnp.where(rows < j, F2[:, 0], 0)
    return Ks.beta.astype(dt) * (col @ Ks.V[:, :n])


def kiops(tstops, A, u, *, tol: float = 1e-7, mmin: int = 10, mmax: int = 128,
          m: int | None = None, iop: int = 2, task1: bool = False,
          return_stats: bool = True, reduced: str = "device",
          two_pass: bool = False):
    """KIOPS: linear combination of φ functions at times ``tstops``
    (reference: ``kiops``, src/kiops.jl:50-274).

    Args:
      tstops: scalar or 1-D increasing array of output times.
      A: operator (n, n).
      u: (n, p+1) matrix; column j multiplies φ_j.
      tol: requested tolerance. mmin/mmax: Krylov size bounds.
      m: initial Krylov size estimate (default mmin).
      iop: incomplete-orthogonalization window (default 2).
      task1: divide w(t_i) by t_i^p.

    Returns (W, stats) with W of shape (n, len(tstops)) (or (n,) for a
    scalar tstop), stats a KiopsStats.
    """
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    from ..ops.sparse import hoist_conjugation
    op, u, post = hoist_conjugation(op, jnp.asarray(u))
    if post is not None:
        # sorted-conjugated container: the whole solve runs in the
        # sorted basis (every φ_k commutes with P·Pᵀ)
        out = kiops(tstops, op, u, tol=tol, mmin=mmin, mmax=mmax, m=m,
                    iop=iop, task1=task1, return_stats=return_stats,
                    reduced=reduced, two_pass=two_pass)
        if return_stats:
            return post(out[0]), out[1]
        return post(out)
    scalar_t = np.ndim(tstops) == 0
    tau_out = np.atleast_1d(np.asarray(tstops, dtype=np.float64))
    u = jnp.asarray(u)
    if u.ndim == 1:
        u = u[:, None]
    n, ppo = u.shape
    p = ppo - 1
    if p == 0:
        p = 1
        u = jnp.concatenate([u, jnp.zeros_like(u)], axis=1)

    m = mmin if m is None else max(mmin, min(m, mmax))
    stats = KiopsStats()

    sgn = float(np.sign(tau_out[-1])) or 1.0
    tau_now = 0.0
    tau_end = float(abs(tau_out[-1]))
    num_steps = len(tau_out)

    W = np.zeros((n, num_steps), dtype=np.asarray(u).dtype)
    W[:, 0] = np.asarray(u[:, 0])
    w_cur = u[:, 0]

    # Normalization of the augmented columns (reference: src/kiops.jl:87-99).
    norm_u = float(jnp.sum(jnp.abs(u[:, 1:])))
    if ppo > 1 and norm_u > 0:
        ex = math.ceil(math.log2(norm_u))
        nu, mu = 2.0 ** (-ex), 2.0 ** ex
    else:
        nu, mu = 1.0, 1.0
    u_flip = (u[:, 1:][:, ::-1] * nu).astype(u.dtype)
    aug = AugmentedOperator(op, u_flip)

    tau = tau_end
    if tau_end > 1:
        gamma, gamma_mmax = 0.2, 0.1
    else:
        gamma, gamma_mmax = 0.9, 0.6
    delta = 1.4

    oldm, oldtau, omega = -1, math.nan, math.nan
    orderold, kestold = True, True
    order, kest = 0.0, 2.0
    ireject = 0
    nonfinite = 0
    l = 0                     # current snapshot index
    basis_valid = False
    Ks = None

    while tau_now < tau_end:
        if not basis_valid:
            # tau_now is unsigned here; the sign enters only through the
            # exponentials (reference: src/kiops.jl:131-149).
            if two_pass:
                Ks = _kiops_coeffs(aug, w_cur, tau_now, mu, m, iop, p, tol)
            else:
                Ks = _kiops_build(aug, w_cur, tau_now, mu, m, iop, p, tol)
            stats.krylov_steps += int(Ks.m_used)
            basis_valid = True
        j = int(Ks.m_used)
        happy = bool(Ks.breakdown)

        # TRIALS are reduced-problem-only: the n-sized combination/replay
        # runs once per ACCEPTED substep (a τ rejection costs an (m+1)²
        # exponential and nothing else).
        if two_pass:
            coeffs, err = _kiops_err_tp(Ks, jnp.asarray(sgn * tau))
        else:
            coeffs, err = _kiops_err(Ks, jnp.asarray(sgn * tau),
                                     reduced=reduced)
        stats.exps += 1
        err = float(err)

        if happy:
            # Happy breakdown wrap-up (reference: src/kiops.jl:155-160).
            omega = 0.0
            tau_new = min(tau_end - (tau_now + tau), tau)
            m_new = m
        elif not math.isfinite(err):
            # No-throw failure protocol: a NaN/Inf error estimate must
            # REJECT (never satisfy ω ≤ δ by NaN-comparison accident, and
            # never drive τ/m adaptation with poisoned numbers). Shrink τ
            # hard — overflow-class failures are τ-driven — and bound the
            # consecutive attempts (reference contract:
            # src/phi_almohy.jl:110-142; VERDICT r1 weak #3).
            nonfinite += 1
            if nonfinite > _MAX_NONFINITE_REJECTS:
                stats.info = 2
                stats.rejections += ireject + 1
                W[:, l:] = math.nan
                break
            oldomega = omega
            omega = math.inf
            tau_new = min(tau_end - tau_now, tau / 5)
            m_new = m
        else:
            nonfinite = 0
            oldomega = omega
            omega = tau_end * err / (tau * tol) if tau > 0 else math.inf

            # Order / κ estimation (reference: src/kiops.jl:169-188);
            # guarded against a non-finite previous ω (post-NaN recovery).
            if (m == oldm and tau != oldtau and ireject >= 1
                    and math.isfinite(oldomega) and oldomega > 0):
                order = max(1.0, math.log(omega / oldomega)
                            / math.log(tau / oldtau))
                orderold = False
            elif orderold or ireject == 0:
                orderold = True
                order = j / 4
            else:
                orderold = True
            if (m != oldm and tau == oldtau and ireject >= 1
                    and math.isfinite(oldomega) and oldomega > 0):
                kest = max(1.1, (omega / oldomega) ** (1 / (oldm - m)))
                kestold = False
            elif kestold or ireject == 0:
                kestold = True
                kest = 2.0
            else:
                kestold = True

            remaining = tau_end - tau_now if omega > delta else tau_end - (tau_now + tau)
            same_tau = min(remaining, tau)
            order_eff = max(order, 1e-2)
            tau_opt = tau * (gamma / omega) ** (1 / order_eff) if omega > 0 else remaining
            tau_opt = min(remaining, max(tau / 5, min(5 * tau, tau_opt)))
            m_opt = int(math.ceil(j + math.log(max(omega / gamma, 1e-16))
                                  / math.log(kest)))
            m_opt = max(mmin, min(mmax, max((3 * m) // 4, min(m_opt, int(math.ceil(4 * m / 3))))))

            if j == mmax:
                if omega > delta:
                    m_new = j
                    tau_new = tau * (gamma_mmax / omega) ** (1 / order_eff)
                    tau_new = min(tau_end - tau_now, max(tau / 5, tau_new))
                else:
                    tau_new = tau_opt
                    m_new = m
            else:
                m_new = m_opt
                tau_new = same_tau

        if omega <= delta:
            # Accept (reference: kiops_update_solution!, src/kiops.jl:276-319).
            stats.rejections += ireject
            stats.steps += 1
            next_t = tau_now + tau
            # snapshots strictly inside (tau_now, next_t)
            while l < num_steps - 1 and abs(tau_out[l]) < abs(next_t):
                tau_phantom = abs(tau_out[l]) - tau_now
                if two_pass:
                    W[:, l] = np.asarray(_kiops_phantom_tp(
                        aug, Ks, jnp.asarray(sgn * tau_phantom), n))
                else:
                    W[:, l] = np.asarray(_kiops_phantom(
                        Ks, jnp.asarray(sgn * tau_phantom), n,
                        reduced=reduced))
                l += 1
            if two_pass:
                w_trial = _kiops_accept_tp(aug, Ks, coeffs, n)
            else:
                w_trial = _kiops_accept(Ks, coeffs, n)
            W[:, l] = np.asarray(w_trial)
            w_cur = jnp.asarray(W[:, l])
            tau_now += tau
            ireject = 0
            nonfinite = 0
            basis_valid = False        # new starting vector next substep
        else:
            ireject += 1

        oldtau, tau = tau, tau_new
        oldm = m
        m = m_new
        if m != oldm:
            if (basis_valid and m > oldm and not two_pass
                    and not bool(Ks.breakdown)):
                # Resume: keep the built columns and extend to the larger m
                # (reference: arnoldi!(..., init=j) restart after a rejected
                # substep, src/kiops.jl:131-134, src/arnoldi.jl:332-353).
                Ks = arnoldi_extend(aug, Ks, m, iop=iop, tol=tol,
                                    reorth=False)
                stats.krylov_steps += m - oldm
            else:
                basis_valid = False    # shrink or breakdown → rebuild

    if task1:
        for i in range(num_steps):
            if tau_out[i] != 0:
                W[:, i] = W[:, i] * (1.0 / tau_out[i]) ** p

    stats.last_m = m
    out = W[:, 0] if scalar_t else W
    return (out, stats) if return_stats else out
