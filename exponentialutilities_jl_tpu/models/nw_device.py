"""Device-resident Niesen–Wright adaptive driver — dispatch-latency-free.

``phiv_timestep`` (models/timestepping.py) mirrors the reference's host-side
scalar control flow (src/krylov_phiv_adaptive.jl:308-413): one device
dispatch and one host sync per substep/trial, so small-n adaptive solves
are latency-dominated.

This module re-expresses the SAME accept/reject control flow as data inside
ONE compiled program: a bounded ``lax.while_loop`` over substeps whose body
builds the Krylov subspace, runs a bounded inner rejection loop (τ-only
adaptation — the basis is τ-independent, so a τ trial costs just the
reduced (m+p+1)² exponential), fills snapshots, and accumulates the
solution. The only host round-trips left are per **m-bucket change**: when
the in-trace cost model prefers growing/shrinking m (which changes compiled
shapes), the program exits with ``want_m`` set and the host re-enters at
the new bucket — 0–2 re-dispatches per solve instead of ~60.

The reduced exponentials use ``expm_higham2005`` (or the solver-free
Paterson–Stockmeyer ``expm_taylor`` with ``expm_method="taylor"``) on the
device — no host staging anywhere in the loop.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.phi_dense import phiv_dense
from ..utils.linop import LinearOperator, aslinearoperator
from ..utils.precision import mxu_full_precision
from .expv import build_subspace
from .timestepping import (TimestepStats, _MAX_NONFINITE_REJECTS, _M_BUCKETS,
                           _bucket_m, _compute_W, _initial_tau,
                           _signed_ts_dispatch, _update_u)

__all__ = ["phiv_timestep_device", "expv_timestep_device"]

import numpy as _np

_BUCKETS_NP = _np.asarray(_M_BUCKETS, _np.int32)


def _flops_model(m, tau, n, p, nnz, iop, Hnorm, maxtau, rdt):
    """NW cost model (23) in jnp scalars (host twin: timestepping.py
    ``_estimate_flops``; reference: src/krylov_phiv_adaptive.jl:442-461)."""
    m = m.astype(rdt) if hasattr(m, "astype") else jnp.asarray(m, rdt)
    flops_W = 2 * (p - 1) * (nnz + n)
    flops_u = (2 * p + 1) * n
    iop_eff = iop if iop > 0 else None
    flops_matvec = 2 * m * nnz
    if iop_eff is None:
        flops_vecvec = 3 * m * (m + 1) / 2
    else:
        flops_vecvec = 3.0 * iop_eff * m
    MH = 44 / 3 + 2 * jnp.ceil(jnp.maximum(
        0.0, jnp.log2(jnp.maximum(Hnorm, 1e-300) / 5.37)))
    flops_phiv = MH * (m + p) ** 3
    one = flops_W + flops_u + flops_matvec + flops_vecvec + flops_phiv
    nsub = jnp.ceil(maxtau / jnp.maximum(tau, 1e-300))
    return one * jnp.maximum(nsub, 1.0)


@dataclasses.dataclass
class _St:
    u: jax.Array
    t: jax.Array
    tau: jax.Array
    U: jax.Array            # (nt, n) snapshot rows
    snap_done: jax.Array    # (nt,) bool
    steps: jax.Array
    rejections: jax.Array
    matvecs: jax.Array
    want_m: jax.Array       # 0 = none; else requested bucketed m
    info: jax.Array

    def astuple(self):
        return (self.u, self.t, self.tau, self.U, self.snap_done,
                self.steps, self.rejections, self.matvecs, self.want_m,
                self.info)

    @classmethod
    def fromtuple(cls, tup):
        return cls(*tup)


@functools.partial(jax.jit, static_argnames=(
    "p", "m", "iop", "hermitian", "expm_method", "max_steps",
    "max_rejects", "nnz"))
@mxu_full_precision
def _nw_device(op, B, ts, state_tup, tend, abstol, delta, gamma,
               p: int, m: int, iop: int, hermitian: bool,
               expm_method: str, max_steps: int, max_rejects: int, nnz: int):
    st0 = _St.fromtuple(state_tup)
    n = B.shape[0]
    rdt = jnp.finfo(jnp.result_type(B.dtype, jnp.float32)).dtype
    kk = p + 1
    buckets = jnp.asarray(_BUCKETS_NP)
    # floats: the dense default n² at n = 10M is ~1e14, which overflows
    # the int32 argument parse when x64 is off (measured at the 216³
    # stiff bench); the cost model is a float estimate anyway.
    nnz_eff = float(nnz) if nnz > 0 else float(n) * float(n)

    def reduced_c2(Hm, tau):
        e1 = jnp.zeros((m,), Hm.dtype).at[0].set(1)
        return phiv_dense(tau.astype(Hm.dtype) * Hm, e1, kk,
                          expm_method=expm_method)

    def substep(tup):
        st = _St.fromtuple(tup)
        maxtau = tend - st.t
        tau = jnp.minimum(st.tau, maxtau)
        W = _compute_W(op, st.u, B, st.t, p)
        Ks = build_subspace(op, W[:, p], m, iop=iop, hermitian=hermitian)
        tau = jnp.where(Ks.breakdown, maxtau, tau)
        Hm = Ks.H[:m, :m]
        last = jnp.maximum(Ks.m_used - 1, 0)
        h_res = jnp.abs(Ks.H[last + 1, last]).astype(rdt)
        beta = Ks.beta.astype(rdt)
        Hnorm = jnp.max(jnp.sum(jnp.abs(Ks.H), axis=0)).astype(rdt)

        def eps_of(tau):
            C2 = reduced_c2(Hm, tau)
            return (beta * h_res * tau * jnp.abs(C2[last, kk]).astype(rdt),
                    C2)

        eps, C2 = eps_of(tau)
        omega_raw = (tend / tau) * (eps / abstol)
        omega = jnp.where(jnp.isfinite(omega_raw), omega_raw, jnp.inf)

        # --- bounded rejection loop: τ-only adaptation, reduced-only cost.
        # (eps, eps_old, tau, tau_old, q, omega, trials, nonfin, want_m, rej)
        def rej_cond(c):
            (_, _, _, _, _, omega, trials, nonfin, want_m, _) = c
            return ((omega > delta) & (trials < max_rejects)
                    & (want_m == 0) & (nonfin <= _MAX_NONFINITE_REJECTS))

        def rej_body(c):
            (eps, eps_old, tau, tau_old, q, omega, trials, nonfin,
             want_m, rej) = c
            bad = jnp.logical_not(jnp.isfinite(eps))
            # Non-finite estimate → hard τ shrink (failure protocol).
            tau_bad = tau / 5

            # NW Algorithm 4 (τ branch): observed order q.
            ratio_ok = ((tau_old > tau) & (eps != eps_old) & (eps_old > 0)
                        & (eps > 0) & jnp.isfinite(eps)
                        & jnp.isfinite(eps_old))
            q_new = jnp.where(
                ratio_ok,
                jnp.log(tau / tau_old)
                / jnp.log(jnp.maximum(eps / eps_old, 1e-300)) - 1, q)
            q_new = jnp.clip(q_new, 0.25, 4.0 * m)
            tau_opt = tau * (gamma / omega) ** (1.0 / (q_new + 1.0))
            tau_opt = jnp.minimum(jnp.minimum(
                jnp.maximum(tau_opt, tau / 5), 2 * tau), maxtau)

            # m branch: κ ≈ 2 (the in-device loop cannot vary m, so the
            # reference's observed-κ refinement happens across buckets on
            # the host); request a bucket change when the flop model
            # prefers it.
            kappa = 2.0
            m_est = m + jnp.ceil(
                jnp.log(jnp.maximum(omega / gamma, 1e-16))
                / jnp.log(kappa)).astype(jnp.int32)
            m_est = jnp.clip(m_est, (3 * m) // 4, (4 * m + 2) // 3)
            bidx = jnp.searchsorted(buckets, m_est)
            m_req = buckets[jnp.minimum(bidx, buckets.shape[0] - 1)]
            m_req = jnp.minimum(m_req, n)
            cost_tau = _flops_model(jnp.asarray(m, jnp.int32), tau_opt, n,
                                    p, nnz_eff, iop, Hnorm, maxtau, rdt)
            cost_m = _flops_model(m_req, tau, n, p, nnz_eff, iop, Hnorm,
                                  maxtau, rdt)
            prefer_m = (cost_m < cost_tau) & (m_req != m)

            want_m_new = jnp.where(bad, 0, jnp.where(prefer_m, m_req, 0)
                                   ).astype(jnp.int32)
            tau_new = jnp.where(bad, tau_bad,
                                jnp.where(prefer_m, tau, tau_opt))

            eps_new, _ = eps_of(tau_new)
            omega_new_raw = (tend / tau_new) * (eps_new / abstol)
            omega_new = jnp.where(jnp.isfinite(omega_new_raw),
                                  omega_new_raw, jnp.inf)
            return (eps_new, eps, tau_new, tau, q_new, omega_new,
                    trials + 1, nonfin + bad.astype(jnp.int32),
                    want_m_new, rej + 1)

        (eps, _, tau, _, _, omega, trials, nonfin, want_m, rej) = \
            lax.while_loop(
                rej_cond, rej_body,
                (eps, eps, tau, tau, jnp.asarray(m / 4, rdt), omega,
                 jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                 jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32)))

        failed = nonfin > _MAX_NONFINITE_REJECTS
        accepted = (omega <= delta) & (want_m == 0) & ~failed

        # --- accepted-substep work: the ONLY n-sized operations.
        C2 = reduced_c2(Hm, tau)
        pcol = jnp.einsum("m,mn->n", C2[:, p].astype(Ks.V.dtype),
                          Ks.V[:m]) * beta.astype(Ks.V.dtype)
        u_new = _update_u(W, pcol, tau, p)

        U, snap_done = st.U, st.snap_done
        nt = ts.shape[0]
        for i in range(nt):
            hit = (accepted & ~snap_done[i]
                   & (ts[i] <= st.t + tau + 1e-14 * tend))

            # The snapshot's reduced exponential + n-sized combination run
            # only when this snapshot actually lands in the accepted
            # interval (lax.cond skips the work entirely otherwise).
            def fill(_):
                tau_s = jnp.maximum(ts[i] - st.t, 0.0)
                C2s = reduced_c2(Hm, tau_s)
                pcol_s = jnp.einsum(
                    "m,mn->n", C2s[:, p].astype(Ks.V.dtype),
                    Ks.V[:m]) * beta.astype(Ks.V.dtype)
                return _update_u(W, pcol_s, tau_s, p)

            Ui = lax.cond(hit, fill, lambda _: U[i], None)
            U = U.at[i].set(Ui)
            snap_done = snap_done.at[i].set(snap_done[i] | hit)

        st = _St(
            u=jnp.where(accepted, u_new, st.u),
            t=jnp.where(accepted, st.t + tau, st.t),
            tau=tau,
            U=U, snap_done=snap_done,
            steps=st.steps + accepted.astype(jnp.int32),
            rejections=st.rejections + rej,
            matvecs=st.matvecs + p + m,
            want_m=want_m,
            info=jnp.where(failed, 2, st.info).astype(jnp.int32),
        )
        return st.astuple()

    def cond(tup):
        st = _St.fromtuple(tup)
        return ((st.t < tend * (1 - 1e-14)) & (st.steps < max_steps)
                & (st.want_m == 0) & (st.info == 0))

    out = lax.while_loop(cond, substep, st0.astuple())
    return out


def phiv_timestep_device(ts, A, B, *, m: int = 10, tol: float = 1e-7,
                         opnorm=None, tau: float = 0.0, iop: int = 0,
                         delta: float = 1.2, gamma: float = 0.8,
                         nnz: int = 0, m_max: int = 256,
                         hermitian: bool | None = None,
                         expm_method: str = "higham2005",
                         max_steps: int = 10_000, max_rejects: int = 24,
                         return_stats: bool = False):
    """Niesen–Wright adaptive φ-combination with the accept/reject loop
    RESIDENT ON DEVICE (see module docstring). Same contract as
    ``phiv_timestep(adaptive=True)``: returns U (n, nt) (or (n,) for a
    scalar ts) = Σ_j t^j φ_j(tA) b_j at the requested times.

    Host round-trips occur only when the cost model requests a different
    m bucket; everything else — substeps, τ rejections, snapshots, the
    failure protocol — is one compiled ``lax.while_loop`` program per
    bucket.
    """
    import numpy as np

    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    if nnz == 0 and hasattr(op, "nnz"):
        # sparse containers expose their true matvec cost; the dense n²
        # default misprices (m, τ) adaptation by ~n/nnz_per_row at scale
        nnz = int(op.nnz)
    scalar_ts = np.ndim(ts) == 0
    ts_arr = np.atleast_1d(np.asarray(ts, dtype=np.float64))
    order = np.argsort(ts_arr, kind="stable")
    ts_sorted = ts_arr[order]
    tend = float(ts_sorted[-1])
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    n, ppo = B.shape
    p = ppo - 1
    handled = _signed_ts_dispatch(
        phiv_timestep_device, ts, op, B, return_stats,
        dict(m=m, tol=tol, opnorm=opnorm, tau=tau, iop=iop, delta=delta,
             gamma=gamma, nnz=nnz, m_max=m_max, hermitian=hermitian,
             expm_method=expm_method, max_steps=max_steps,
             max_rejects=max_rejects))
    if handled is not None:
        return handled
    rdt = jnp.finfo(jnp.result_type(B.dtype, jnp.float32)).dtype
    if hermitian is None:
        hermitian = op.is_hermitian
    m = _bucket_m(m, n, m_max)

    b0norm = float(jnp.max(jnp.abs(B[:, 0])))
    if opnorm is None:
        # Matrix-free scale from a first-step Hessenberg 1-norm (one extra
        # dispatch; reference: src/krylov_phiv_adaptive.jl:329-344).
        W0 = _compute_W(op, B[:, 0], B, 0.0, p)
        Ks0 = build_subspace(op, W0[:, p], m, iop=iop, hermitian=hermitian)
        opn = float(jnp.max(jnp.sum(jnp.abs(Ks0.H), axis=0)))
    else:
        opn = float(opnorm)
    abstol = tol * max(opn, 1e-300)
    if tau == 0.0:
        tau = min(tend, max(gamma * _initial_tau(abstol, opn, m, b0norm,
                                                 tend), 1e-300))

    stats = TimestepStats()
    st = _St(
        u=B[:, 0],
        t=jnp.zeros((), rdt), tau=jnp.asarray(tau, rdt),
        U=jnp.zeros((len(ts_sorted), n), B.dtype),
        snap_done=jnp.zeros((len(ts_sorted),), bool),
        steps=jnp.zeros((), jnp.int32), rejections=jnp.zeros((), jnp.int32),
        matvecs=jnp.zeros((), jnp.int32),
        want_m=jnp.zeros((), jnp.int32), info=jnp.zeros((), jnp.int32),
    )
    ts_dev = jnp.asarray(ts_sorted, rdt)

    for _ in range(32):                     # bucket-change bound
        out = _nw_device(op, B, ts_dev, st.astuple(), jnp.asarray(tend, rdt),
                         jnp.asarray(abstol, rdt), delta, gamma,
                         p=p, m=m, iop=iop, hermitian=bool(hermitian),
                         expm_method=expm_method,
                         max_steps=max_steps, max_rejects=max_rejects,
                         nnz=nnz)
        st = _St.fromtuple(out)
        want = int(st.want_m)
        if want == 0:
            break
        m = _bucket_m(want, n, m_max)
        st = dataclasses.replace(st, want_m=jnp.zeros((), jnp.int32))

    stats.steps = int(st.steps)
    stats.rejections = int(st.rejections)
    stats.matvecs = int(st.matvecs)
    stats.final_m = m
    stats.final_tau = float(st.tau)
    stats.info = int(st.info)
    U = np.array(st.U).T            # writable host copy
    if stats.info:
        U[:, ~np.asarray(st.snap_done)] = np.nan
    inv = np.empty(len(ts_arr), dtype=int)
    inv[order] = np.arange(len(ts_arr))
    U = U[:, inv]
    out_arr = U[:, 0] if scalar_ts else U
    if return_stats:
        return out_arr, stats
    from .timestepping import _warn_discarded_info
    _warn_discarded_info(stats, "phiv_timestep_device")
    return out_arr


def expv_timestep_device(ts, A, b, **kwargs):
    """``exp(tA)b`` with the device-resident adaptive driver (p = 0)."""
    b = jnp.asarray(b)
    return phiv_timestep_device(ts, A, b[:, None], **kwargs)
