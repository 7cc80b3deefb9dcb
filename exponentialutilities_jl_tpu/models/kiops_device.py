"""Device-resident KIOPS — the augmented-subspace driver without host
dispatch latency.

Same architecture as ``models/nw_device.py`` (the NW twin): the whole
substep/rejection control flow of ``kiops`` (models/kiops.py; reference:
src/kiops.jl:129-246) runs as data inside ONE bounded ``lax.while_loop``
program per m bucket — augmented Krylov build, the (j+1)² augmented
exponential per τ trial (reduced-problem cost only), the order/κ
estimation, substep acceptance, phantom snapshots, and the no-throw
failure protocol. The host re-enters only on an m-bucket change.

Differences from the host driver, by design:
* m adaptation happens across buckets (host re-entry) with the in-trace
  cost heuristic requesting the change; the basis is REBUILT at the new
  bucket (the host driver's ``arnoldi_extend`` resume saves a few matvecs
  but would force dynamic shapes).
* the reduced exponentials use ``expm_higham2005`` by default, or the
  solver-free ``expm_taylor`` with ``expm_method="taylor"``, like the NW
  device driver.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils.linop import LinearOperator, aslinearoperator
from ..utils.precision import mxu_full_precision
from .expv import build_subspace
from .kiops import AugmentedOperator, KiopsStats, _kiops_x0
from .timestepping import _MAX_NONFINITE_REJECTS

__all__ = ["kiops_device"]

_M_LADDER = (10, 13, 17, 22, 29, 38, 49, 64, 83, 108, 128)


def _bucket(m, mmin, mmax):
    m = max(mmin, min(m, mmax))
    for b in _M_LADDER:
        if b >= m:
            return max(mmin, min(b, mmax))
    return mmax


def _aug_F(H, j, tau_sgn, m: int, expm_method: str):
    from ..ops.expm import expm_higham2005, expm_taylor
    engine = expm_taylor if expm_method == "taylor" else expm_higham2005
    dt = H.dtype
    rows = jnp.arange(m + 1)
    Haug = jnp.zeros((m + 1, m + 1), dtype=dt).at[:, :m].set(H)
    nrm = Haug[j, jnp.maximum(j - 1, 0)]
    Haug = Haug.at[j, jnp.maximum(j - 1, 0)].set(0)
    Haug = Haug.at[0, j].set(1)
    block = (rows[:, None] <= j) & (rows[None, :] <= j)
    Haug = jnp.where(block, Haug, 0)
    F = engine(tau_sgn.astype(dt) * Haug)
    return F, nrm


def _phantom_col(H, j, tau_sgn, m: int, expm_method: str):
    from ..ops.expm import expm_higham2005, expm_taylor
    engine = expm_taylor if expm_method == "taylor" else expm_higham2005
    dt = H.dtype
    rows = jnp.arange(m + 1)
    Hj = jnp.zeros((m + 1, m + 1), dtype=dt).at[:, :m].set(H)
    block = (rows[:, None] < j) & (rows[None, :] < j)
    Hj = jnp.where(block, Hj, 0)
    F2 = engine(tau_sgn.astype(dt) * Hj)
    return jnp.where(rows < j, F2[:, 0], 0)


@dataclasses.dataclass
class _Kt:
    w: jax.Array            # current substep start vector (n,)
    t: jax.Array
    tau: jax.Array
    oldtau: jax.Array
    omega: jax.Array
    oldomega: jax.Array
    order: jax.Array
    kest: jax.Array
    orderold: jax.Array     # bool
    kestold: jax.Array      # bool
    ireject: jax.Array
    nonfin: jax.Array
    W: jax.Array            # (nt, n) snapshot rows
    snap_done: jax.Array
    steps: jax.Array
    rejections: jax.Array
    krylov: jax.Array
    exps: jax.Array
    want_m: jax.Array
    info: jax.Array

    def astuple(self):
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    @classmethod
    def fromtuple(cls, tup):
        return cls(*tup)


@functools.partial(jax.jit, static_argnames=(
    "p", "m", "iop", "expm_method", "max_steps", "mmax_is_m"))
@mxu_full_precision
def _kiops_device(aug, ts, state_tup, tau_end, tol, sgn, mu,
                  p: int, m: int, iop: int, expm_method: str,
                  max_steps: int, mmax_is_m: bool):
    st0 = _Kt.fromtuple(state_tup)
    n = st0.w.shape[0]
    rdt = jnp.finfo(jnp.result_type(st0.w.dtype, jnp.float32)).dtype
    gamma, gamma_mmax = jnp.where(tau_end > 1, 0.2, 0.9), \
        jnp.where(tau_end > 1, 0.1, 0.6)
    delta = 1.4

    def substep(tup):
        st = _Kt.fromtuple(tup)
        remaining0 = tau_end - st.t
        tau = jnp.minimum(st.tau, remaining0)

        x0 = _kiops_x0(st.w, st.t, mu, p)
        Ks = build_subspace(aug, x0, m, iop=iop, hermitian=False)
        j = Ks.m_used
        happy = Ks.breakdown
        Hm = Ks.H
        beta = Ks.beta.astype(rdt)

        F, nrm = _aug_F(Hm, j, (sgn * tau).astype(rdt), m, expm_method)
        err = jnp.abs(beta * nrm.astype(rdt)
                      * F[jnp.maximum(j - 1, 0), j].astype(rdt))
        bad = jnp.logical_not(jnp.isfinite(err))

        omega_raw = tau_end * err / (tau * tol)
        omega = jnp.where(happy, 0.0,
                          jnp.where(jnp.isfinite(omega_raw), omega_raw,
                                    jnp.inf))

        # ---- order / κ estimation (reference: src/kiops.jl:169-188)
        prev_ok = (jnp.isfinite(st.oldomega) & (st.oldomega > 0)
                   & (st.ireject >= 1))
        tau_changed = st.oldtau != tau
        order_obs = jnp.log(jnp.maximum(omega / st.oldomega, 1e-300)) \
            / jnp.log(jnp.maximum(tau / st.oldtau, 1e-300))
        use_obs = prev_ok & tau_changed & jnp.isfinite(order_obs)
        order = jnp.where(use_obs, jnp.maximum(1.0, order_obs),
                          jnp.where(st.orderold, j.astype(rdt) / 4,
                                    st.order))
        orderold = jnp.logical_not(use_obs)
        kest = jnp.where(st.kestold, 2.0, st.kest)

        remaining = jnp.where(omega > delta, tau_end - st.t,
                              tau_end - (st.t + tau))
        order_eff = jnp.maximum(order, 1e-2)
        tau_opt = tau * (gamma / jnp.maximum(omega, 1e-16)) \
            ** (1.0 / order_eff)
        tau_opt = jnp.minimum(remaining,
                              jnp.maximum(tau / 5,
                                          jnp.minimum(5 * tau, tau_opt)))
        m_opt = jnp.ceil(j.astype(rdt) + jnp.log(
            jnp.maximum(omega / gamma, 1e-16)) / jnp.log(kest)
        ).astype(jnp.int32)
        m_opt = jnp.clip(m_opt, (3 * m) // 4, (4 * m + 2) // 3)

        at_mmax = jnp.asarray(mmax_is_m) & (j == m)
        tau_mmax = tau * (gamma_mmax / jnp.maximum(omega, 1e-16)) \
            ** (1.0 / order_eff)
        tau_mmax = jnp.minimum(tau_end - st.t,
                               jnp.maximum(tau / 5, tau_mmax))
        tau_new = jnp.where(happy,
                            jnp.minimum(tau_end - (st.t + tau), tau),
                            jnp.where(at_mmax & (omega > delta), tau_mmax,
                                      jnp.where(at_mmax, tau_opt, tau)))
        want_m = jnp.where(happy | at_mmax | (omega <= delta)
                           | (m_opt == m) | bad,
                           0, m_opt).astype(jnp.int32)
        # τ-shrink replaces the m request on non-finite estimates.
        tau_new = jnp.where(bad, tau / 5,
                            jnp.where((want_m == 0) & ~happy & ~at_mmax,
                                      jnp.where(omega > delta, tau_opt,
                                                jnp.minimum(remaining, tau)),
                                      tau_new))
        nonfin = jnp.where(bad, st.nonfin + 1, 0)
        failed = nonfin > _MAX_NONFINITE_REJECTS

        accepted = (omega <= delta) & (want_m == 0) & ~failed & ~bad

        # ---- accepted work: combine + phantom snapshots
        coeffs = beta * F[:, 0].astype(rdt)
        w_new = (coeffs.astype(Ks.V.dtype) @ Ks.V[:, :n])

        W, snap_done = st.W, st.snap_done
        nt = ts.shape[0]
        next_t = st.t + tau
        for i in range(nt):
            # snapshots strictly inside (t, next_t); the final snapshot
            # (== tau_end) is w_new itself, written below.
            hit = (accepted & ~snap_done[i] & (ts[i] > st.t)
                   & (ts[i] < next_t - 1e-14 * tau_end))

            def fill(_):
                col = _phantom_col(Hm, j, (sgn * (ts[i] - st.t)).astype(rdt),
                                   m, expm_method)
                return (beta * col.astype(rdt)).astype(Ks.V.dtype) \
                    @ Ks.V[:, :n]

            Wi = lax.cond(hit, fill, lambda _: W[i], None)
            W = W.at[i].set(Wi)
            snap_done = snap_done.at[i].set(snap_done[i] | hit)
        # final/intermediate landing exactly at next_t
        for i in range(nt):
            hit_end = (accepted & ~snap_done[i]
                       & (jnp.abs(ts[i] - next_t) <= 1e-14 * tau_end))
            W = W.at[i].set(jnp.where(hit_end, w_new, W[i]))
            snap_done = snap_done.at[i].set(snap_done[i] | hit_end)

        st = _Kt(
            w=jnp.where(accepted, w_new, st.w),
            t=jnp.where(accepted, next_t, st.t),
            tau=jnp.maximum(tau_new, 1e-300),
            oldtau=tau,
            omega=jnp.where(accepted, jnp.nan, omega),
            oldomega=omega,
            order=order, kest=kest,
            orderold=orderold, kestold=st.kestold,
            ireject=jnp.where(accepted, 0, st.ireject + 1),
            nonfin=nonfin,
            W=W, snap_done=snap_done,
            steps=st.steps + accepted.astype(jnp.int32),
            rejections=st.rejections + (~accepted).astype(jnp.int32),
            krylov=st.krylov + j,
            exps=st.exps + 1,
            want_m=want_m,
            info=jnp.where(failed, 2, st.info).astype(jnp.int32),
        )
        return st.astuple()

    def cond(tup):
        st = _Kt.fromtuple(tup)
        return ((st.t < tau_end * (1 - 1e-14)) & (st.steps < max_steps)
                & (st.want_m == 0) & (st.info == 0))

    return lax.while_loop(cond, substep, st0.astuple())


def kiops_device(ts, A, u, *, m: int = 10, tol: float = 1e-7, iop: int = 2,
                 mmin: int = 10, mmax: int = 128,
                 expm_method: str = "higham2005", task1: bool = False,
                 max_steps: int = 10_000, return_stats: bool = True):
    """KIOPS with the whole adaptive loop resident on device (module doc).

    Same contract as ``kiops``: u (n, p+1) columns [b₀ … b_p], returns the
    φ-combination at the requested times (plus ``KiopsStats``).
    """
    op = aslinearoperator(A) if not isinstance(A, LinearOperator) else A
    scalar_t = np.ndim(ts) == 0
    tau_out = np.atleast_1d(np.asarray(ts, dtype=np.float64))
    u = jnp.asarray(u)
    if u.ndim == 1:
        u = u[:, None]
    n, ppo = u.shape
    p = ppo - 1
    if p == 0:
        p = 1
        u = jnp.concatenate([u, jnp.zeros_like(u)], axis=1)
    rdt = jnp.finfo(jnp.result_type(u.dtype, jnp.float32)).dtype
    sgn = float(np.sign(tau_out[-1])) or 1.0
    tau_end = float(abs(tau_out[-1]))
    nt = len(tau_out)

    # Augmented-column normalization (reference: src/kiops.jl:87-99).
    norm_u = float(jnp.sum(jnp.abs(u[:, 1:])))
    if ppo > 1 and norm_u > 0:
        ex = math.ceil(math.log2(norm_u))
        nu, mu = 2.0 ** (-ex), 2.0 ** ex
    else:
        nu, mu = 1.0, 1.0
    u_flip = (u[:, 1:][:, ::-1] * nu).astype(u.dtype)
    aug = AugmentedOperator(op, u_flip)

    m = _bucket(m, mmin, mmax)
    stats = KiopsStats()
    st = _Kt(
        w=u[:, 0],
        t=jnp.zeros((), rdt), tau=jnp.asarray(tau_end, rdt),
        oldtau=jnp.asarray(np.nan, rdt),
        omega=jnp.asarray(np.nan, rdt), oldomega=jnp.asarray(np.nan, rdt),
        order=jnp.asarray(1.0, rdt), kest=jnp.asarray(2.0, rdt),
        orderold=jnp.asarray(True), kestold=jnp.asarray(True),
        ireject=jnp.zeros((), jnp.int32), nonfin=jnp.zeros((), jnp.int32),
        W=jnp.zeros((nt, n), u.dtype),
        snap_done=jnp.zeros((nt,), bool),
        steps=jnp.zeros((), jnp.int32),
        rejections=jnp.zeros((), jnp.int32),
        krylov=jnp.zeros((), jnp.int32), exps=jnp.zeros((), jnp.int32),
        want_m=jnp.zeros((), jnp.int32), info=jnp.zeros((), jnp.int32),
    )
    ts_dev = jnp.asarray(np.abs(tau_out), rdt)

    for _ in range(32):
        out = _kiops_device(aug, ts_dev, st.astuple(),
                            jnp.asarray(tau_end, rdt),
                            jnp.asarray(tol, rdt), jnp.asarray(sgn, rdt),
                            jnp.asarray(mu, rdt),
                            p=p, m=m, iop=iop, expm_method=expm_method,
                            max_steps=max_steps, mmax_is_m=(m >= mmax))
        st = _Kt.fromtuple(out)
        want = int(st.want_m)
        if want == 0:
            break
        m = _bucket(want, mmin, mmax)
        st = dataclasses.replace(st, want_m=jnp.zeros((), jnp.int32))

    stats.steps = int(st.steps)
    stats.rejections = int(st.rejections)
    stats.krylov_steps = int(st.krylov)
    stats.exps = int(st.exps)
    stats.last_m = m
    stats.info = int(st.info)
    W = np.array(st.W).T
    if stats.info:
        W[:, ~np.asarray(st.snap_done)] = np.nan
    if task1:
        for i in range(nt):
            if tau_out[i] != 0:
                W[:, i] = W[:, i] * (1.0 / tau_out[i]) ** p
    out_arr = W[:, 0] if scalar_t else W
    return (out_arr, stats) if return_stats else out_arr
