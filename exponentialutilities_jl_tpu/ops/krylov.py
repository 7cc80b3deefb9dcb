"""Krylov subspace construction — masked fixed-shape Arnoldi / Lanczos.

Redesign of the reference's Krylov layer (reference: src/arnoldi.jl:1-466)
for XLA. Key departures, driven by XLA's static-shape model and accelerator
latency characteristics:

* **Static shapes, dynamic truncation as data.** The reference truncates the
  subspace on happy breakdown (``Ks.m = j``, src/arnoldi.jl:356-361); here V
  and H keep their full (m+1, ·) shapes and a traced ``m_used`` / ``breakdown``
  pair records the effective dimension. Downstream consumers (expv/phiv) mask
  with it; one compiled program covers every breakdown pattern.
* **Batched orthogonalization (CGS/CGS2), not MGS.** The reference's MGS inner
  loop does one ``dot`` + ``axpy`` per prior vector (src/arnoldi.jl:297-300) —
  m sequential device→host latencies on an accelerator. Here the projection
  coefficients come from ONE matmul ``V @ y`` (an (m+1, n)·(n,) GEMV)
  masked to the (I)OP window, optionally iterated twice (CGS2) for
  MGS-grade stability. On a sharded mesh this costs a single ``psum`` per
  iteration instead of m.
* **Row-major basis.** V is stored (m+1, n): each basis vector is a contiguous
  row; both the projection GEMV and the final ``w = βᵀ(expHe @ V)``
  combination are plain matrix products.
* **Lanczos** (Hermitian path, reference src/arnoldi.jl:375-466) uses the
  three-term recurrence with real α/β written into a real H, auto-selected by
  the caller when the operator is Hermitian (reference: src/arnoldi.jl:342).

The happy-breakdown tolerance semantics match the reference: breakdown when
the residual norm drops below ``tol`` (src/arnoldi.jl:356-361).
"""

from __future__ import annotations

import dataclasses
import functools
import jax
import jax.numpy as jnp
from jax import lax

from ..utils.precision import mxu_full_precision

__all__ = ["KrylovBasis", "arnoldi", "arnoldi_extend", "lanczos",
           "lanczos_coeffs", "lanczos_replay", "arnoldi_coeffs",
           "arnoldi_replay", "expand_compact_hessenberg"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class KrylovBasis:
    """Result of an Arnoldi/Lanczos factorization (a pytree).

    Fields (reference analogue: ``KrylovSubspace``, src/arnoldi.jl:54-97):
      V: (m+1, n) orthonormal basis, basis vectors as rows. Rows ≥ m_used+1
         are zero after a happy breakdown.
      H: (m+1, m) Hessenberg (Arnoldi) or symmetric-tridiagonal-extended
         (Lanczos) matrix; real dtype for the Hermitian path.
      beta: ‖b‖₂ of the starting vector.
      m_used: effective subspace dimension (== m unless a happy breakdown).
      breakdown: whether a happy breakdown occurred.
      hermitian: static flag — H is (tri)diagonal from a Lanczos recurrence.
    """

    V: jax.Array
    H: jax.Array
    beta: jax.Array
    m_used: jax.Array
    breakdown: jax.Array
    hermitian: bool = False

    @property
    def m(self) -> int:
        """Allocated subspace dimension (static)."""
        return self.H.shape[1]

    @property
    def n(self) -> int:
        return self.V.shape[1]

    def tree_flatten(self):
        return (self.V, self.H, self.beta, self.m_used, self.breakdown), (self.hermitian,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, hermitian=aux[0])


def _safe_normalize(y, nrm, dtype):
    denom = jnp.where(nrm > 0, nrm, 1).astype(jnp.finfo(dtype).dtype)
    return y / denom


def _pnorm(x, axis_name):
    """2-norm of a (possibly row-sharded) vector: local partial + psum."""
    s = jnp.sum(jnp.real(x.conj() * x))
    if axis_name is not None:
        s = lax.psum(s, axis_name)
    return jnp.sqrt(s)


def _psum_maybe(v, axis_name):
    return v if axis_name is None else lax.psum(v, axis_name)


def _arnoldi_step_fn(op, m: int, win: int, tol: float, reorth: bool,
                     axis_name: str | None):
    """The (jit-traceable) Arnoldi step body, shared by ``arnoldi`` and
    ``arnoldi_extend``. Carry: (V, H, broke, m_used)."""
    rows = jnp.arange(m + 1)

    def step(j, carry):
        V, H, broke, m_used = carry
        dt = V.dtype
        rdt = jnp.finfo(dt).dtype
        y = op.matvec(V[j])
        # Orthogonalization window: i ∈ (j-win, j] (reference: src/arnoldi.jl:297).
        if win < m:
            # True IOP: dot only the `win` windowed basis rows (a dynamic
            # slice), so per-step cost is O(win·n) instead of O(m·n).
            s = jnp.clip(j - win + 1, 0, m + 1 - win)
            Vw = lax.dynamic_slice_in_dim(V, s, win, axis=0)
            wmask = (s + jnp.arange(win)) <= j
            hw = jnp.where(wmask, _psum_maybe(Vw.conj() @ y, axis_name), 0)
            y = y - hw @ Vw
            if reorth:
                hw2 = jnp.where(wmask, _psum_maybe(Vw.conj() @ y, axis_name), 0)
                y = y - hw2 @ Vw
                hw = hw + hw2
            h = lax.dynamic_update_slice(jnp.zeros((m + 1,), dtype=dt),
                                         hw.astype(dt), (s,))
        else:
            mask = (rows <= j) & (rows > j - win)
            h = jnp.where(mask, _psum_maybe(V.conj() @ y, axis_name), 0)
            y = y - h @ V
            if reorth:
                h2 = jnp.where(mask, _psum_maybe(V.conj() @ y, axis_name), 0)
                y = y - h2 @ V
                h = h + h2
        nrm = _pnorm(y, axis_name).astype(rdt)
        now_broke = nrm < tol
        h = h.at[j + 1].set(nrm.astype(dt))

        # Row/column-local predication (NOT a whole-buffer jnp.where): V and
        # H stay loop carries that XLA updates in place — a full-V select
        # here would copy the (m+1, n) basis every iteration.
        active = jnp.logical_not(broke)
        H = H.at[:, j].set(jnp.where(active, h, 0))
        vnext = jnp.where(active & jnp.logical_not(now_broke),
                          _safe_normalize(y, nrm, dt), 0)
        V = V.at[j + 1].set(vnext)
        m_used = jnp.where(active, j + 1, m_used)
        return V, H, broke | now_broke, m_used

    return step


@functools.partial(jax.jit, static_argnames=("m", "iop", "reorth", "axis_name"))
@mxu_full_precision
def arnoldi(op, b, m: int, *, iop: int = 0, tol: float = 1e-7,
            reorth: bool = True, axis_name: str | None = None) -> KrylovBasis:
    """Arnoldi factorization A·V[j] ≈ Σ_i H[i,j]·V[i] with (incomplete)
    classical Gram-Schmidt.

    Args:
      op: a ``LinearOperator`` pytree (the matrix-free contract,
        reference docs/src/interfaces.md); its ``matvec`` is traced.
      b: starting vector (n,).
      m: requested Krylov dimension (static).
      iop: incomplete-orthogonalization window; 0 = full (reference:
        src/arnoldi.jl:354, Koskela 2015).
      tol: happy-breakdown threshold on the residual norm.
      reorth: apply a second CGS pass (CGS2) — MGS-grade orthogonality with
        batched dots; disable for the cheapest (IOP-style) iteration.
      axis_name: when called inside ``shard_map`` with the basis row-sharded
        over a mesh axis, the name of that axis — all inner products and
        norms become one ``psum`` per iteration (the batched-dot design is
        exactly what keeps the sharded path at one collective per step).
    """
    b = jnp.asarray(b)
    n = b.shape[0]
    dt = b.dtype
    rdt = jnp.finfo(dt).dtype

    beta = _pnorm(b, axis_name).astype(rdt)
    v0 = jnp.where(beta > 0, 1.0 / jnp.where(beta > 0, beta, 1), 0.0).astype(rdt) * b

    V = jnp.zeros((m + 1, n), dtype=dt).at[0].set(v0)
    H = jnp.zeros((m + 1, m), dtype=dt)
    win = m if iop == 0 else iop

    step = _arnoldi_step_fn(op, m, win, tol, reorth, axis_name)
    V, H, broke, m_used = lax.fori_loop(
        0, m, step, (V, H, jnp.asarray(beta == 0), jnp.asarray(0, jnp.int32)))
    m_used = jnp.where(beta == 0, 0, m_used).astype(jnp.int32)
    return KrylovBasis(V=V, H=H, beta=beta, m_used=m_used,
                       breakdown=broke, hermitian=False)


@functools.partial(jax.jit,
                   static_argnames=("m_new", "iop", "reorth", "axis_name"))
@mxu_full_precision
def arnoldi_extend(op, Ks: KrylovBasis, m_new: int, *, iop: int = 0,
                   tol: float = 1e-7, reorth: bool = True,
                   axis_name: str | None = None) -> KrylovBasis:
    """Extend an existing Arnoldi factorization from m to ``m_new`` without
    repeating the first m matvecs (the reference's ``arnoldi!(..., init=j)``
    resume used by KIOPS after a rejected substep, src/arnoldi.jl:332-353,
    src/kiops.jl:131-134).

    The kept basis columns and Hessenberg entries are copied into the larger
    static-shape buffers and the iteration continues from step m.
    """
    m_old = Ks.m
    if m_new <= m_old:
        raise ValueError(f"m_new={m_new} must exceed current m={m_old}")
    if Ks.hermitian:
        raise ValueError("arnoldi_extend requires an Arnoldi (non-Lanczos) basis")
    n = Ks.n
    dt = Ks.V.dtype
    V = jnp.zeros((m_new + 1, n), dtype=dt).at[:m_old + 1].set(Ks.V)
    H = jnp.zeros((m_new + 1, m_new), dtype=dt).at[:m_old + 1, :m_old].set(Ks.H)
    win = m_new if iop == 0 else iop

    step = _arnoldi_step_fn(op, m_new, win, tol, reorth, axis_name)
    V, H, broke, m_used = lax.fori_loop(
        m_old, m_new, step, (V, H, Ks.breakdown, Ks.m_used))
    return KrylovBasis(V=V, H=H, beta=Ks.beta, m_used=m_used.astype(jnp.int32),
                       breakdown=broke, hermitian=False)


@functools.partial(jax.jit, static_argnames=("m", "full_reorth", "axis_name"))
@mxu_full_precision
def lanczos(op, b, m: int, *, tol: float = 1e-7,
            full_reorth: bool = False,
            axis_name: str | None = None) -> KrylovBasis:
    """Hermitian Lanczos three-term recurrence (reference:
    src/arnoldi.jl:375-466, ``lanczos!``/``lanczos_step!``).

    H is real (α on the diagonal, β on the sub/super-diagonal — the reference
    also mirrors β onto the superdiagonal, src/arnoldi.jl:464). Set
    ``full_reorth=True`` to re-orthogonalize against the whole basis (one
    batched GEMV) when long recurrences lose orthogonality.
    """
    b = jnp.asarray(b)
    n = b.shape[0]
    dt = b.dtype
    rdt = jnp.finfo(dt).dtype

    beta0 = _pnorm(b, axis_name).astype(rdt)
    v0 = jnp.where(beta0 > 0, 1.0 / jnp.where(beta0 > 0, beta0, 1), 0.0).astype(rdt) * b

    v0 = v0.astype(dt)

    if full_reorth:
        # Full re-orthogonalization must read the whole basis each step;
        # keep the fori_loop formulation (the basis copy is unavoidable).
        V = jnp.zeros((m + 1, n), dtype=dt).at[0].set(v0)
        alphas0 = jnp.zeros((m,), dtype=rdt)
        betas0 = jnp.zeros((m,), dtype=rdt)
        rows = jnp.arange(m + 1)

        def step(j, carry):
            V, vp, vc, alphas, betas, broke, m_used = carry
            y = op.matvec(vc)
            alpha = jnp.real(_psum_maybe(jnp.vdot(vc, y), axis_name)).astype(rdt)
            y = y - alpha.astype(rdt) * vc
            bprev = jnp.where(j >= 1, betas[jnp.maximum(j - 1, 0)], 0.0)
            y = y - bprev.astype(rdt) * vp
            mask = rows <= j
            h2 = jnp.where(mask, _psum_maybe(V.conj() @ y, axis_name), 0)
            y = y - h2 @ V
            nrm = _pnorm(y, axis_name).astype(rdt)
            now_broke = nrm < tol
            active = jnp.logical_not(broke)
            alphas = alphas.at[j].set(jnp.where(active, alpha, 0))
            betas = betas.at[j].set(jnp.where(active, nrm, 0))
            vnext = jnp.where(active & jnp.logical_not(now_broke),
                              _safe_normalize(y, nrm, dt), 0)
            V = V.at[j + 1].set(vnext)
            m_used = jnp.where(active, j + 1, m_used)
            return V, vc, vnext, alphas, betas, broke | now_broke, m_used

        V, _, _, alphas, betas, broke, m_used = lax.fori_loop(
            0, m, step,
            (V, jnp.zeros_like(v0), v0, alphas0, betas0,
             jnp.asarray(beta0 == 0), jnp.asarray(0, jnp.int32)))
    else:
        # Three-term recurrence reads only the (v_prev, v_cur) carries; the
        # basis rows are emitted as lax.scan stacked outputs, which XLA
        # writes in place. (A fori_loop with ``V.at[j+1].set`` can copy
        # the whole (m+1, n) buffer each step.)
        def step(carry, j):
            vp, vc, bprev, broke, m_used = carry
            y = op.matvec(vc)
            alpha = jnp.real(_psum_maybe(jnp.vdot(vc, y), axis_name)).astype(rdt)
            y = y - alpha.astype(rdt) * vc
            y = y - bprev.astype(rdt) * vp
            nrm = _pnorm(y, axis_name).astype(rdt)
            now_broke = nrm < tol
            active = jnp.logical_not(broke)
            alpha_out = jnp.where(active, alpha, 0)
            beta_out = jnp.where(active, nrm, 0)
            vnext = jnp.where(active & jnp.logical_not(now_broke),
                              _safe_normalize(y, nrm, dt), 0)
            m_used = jnp.where(active, (j + 1).astype(jnp.int32), m_used)
            return ((vc, vnext, beta_out, broke | now_broke, m_used),
                    (vnext, alpha_out, beta_out))

        init = (jnp.zeros_like(v0), v0, jnp.zeros((), rdt),
                jnp.asarray(beta0 == 0), jnp.asarray(0, jnp.int32))
        (_, _, _, broke, m_used), (Vrows, alphas, betas) = lax.scan(
            step, init, jnp.arange(m))
        V = jnp.concatenate([v0[None], Vrows], axis=0)
    m_used = jnp.where(beta0 == 0, 0, m_used).astype(jnp.int32)

    # Assemble the (m+1, m) real H: diag α, sub/super-diag β (reference
    # mirrors β onto the superdiagonal at src/arnoldi.jl:464).
    H = jnp.zeros((m + 1, m), dtype=rdt)
    di = jnp.arange(m)
    H = H.at[di, di].set(alphas)
    H = H.at[di + 1, di].set(betas)
    if m >= 2:
        H = H.at[di[:-1], di[:-1] + 1].set(betas[:-1])
    return KrylovBasis(V=V, H=H, beta=beta0, m_used=m_used,
                       breakdown=broke, hermitian=True)


@functools.partial(jax.jit, static_argnames=("m", "axis_name"))
@mxu_full_precision
def lanczos_coeffs(op, b, m: int, *, tol: float = 1e-7,
                   axis_name: str | None = None):
    """Pass 1 of storage-free Lanczos: (alphas, betas, beta0, m_used,
    breakdown) WITHOUT materializing the basis.

    With no (m+1, n) output to stack, the whole recurrence runs at matvec
    speed. Combine with ``lanczos_replay`` for expv.
    """
    b = jnp.asarray(b)
    dt = b.dtype
    rdt = jnp.finfo(dt).dtype
    beta0 = _pnorm(b, axis_name).astype(rdt)
    v0 = (jnp.where(beta0 > 0, 1.0 / jnp.where(beta0 > 0, beta0, 1), 0.0)
          .astype(rdt) * b).astype(dt)

    def step(carry, j):
        vp, vc, bprev, broke, m_used = carry
        y = op.matvec(vc)
        alpha = jnp.real(_psum_maybe(jnp.vdot(vc, y), axis_name)).astype(rdt)
        y = y - alpha.astype(rdt) * vc - bprev.astype(rdt) * vp
        nrm = _pnorm(y, axis_name).astype(rdt)
        now_broke = nrm < tol
        active = jnp.logical_not(broke)
        vnext = jnp.where(active & jnp.logical_not(now_broke),
                          _safe_normalize(y, nrm, dt), 0)
        m_used = jnp.where(active, (j + 1).astype(jnp.int32), m_used)
        return ((vc, vnext, jnp.where(active, nrm, 0), broke | now_broke,
                 m_used),
                (jnp.where(active, alpha, 0), jnp.where(active, nrm, 0)))

    init = (jnp.zeros_like(v0), v0, jnp.zeros((), rdt),
            jnp.asarray(beta0 == 0), jnp.asarray(0, jnp.int32))
    (_, _, _, broke, m_used), (alphas, betas) = lax.scan(
        step, init, jnp.arange(m))
    m_used = jnp.where(beta0 == 0, 0, m_used).astype(jnp.int32)
    return alphas, betas, beta0, m_used, broke


@functools.partial(jax.jit, static_argnames=("m", "axis_name"))
@mxu_full_precision
def lanczos_replay(op, b, coeffs, alphas, betas, m: int, *,
                   axis_name: str | None = None):
    """Pass 2 of storage-free Lanczos: ``w = Σ_j coeffs[j] · v_j`` by
    regenerating the basis vectors from the recorded (α, β) — bitwise the
    same recurrence as pass 1, still no (m+1, n) storage.

    ``coeffs`` may be (m,) → w (n,), or (m, p) → w (n, p) (all p
    combinations accumulated in the single replay — used by the two-pass
    φ-actions)."""
    b = jnp.asarray(b)
    dt = b.dtype
    rdt = jnp.finfo(dt).dtype
    beta0 = _pnorm(b, axis_name).astype(rdt)
    v0 = (jnp.where(beta0 > 0, 1.0 / jnp.where(beta0 > 0, beta0, 1), 0.0)
          .astype(rdt) * b).astype(dt)
    cdt = coeffs.dtype

    def accum(w, vc, cj):
        if coeffs.ndim == 1:
            return w + cj * vc.astype(cdt)
        return w + vc.astype(cdt)[:, None] * cj[None, :]

    def step(carry, j):
        vp, vc, w = carry
        w = accum(w, vc, coeffs[j])
        y = op.matvec(vc)
        y = y - alphas[j].astype(rdt) * vc
        bprev = jnp.where(j >= 1, betas[jnp.maximum(j - 1, 0)], 0.0)
        y = y - bprev.astype(rdt) * vp
        vnext = jnp.where(betas[j] > 0,
                          _safe_normalize(y, betas[j], dt), 0)
        return (vc, vnext, w), None

    w0 = (jnp.zeros_like(v0, dtype=cdt) if coeffs.ndim == 1
          else jnp.zeros(v0.shape + coeffs.shape[1:], dtype=cdt))
    (_, _, w), _ = lax.scan(
        step, (jnp.zeros_like(v0), v0, w0), jnp.arange(m))
    return w


@functools.partial(jax.jit, static_argnames=("m", "win", "axis_name"))
@mxu_full_precision
def arnoldi_coeffs(op, b, m: int, win: int, *, tol: float = 1e-7,
                   axis_name: str | None = None):
    """Pass 1 of storage-free IOP Arnoldi: the compact Hessenberg WITHOUT
    materializing the basis.

    The IOP recurrence only ever reads the last ``win`` basis vectors, so
    the loop carries a (win, n) rolling window instead of the (m+1, n)
    basis (which XLA cannot append to in place — see lanczos_coeffs).

    Returns (Hc, beta0, m_used, breakdown) with Hc (m, win+1) compact
    columns: Hc[j, :win] are the projections onto the window rows
    (oldest→newest) and Hc[j, win] = h_{j+1,j}.
    """
    b = jnp.asarray(b)
    n = b.shape[0]
    dt = b.dtype
    rdt = jnp.finfo(dt).dtype
    beta0 = _pnorm(b, axis_name).astype(rdt)
    v0 = (jnp.where(beta0 > 0, 1.0 / jnp.where(beta0 > 0, beta0, 1), 0.0)
          .astype(rdt) * b).astype(dt)
    W0 = jnp.zeros((win, n), dtype=dt).at[-1].set(v0)

    def step(carry, j):
        W, broke, m_used = carry
        y = op.matvec(W[-1])
        # window rows i correspond to basis indices j-win+1+i; valid ≥ 0.
        wmask = (j - win + 1 + jnp.arange(win)) >= 0
        h = jnp.where(wmask, _psum_maybe(W.conj() @ y, axis_name), 0)
        y = y - h @ W
        nrm = _pnorm(y, axis_name).astype(rdt)
        now_broke = nrm < tol
        active = jnp.logical_not(broke)
        vnext = jnp.where(active & jnp.logical_not(now_broke),
                          _safe_normalize(y, nrm, dt), 0)
        hc = jnp.where(active,
                       jnp.concatenate([h, nrm.astype(dt)[None]]), 0)
        W = jnp.concatenate([W[1:], vnext[None]], axis=0)
        m_used = jnp.where(active, (j + 1).astype(jnp.int32), m_used)
        return (W, broke | now_broke, m_used), hc

    (_, broke, m_used), Hc = lax.scan(
        step, (W0, jnp.asarray(beta0 == 0), jnp.asarray(0, jnp.int32)),
        jnp.arange(m))
    m_used = jnp.where(beta0 == 0, 0, m_used).astype(jnp.int32)
    return Hc, beta0, m_used, broke


def expand_compact_hessenberg(Hc, win: int):
    """(m, win+1) compact columns → full (m+1, m) banded Hessenberg."""
    m = Hc.shape[0]
    H = jnp.zeros((m + 1, m), dtype=Hc.dtype)
    for j in range(m):
        for i in range(win):
            r = j - win + 1 + i
            if r >= 0:
                H = H.at[r, j].set(Hc[j, i])
        H = H.at[j + 1, j].set(Hc[j, win])
    return H


@functools.partial(jax.jit, static_argnames=("m", "win", "axis_name",
                                             "with_final"))
@mxu_full_precision
def arnoldi_replay(op, b, coeffs, Hc, m: int, win: int, *,
                   final_coeff=None, with_final: bool = False,
                   axis_name: str | None = None):
    """Pass 2: ``w = Σ_j coeffs[j] · v_j`` by regenerating the IOP basis
    from the recorded compact Hessenberg — bitwise the same recurrence as
    pass 1. coeffs (m,) or (m, p). With ``with_final=True``,
    ``final_coeff`` additionally weights the (m+1)-th vector v_m (used by
    KIOPS' (m+1)² augmented exponential)."""
    b = jnp.asarray(b)
    n = b.shape[0]
    dt = b.dtype
    rdt = jnp.finfo(dt).dtype
    beta0 = _pnorm(b, axis_name).astype(rdt)
    v0 = (jnp.where(beta0 > 0, 1.0 / jnp.where(beta0 > 0, beta0, 1), 0.0)
          .astype(rdt) * b).astype(dt)
    W0 = jnp.zeros((win, n), dtype=dt).at[-1].set(v0)
    cdt = coeffs.dtype

    def accum(w, vc, cj):
        if coeffs.ndim == 1:
            return w + cj * vc.astype(cdt)
        return w + vc.astype(cdt)[:, None] * cj[None, :]

    def step(carry, j):
        W, w = carry
        w = accum(w, W[-1], coeffs[j])
        y = op.matvec(W[-1])
        y = y - Hc[j, :win] @ W
        nrm = jnp.real(Hc[j, win]).astype(rdt)
        vnext = jnp.where(nrm > 0, _safe_normalize(y, nrm, dt), 0)
        W = jnp.concatenate([W[1:], vnext[None]], axis=0)
        return (W, w), None

    w0 = (jnp.zeros((n,), dtype=cdt) if coeffs.ndim == 1
          else jnp.zeros((n,) + coeffs.shape[1:], dtype=cdt))
    (W, w), _ = lax.scan(step, (W0, w0), jnp.arange(m))
    if with_final:
        w = accum(w, W[-1], jnp.asarray(final_coeff, dtype=cdt))
    return w
