"""Drive the library's main path once on one GPU and check every result.

Six phases run in one process, through the public entry points and the
default engine choice, at BASELINE.json's sizes:

1. dense 100x100: ``expm``, ``phi(A, 3)``, ``expv(m=40)`` and the
   eig-based ``expm_diagonalization`` under ``jit``;
2. 1-D Laplacian, n = 1e5: ``expv(two_pass=True)``, ``expv``,
   ``expv_chebyshev``;
3. 2-D Poisson, n = 1e6: ``phiv(1e-4, A, b, 3, m=30)``;
4. stiff advection-diffusion, n = 2000: ``phiv_timestep(adaptive=True)``,
   ``kiops``, ``phiv_timestep_device``, ``kiops_device``;
5. 3-D Laplacian, 216^3 (10.08M rows): ``expv(m=20)``,
   ``expv(two_pass=True)``, ``expv_chebyshev``;
6. 2-D reaction-diffusion u' = nu*Lap(u) + u - u^3 at 1024^2:
   ``exprb43_device(adaptive=True)`` against the host ``exprb43``.

Phases 1-3, 5 and 6 run in float32 and float64. A last phase times the
plain XLA recurrences and SpMVs that hand-written kernels would have to
beat (ROADMAP R1), at their hot shapes, with the bytes per step each must
move and their share of the card's HBM bandwidth.

``--four-cards`` runs only the row-partitioned 216^3 Laplacian on four
GPUs (``expv_sharded``, ``expv_sharded(two_pass=True)``,
``expv_chebyshev_sharded``, GSPMD ``phiv_timestep_device``) and compares
each with the spectral oracle and with the same solve on one card.

Oracles are exact f64 answers computed on the host: scipy for the dense
and 1-D problems, the dense augmented ``expm`` for phase 4, and the
sine-basis diagonalisation of the Dirichlet Kronecker sums for phases 3
and 5 (every phi order, at the timed size).

Run from the repository root::

    python chip_smoke.py              # one card
    python chip_smoke.py --four-cards # four cards

Each check prints one JSON line; an error above its tolerance raises.
The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
The script exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Relative-error tolerances against the exact f64 oracles.
#  * float64: BASELINE.json's target class (1e-10).
#  * float32: unit roundoff 6e-8 grows with the Krylov/Chebyshev degree
#    and with n-long reductions; the library traces every matmul at
#    "highest" precision (utils/precision.py), so no TF32 rounding enters.
#    1e-5 leaves two orders of margin over what the CPU reaches.
TOL = {"float32": 1e-5, "float64": 1e-10}
# Phase 6 compares two drivers of one method on one problem, not a driver
# with an oracle. f64: 1e-9, the device/host contract that
# tests/test_integrators.py pins on the CPU; f32: the f32 class above.
RD_TOL = {"float32": TOL["float32"], "float64": 1e-9}
# Four-card phase: the largest per-card peak of device memory may exceed
# the smallest by this factor (every card holds the same n/4 rows).
PEAK_SPREAD = 1.25

# Peak HBM bandwidth by device_kind (NVIDIA H100 SXM data sheet).
HBM_PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _timed(fn, reps: int = 3):
    from exponentialutilities_jl_tpu.utils.profiling import timed
    return timed(fn, reps)


def _rel(x, ref) -> float:
    x = np.asarray(x, np.float64 if not np.iscomplexobj(x) else np.complex128)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def check(phase: str, case: str, dtype: str, err: float, tol: float,
          first: float | None = None, warm: float | None = None,
          **extra) -> dict:
    """Print one result line and raise when ``err`` misses ``tol``."""
    rec = {"phase": phase, "case": case, "dtype": dtype, "rel_err": err,
           "tol": tol}
    if first is not None:
        rec["first_call_s"] = first
        rec["warm_s"] = warm
        rec["compile_s_est"] = None if warm is None else first - warm
    rec["peak_bytes_in_use"] = _peak_bytes()
    rec.update(extra)
    _emit(rec)
    if not (err <= tol):
        raise AssertionError(f"{phase}/{case}/{dtype}: relative error "
                             f"{err:.3e} exceeds {tol:.1e}")
    return rec


# --------------------------------------------------------------- oracles

def phi_scalar(z, k: int):
    """phi_0..phi_k at real points z (f64 numpy): Taylor series where
    |z| < 1 (the recurrence cancels there), the upward recurrence
    phi_j = (phi_{j-1} - 1/(j-1)!)/z elsewhere. Shape (k+1,) + z.shape."""
    z = np.asarray(z, np.float64)
    out = np.empty((k + 1,) + z.shape)
    small = np.abs(z) < 1.0
    zb = np.where(small, 1.0, z)
    acc = np.exp(z)
    out[0] = acc
    for j in range(1, k + 1):
        acc = (acc - 1.0 / math.factorial(j - 1)) / zb
        out[j] = acc
    if small.any():
        zs = z[small]
        for j in range(k + 1):
            term = np.full(zs.shape, 1.0 / math.factorial(j))
            s = np.zeros(zs.shape)
            for i in range(1, 40):
                s = s + term
                term = term * zs / (i + j)
            out[j][small] = s
    return out


def _second_difference_eig(n: int):
    T = (np.diag(np.full(n, -2.0)) + np.diag(np.ones(n - 1), 1)
         + np.diag(np.ones(n - 1), -1))
    return np.linalg.eigh(T)


def spectral_phiv(t: float, shape, b, k: int):
    """[phi_0(tA)b ... phi_k(tA)b] (n, k+1) in f64 for A the Dirichlet
    Laplacian (second difference with unit spacing along every axis) on
    the row-major grid ``shape``: diagonalised axis by axis in the sine
    basis, exact to f64 roundoff at any size."""
    eigs = [_second_difference_eig(s) for s in shape]
    X = np.asarray(b, np.float64).reshape(shape)
    for (_, S) in eigs:                       # forward: X <- S^T along axis
        X = np.tensordot(X, S, axes=([0], [0]))
    lam = np.zeros(shape)
    for ax, (w, _) in enumerate(eigs):
        lam = lam + w.reshape([-1 if a == ax else 1
                               for a in range(len(shape))])
    ph = phi_scalar(t * lam, k)
    cols = []
    for j in range(k + 1):
        Y = ph[j] * X
        for (_, S) in eigs:                   # back: Y <- S along axis
            Y = np.tensordot(Y, S, axes=([0], [1]))
        cols.append(Y.reshape(-1))
    return np.stack(cols, axis=1)


def dense_phi_stack(A, k: int):
    """[phi_0(A) ... phi_k(A)] (k+1, n, n) from one exponential of the
    block matrix [[A, I, 0..], [0, 0, I..], ...] (f64)."""
    import scipy.linalg as sla
    n = A.shape[0]
    N = (k + 1) * n
    M = np.zeros((N, N))
    M[:n, :n] = A
    for j in range(k):
        M[j * n:(j + 1) * n, (j + 1) * n:(j + 2) * n] = np.eye(n)
    E = sla.expm(M)
    return np.stack([E[:n, j * n:(j + 1) * n] for j in range(k + 1)])


# ---------------------------------------------------------------- phases

DTYPES = ("float32", "float64")


def phase_dense(n: int = 100):
    """Dense 100x100: expm, phi(A, 3), expv(m=40), jit(expm_diagonalization)."""
    import jax
    import jax.numpy as jnp
    import scipy.linalg as sla

    import exponentialutilities_jl_tpu as eu

    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n)) / 10
    b = rng.standard_normal(n)
    for dt in DTYPES:
        Aj, bj = jnp.asarray(A, dt), jnp.asarray(b, dt)
        A64, b64 = np.asarray(Aj, np.float64), np.asarray(bj, np.float64)
        E = sla.expm(A64)
        X, f, w = _timed(lambda: eu.expm(Aj))
        check("dense", "expm", dt, _rel(X, E), TOL[dt], f, w)
        Pk, f, w = _timed(lambda: eu.phi(Aj, 3))
        check("dense", "phi_k3", dt, _rel(Pk, dense_phi_stack(A64, 3)),
              TOL[dt], f, w)
        v, f, w = _timed(lambda: eu.expv(1.0, Aj, bj, m=40))
        check("dense", "expv_m40", dt, _rel(v, E @ b64), TOL[dt], f, w)
        diag = jax.jit(eu.expm_diagonalization)
        X, f, w = _timed(lambda: diag(Aj))
        check("dense", "expm_diagonalization_jit", dt, _rel(X, E), TOL[dt],
              f, w)


def phase_laplacian_1d(n: int = 100_000, t: float = 0.5):
    """1-D Laplacian: expv(two_pass), expv (basis), expv_chebyshev."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from scipy.sparse.linalg import expm_multiply

    import exponentialutilities_jl_tpu as eu

    b = np.random.default_rng(1).standard_normal(n)
    A = sp.diags([np.ones(n - 1), -2 * np.ones(n), np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    for dt in DTYPES:
        op = eu.laplacian_nd_stencil(n, dtype=dt)
        bj = jnp.asarray(b, dt)
        ref = expm_multiply(t * A, np.asarray(bj, np.float64))
        cheb_tol = 1e-14 if dt == "float64" else 1e-7
        for case, fn in (
                ("expv_two_pass_m30",
                 lambda: eu.expv(t, op, bj, m=30, two_pass=True)),
                ("expv_m30", lambda: eu.expv(t, op, bj, m=30)),
                ("expv_chebyshev",
                 lambda: eu.expv_chebyshev(t, op, bj, tol=cheb_tol))):
            v, f, w = _timed(fn)
            check("laplacian_1d", case, dt, _rel(v, ref), TOL[dt], f, w,
                  n=n)


def phase_poisson_2d(nx: int = 1000, t: float = 1e-4, k: int = 3):
    """2-D Poisson: phiv(t, A, b, 3, m=30), every order against the
    sine-basis oracle."""
    import jax.numpy as jnp

    import exponentialutilities_jl_tpu as eu

    n = nx * nx
    b = np.random.default_rng(2).standard_normal(n)
    for dt in DTYPES:
        op = eu.poisson_2d(nx, nx, dtype=dt)
        bj = jnp.asarray(b, dt)
        ref = spectral_phiv(t, (nx, nx), np.asarray(bj, np.float64), k)
        W, f, w = _timed(lambda: eu.phiv(t, op, bj, k, m=30))
        W = np.asarray(W, np.float64)
        errs = [_rel(W[:, j], ref[:, j]) for j in range(k + 1)]
        check("poisson_2d", "phiv_k3_m30", dt, max(errs), TOL[dt], f, w,
              n=n, rel_err_by_order=errs)


def phase_advdiff(n: int = 2000, t: float = 1e-4, tol: float = 1e-7,
                  bound: float = TOL["float64"]):
    """Stiff advection-diffusion (f64): NW and KIOPS, host and device,
    asked for ``tol`` (BASELINE config 4) and held to ``bound``.

    The drivers stop on their own error estimate, so the f64 class is not
    guaranteed by ``tol``; at n = 2000 every driver reaches it (KIOPS is
    the worst, 3.9e-11 on an H100). At small n KIOPS stops near 8e-9, so
    a CPU run at such a size passes ``bound=tol``."""
    import jax.numpy as jnp
    import scipy.linalg as sla

    import exponentialutilities_jl_tpu as eu

    op = eu.advection_diffusion_1d(n, peclet=10.0, dtype=jnp.float64)
    b = np.random.default_rng(3).standard_normal(n)
    B = jnp.asarray(np.stack([b, 0.1 * b], axis=1))
    # w = exp(tA) b + t*phi_1(tA)(0.1 b): the dense augmented exponential
    Ad = np.asarray(op.to_dense(), np.float64)
    F = sla.expm(np.block([[t * Ad, t * 0.1 * b[:, None]],
                           [np.zeros((1, n + 1))]]))
    ref = sla.expm(t * Ad) @ b + F[:n, n]
    cases = (
        ("phiv_timestep_adaptive",
         lambda: eu.phiv_timestep([t], op, B, adaptive=True, tol=tol,
                                  m=20)[:, 0]),
        ("kiops", lambda: eu.kiops([t], op, B, tol=tol)[0].ravel()),
        ("phiv_timestep_device",
         lambda: eu.phiv_timestep_device([t], op, B, tol=tol, m=20)[:, 0]),
        ("kiops_device",
         lambda: eu.kiops_device([t], op, B, tol=tol)[0].ravel()),
    )
    for case, fn in cases:
        v, f, w = _timed(fn)
        check("advdiff", case, "float64", _rel(v, ref), bound, f, w,
              n=n, driver_tol=tol)


def _memory_analysis(fn, *args) -> dict:
    import jax
    ma = jax.jit(fn).lower(*args).compile().memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: getattr(ma, k, None) for k in keys}


def phase_laplacian_3d(nx: int = 216, t: float = 0.05, m: int = 20):
    """3-D Laplacian (nx^3 rows): expv (basis), expv(two_pass),
    expv_chebyshev, with the compiled memory of both Krylov forms."""
    import jax.numpy as jnp

    import exponentialutilities_jl_tpu as eu

    n = nx ** 3
    b = np.random.default_rng(4).standard_normal(n)
    for dt in DTYPES:
        op = eu.laplacian_nd_stencil(nx, nx, nx, dtype=dt)
        bj = jnp.asarray(b, dt)
        ref = spectral_phiv(t, (nx, nx, nx), np.asarray(bj, np.float64),
                            0)[:, 0]
        cheb_tol = 1e-14 if dt == "float64" else 1e-7
        for case, fn, mem in (
                (f"expv_m{m}", lambda v: eu.expv(t, op, v, m=m), True),
                (f"expv_two_pass_m{m}",
                 lambda v: eu.expv(t, op, v, m=m, two_pass=True), True),
                ("expv_chebyshev",
                 lambda v: eu.expv_chebyshev(t, op, v, tol=cheb_tol),
                 False)):
            extra = {"n": n}
            if mem:
                extra["memory_analysis"] = _memory_analysis(fn, bj)
            v, f, w = _timed(lambda: fn(bj))
            check("laplacian_3d", case, dt, _rel(v, ref), TOL[dt], f, w,
                  **extra)
            del v


def reaction_diffusion(nx: int, nu: float = 1e-4, dtype="float32"):
    """u' = nu*Lap(u) + u - u^3 on an nx^2 Dirichlet grid: (f, u0)."""
    import jax.numpy as jnp

    import exponentialutilities_jl_tpu as eu

    dx = 1.0 / (nx + 1)
    op = eu.StencilOperator(
        (nx, nx), [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)],
        jnp.asarray([-4.0, 1.0, 1.0, 1.0, 1.0], dtype) / dx ** 2 * nu,
        is_hermitian=True)
    g = np.arange(1, nx + 1) / (nx + 1)
    yy, xx = np.meshgrid(g, g, indexing="ij")
    u0 = (np.sin(np.pi * xx) * np.sin(np.pi * yy)
          * (1 + 0.3 * np.cos(4 * np.pi * xx))).reshape(-1) * 0.5

    def f(u):
        return op.matvec(u) + u - u ** 3

    return f, jnp.asarray(u0, dtype)


def phase_reaction_diffusion(nx: int = 1024, tf: float = 0.5,
                             rtol: float = 1e-5, atol: float = 1e-7):
    """Adaptive exprb43 on the device against the host driver, in f64 and
    in f32 (``benchmarks/bench_integrators.py``'s problem): in each dtype
    the same accept/reject counts and final states within ``RD_TOL``. The
    f32 device solve is also held to the f64 host solve within the f32
    class."""
    import exponentialutilities_jl_tpu as eu

    host64 = None
    for dt in ("float64", "float32"):
        f, u0 = reaction_diffusion(nx, dtype=dt)
        (ud, std), fd, wd = _timed(
            lambda: eu.exprb43_device(f, u0, (0.0, tf), rtol=rtol,
                                      atol=atol, m=24, return_stats=True),
            reps=1)
        (uh, sth), fh, wh = _timed(
            lambda: eu.exprb43(f, u0, (0.0, tf), rtol=rtol, atol=atol),
            reps=1)
        uh = np.asarray(uh, np.float64)
        if not np.all(np.isfinite(uh)):
            raise AssertionError(f"host exprb43 ({dt}) returned non-finite "
                                 "values")
        steps = {"device_steps": std.steps, "device_rejected": std.rejected,
                 "host_steps": sth.steps, "host_rejected": sth.rejected}
        check("reaction_diffusion", "exprb43_device_vs_host", dt,
              _rel(ud, uh), RD_TOL[dt], fd, wd, n=nx * nx,
              host_first_call_s=fh, host_warm_s=wh, **steps)
        if (std.steps, std.rejected) != (sth.steps, sth.rejected):
            raise AssertionError(f"exprb43_device ({dt}) took other steps "
                                 f"than the host exprb43: {steps}")
        if host64 is None:
            host64 = uh
        else:
            check("reaction_diffusion", "exprb43_device_vs_f64_host", dt,
                  _rel(ud, host64), TOL[dt], n=nx * nx)


# ----------------------------------------------------- kernel candidates

def _per_step(fn, args, steps: int, words_per_step: float, itemsize: int,
              hbm_peak: float, reps: int = 5):
    import jax
    jf = jax.jit(fn)
    _, _, warm = _timed(lambda: jf(*args), reps)
    step_s = warm / steps
    bps = words_per_step * itemsize / step_s
    return {"warm_s": warm, "steps": steps, "step_s": step_s,
            "bytes_per_step": words_per_step * itemsize,
            "bytes_per_s": bps, "hbm_share": bps / hbm_peak}


def phase_kernels(hbm_peak: float, n1: int = 100_000, nx3: int = 216,
                  nx_big: int = 512, n_sparse: int = 1_000_000):
    """Warm time of the plain XLA path at each kernel candidate's hot
    shape (ROADMAP R1), the bytes per step it must move and their share
    of HBM peak.
    Words per step count each vector read or written once (f32):
    Chebyshev step reads u_k, u_{k-1}, w and writes u_{k+1}, w (5n);
    Lanczos pass 1 reads v_j, v_{j-1} and writes v_{j+1} (3n), pass 2
    also reads and writes w (5n)."""
    import jax.numpy as jnp

    import exponentialutilities_jl_tpu as eu
    from exponentialutilities_jl_tpu.models.chebyshev import (
        _chebyshev_apply_scan, _full_exp_coeffs)
    from exponentialutilities_jl_tpu.models.expv import _expv_two_pass

    dt = jnp.float32

    def cheb(op, t, n):
        lo, hi = op.spectral_bounds_hint()
        full, c, h = _full_exp_coeffs(t, lo, hi, 1e-7, None)
        cj = jnp.asarray(full, dt)
        b = jnp.asarray(np.random.default_rng(5).standard_normal(n), dt)
        return (lambda v: _chebyshev_apply_scan(op, v, cj, c, 1.0 / h),
                (b,), len(full))

    rows = []
    # 1-D constant-stencil recurrence, launch-bound at n = 1e5
    op1 = eu.laplacian_nd_stencil(n1, dtype=dt)
    fn, args, deg = cheb(op1, 0.5, n1)
    rows.append({"case": "chebyshev_1d", "path": "_chebyshev_apply_scan",
                 "shape": [n1], **_per_step(fn, args, deg, 5 * n1, 4,
                                            hbm_peak)})
    # 3-D stencil recurrences (Chebyshev and two-pass Lanczos) at 216^3
    n3 = nx3 ** 3
    op3 = eu.laplacian_nd_stencil(nx3, nx3, nx3, dtype=dt)
    fn, args, deg = cheb(op3, 0.05, n3)
    rows.append({"case": "chebyshev_3d", "path": "_chebyshev_apply_scan",
                 "shape": [nx3] * 3, **_per_step(fn, args, deg, 5 * n3, 4,
                                                 hbm_peak)})
    m = 20
    b3 = jnp.asarray(np.random.default_rng(6).standard_normal(n3), dt)
    rows.append({"case": "two_pass_lanczos_3d", "path": "_expv_two_pass",
                 "shape": [nx3] * 3, "m": m,
                 **_per_step(lambda v: _expv_two_pass(op3, v, 0.05, m),
                             (b3,), 2 * m, 4 * n3, 4, hbm_peak)})
    del b3, args
    # giant 3-D grid (512^3)
    nb = nx_big ** 3
    opb = eu.laplacian_nd_stencil(nx_big, nx_big, nx_big, dtype=dt)
    fn, args, deg = cheb(opb, 0.05, nb)
    rows.append({"case": "chebyshev_3d_giant", "path": "_chebyshev_apply_scan",
                 "shape": [nx_big] * 3, **_per_step(fn, args, deg, 5 * nb, 4,
                                                    hbm_peak)})
    del args
    # unstructured SpMV (banded-random, degree 8): SELL and block-ELL
    import scipy.sparse as sp
    rng = np.random.default_rng(7)
    deg_sp, band = 8, 700
    r = np.repeat(np.arange(n_sparse), deg_sp)
    c = np.clip(r + rng.integers(-band // 2, band // 2, r.size), 0,
                n_sparse - 1)
    S = sp.csr_matrix((rng.standard_normal(r.size) / deg_sp, (r, c)),
                      shape=(n_sparse, n_sparse))
    S.sum_duplicates()
    x = jnp.asarray(rng.standard_normal(n_sparse), dt)
    sell = eu.SellOperator.from_scipy(S.astype(np.float32))
    nnz = S.nnz
    words = 2 * nnz + 2 * n_sparse           # values + indices, x, y
    rows.append({"case": "sell_spmv", "path": "SellOperator.matvec",
                 "shape": [n_sparse], "nnz": nnz,
                 **_per_step(sell.matvec, (x,), 1, words, 4, hbm_peak)})
    bell = eu.blockell_from_scipy(S.astype(np.float32), 8)
    words_b = bell.blocks.size + bell.bcols.size + 2 * n_sparse
    rows.append({"case": "blockell_spmv", "path": "BlockELLOperator.matvec",
                 "shape": [n_sparse], "block": 8,
                 **_per_step(bell.matvec, (x,), 1, words_b, 4, hbm_peak)})
    for row in rows:
        _emit({"phase": "kernels", **row})
    return rows


# ------------------------------------------------------------ four cards

def _four_card_cases(dt: str, b_dt, nx: int, t: float, m: int, mesh,
                     host):
    """The sharded solves of one dtype. Each entry is (case, sharded call,
    warm reps, layout of its result, weights of phi_0, phi_1 in the exact
    answer, factory of the same solve on one device)."""
    import jax
    import jax.numpy as jnp

    import exponentialutilities_jl_tpu as eu
    from exponentialutilities_jl_tpu.parallel import (
        expv_chebyshev_sharded, expv_sharded, shard_operator, shard_vector)

    n, ndev = nx ** 3, mesh.devices.size
    op = eu.laplacian_nd_stencil(nx, nx, nx, dtype=dt)
    cheb_tol = 1e-14 if dt == "float64" else 1e-7

    def one_card(fn):              # input placed on device 0 once, untimed
        def make():
            v = jnp.asarray(b_dt)
            return lambda: fn(v)
        return make

    def layout(w):
        return _layout(w, n, ndev)

    cases = [
        (f"expv_sharded_m{m}",
         lambda: expv_sharded(t, op, b_dt, mesh, m=m), 3, layout, (1.0, 0.0),
         one_card(lambda v: eu.expv(t, op, v, m=m))),
        (f"expv_sharded_two_pass_m{m}",
         lambda: expv_sharded(t, op, b_dt, mesh, m=m, two_pass=True), 3,
         layout, (1.0, 0.0),
         one_card(lambda v: eu.expv(t, op, v, m=m, two_pass=True))),
        ("expv_chebyshev_sharded",
         lambda: expv_chebyshev_sharded(t, op, b_dt, mesh, tol=cheb_tol), 3,
         layout, (1.0, 0.0),
         one_card(lambda v: eu.expv_chebyshev(t, op, v, tol=cheb_tol))),
    ]
    # GSPMD route: row-sharded banded operator, ordinary device driver.
    # The operator is built in host memory and placed shard by shard.
    B = np.stack([b_dt, 0.1 * b_dt], axis=1)
    with jax.default_device(host):
        opb = eu.laplacian_3d(nx, nx, nx, dtype=dt)
    sop, Bs = shard_operator(opb, mesh), shard_vector(B, mesh)
    tol = TOL[dt] / 10

    def gspmd_layout(_):
        # the driver returns a host array; the sharded state is its input
        out = {"B": _layout(Bs, n, ndev),
               "diags": _layout(sop.diags, n, ndev, axis=1)}
        out["rows_split_evenly"] = all(v["rows_split_evenly"]
                                       for v in out.values())
        return out

    def gspmd_one_card():
        A, Bd = eu.laplacian_3d(nx, nx, nx, dtype=dt), jnp.asarray(B)
        return lambda: eu.phiv_timestep_device([t], A, Bd, tol=tol,
                                               m=m)[:, 0]

    cases.append((
        "phiv_timestep_device_gspmd",
        lambda: eu.phiv_timestep_device([t], sop, Bs, tol=tol, m=m)[:, 0],
        1, gspmd_layout, (1.0, 0.1 * t), gspmd_one_card))
    return cases


def phase_four_cards(nx: int = 216, t: float = 0.05, m: int = 20,
                     ndev: int = 4):
    """Row-partitioned 3-D Laplacian over ``ndev`` devices, each solve
    against the spectral oracle and the same solve on one device.

    Every sharded input goes from the host straight onto its shards, and
    every sharded solve runs before any one-device solve, so the peaks of
    device memory read in between belong to the sharded solves alone:
    they must agree within ``PEAK_SPREAD``."""
    import jax

    from exponentialutilities_jl_tpu.parallel import make_mesh

    mesh = make_mesh(ndev)
    host = jax.local_devices(backend="cpu")[0]
    n = nx ** 3
    b = np.random.default_rng(8).standard_normal(n)
    runs = []
    for dt in DTYPES:
        b_dt = b.astype(dt)
        ph = spectral_phiv(t, (nx, nx, nx), b_dt.astype(np.float64), 1)
        for case, sharded, reps, layout_of, wts, one_card in \
                _four_card_cases(dt, b_dt, nx, t, m, mesh, host):
            w, f, wt = _timed(sharded, reps)
            runs.append((case, dt, ph @ np.asarray(wts), layout_of(w),
                         np.asarray(w, np.float64), f, wt, one_card))
            del w

    memory = _device_memory(mesh.devices.flat)
    peaks = [d["peak_bytes_in_use"] for d in memory]
    spread = None if None in peaks else max(peaks) / min(peaks)
    _emit({"phase": "four_cards", "case": "sharded_peak_memory",
           "device_memory": memory, "peak_spread": spread,
           "peak_spread_bound": PEAK_SPREAD})
    if spread is not None and spread > PEAK_SPREAD:
        raise AssertionError(f"sharded solves left uneven device peaks: "
                             f"{peaks}")

    for case, dt, ref, layout, w, f, wt, one_card in runs:
        w1, _, wt1 = _timed(one_card())
        vs_one = _rel(w, np.asarray(w1, np.float64))
        check("four_cards", case, dt, _rel(w, ref), TOL[dt], f, wt, n=n,
              rel_vs_one_card=vs_one, one_card_warm_s=wt1, layout=layout)
        del w1
        if not layout["rows_split_evenly"]:
            raise AssertionError(f"{case}: not split n/{ndev} per device: "
                                 f"{layout}")
        if vs_one > TOL[dt]:
            raise AssertionError(f"{case}: sharded and one-card results "
                                 "disagree")


def _layout(w, n: int, ndev: int, axis: int = 0) -> dict:
    shards = w.addressable_shards
    rows = [int(s.data.shape[axis]) for s in shards]
    devs = sorted({s.device.id for s in shards})
    return {"n_shards": len(shards), "rows": rows, "devices": devs,
            "rows_split_evenly": (len(devs) == ndev
                                  and rows == [n // ndev] * ndev)}


def _device_memory(devices) -> list:
    out = []
    for d in devices:
        s = d.memory_stats() or {}
        out.append({"id": d.id, "bytes_in_use": s.get("bytes_in_use"),
                    "peak_bytes_in_use": s.get("peak_bytes_in_use")})
    return out


# ------------------------------------------------------------------ main

def _nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-partitioned phase on 4 GPUs")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "exponentialutilities_jl_tpu")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (package directory not found)")
    import jax
    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform}")
    count = 4 if args.four_cards else 1
    if len(jax.devices()) < count:
        raise SystemExit(f"needs {count} GPU(s), JAX sees "
                         f"{len(jax.devices())}")
    print("nvidia-smi:", _nvidia_smi().replace("\n", " | "), flush=True)
    print("device_kind:", dev.device_kind, flush=True)

    from exponentialutilities_jl_tpu.utils.aot import use_compile_cache
    print("compile_cache:", use_compile_cache(), flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        hbm_peak = HBM_PEAK_BYTES_PER_S[dev.device_kind]
        phase_dense()
        phase_laplacian_1d()
        phase_poisson_2d()
        phase_advdiff()
        phase_laplacian_3d()
        phase_reaction_diffusion()
        phase_kernels(hbm_peak)
    print(f"total_s: {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
