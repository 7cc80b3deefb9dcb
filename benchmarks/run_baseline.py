"""Run the five BASELINE.json benchmark configs and print one JSON line per
config. Usage: python benchmarks/run_baseline.py [--configs 1,2,3,4,5]

Timing: the median warm wall time of a jitted step, each call ending in
``block_until_ready`` (the first call compiles and is excluded).
Host-driven adaptive drivers (config 4) are timed by wall clock on the
second call. Configs 1-4 run in float64, config 5 in float32, every
matmul at "highest" precision; accuracy is reported against host f64
oracles where the problem is small enough to afford one, and by the
semigroup identity otherwise. The script exits non-zero when a config
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _setup():
    import jax
    jax.config.update("jax_enable_x64", True)
    from exponentialutilities_jl_tpu.utils.aot import use_compile_cache
    use_compile_cache()
    return jax


def _step_time(step, x0, reps=10):
    """Median warm seconds of one jitted ``step(x0)``."""
    import jax

    f = jax.jit(step)
    jax.block_until_ready(f(x0))             # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x0))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def config1():
    """Dense 100×100 exponential + expv (reference's core workload)."""
    jax = _setup()
    import jax.numpy as jnp
    import scipy.linalg as sla
    from exponentialutilities_jl_tpu import DenseOperator, expm
    from exponentialutilities_jl_tpu.models.expv import (_combine_expv,
                                                        _exp_reduced_e1,
                                                        build_subspace)
    from exponentialutilities_jl_tpu.ops.expm import expm_higham2005

    rng = np.random.default_rng(0)
    A = rng.standard_normal((100, 100)) / 10
    b = rng.standard_normal(100)
    dt = jnp.float64
    Aj = jnp.asarray(A, dtype=dt)
    bj = jnp.asarray(b, dtype=dt)
    op = DenseOperator(Aj)

    def expm_step(X):
        E = expm_higham2005(X)
        return E / jnp.linalg.norm(E)

    t_expm = _step_time(expm_step, Aj)

    def expv_step(v):
        Ks = build_subspace(op, v, 40)
        w = _combine_expv(Ks, _exp_reduced_e1(Ks, 1.0))
        return w / jnp.linalg.norm(w)

    t_expv = _step_time(expv_step, bj)

    E = expm(Aj)
    w = jax.jit(lambda v: _combine_expv(
        *(lambda Ks: (Ks, _exp_reduced_e1(Ks, 1.0)))(
            build_subspace(op, v, 40))))(bj)
    err_expm = float(np.linalg.norm(np.asarray(E, np.float64) - sla.expm(A))
                     / np.linalg.norm(sla.expm(A)))
    oracle = sla.expm(A) @ b
    err_expv = float(np.linalg.norm(np.asarray(w, np.float64) - oracle)
                     / np.linalg.norm(oracle))
    return {"config": 1, "name": "dense100_expm_expv",
            "expm_ms": round(t_expm * 1e3, 3),
            "expv_ms": round(t_expv * 1e3, 3),
            "expm_rel_err": err_expm, "expv_rel_err": err_expv}


def config2():
    """1-D Laplacian N=1e5 Lanczos expv — the workload of bench.py."""
    jax = _setup()
    import jax.numpy as jnp
    from exponentialutilities_jl_tpu import StencilOperator
    from exponentialutilities_jl_tpu.models.expv import _expv_two_pass

    n, m, t = 100_000, 30, 0.5
    dt = jnp.float64
    coeffs = jnp.asarray([1.0, -2.0, 1.0], dtype=dt)
    op = StencilOperator((n,), ((-1,), (0,), (1,)), coeffs,
                         is_hermitian=True)
    rng = np.random.default_rng(0)
    b_host = rng.standard_normal(n)
    bj = jnp.asarray(b_host, dtype=dt)

    def step(v):
        w = _expv_two_pass(op, v, t, m)
        return w / jnp.linalg.norm(w)

    t_expv = _step_time(step, bj)

    import scipy.sparse as sp
    from scipy.sparse.linalg import expm_multiply
    A = sp.diags([np.ones(n - 1), -2 * np.ones(n), np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    t0 = time.perf_counter()
    ref = expm_multiply(t * A, b_host)
    scipy_ms = (time.perf_counter() - t0) * 1e3
    from exponentialutilities_jl_tpu import expv
    w = np.asarray(expv(t, op, bj, m=m, two_pass=True), np.float64)
    err = float(np.linalg.norm(w - ref) / np.linalg.norm(ref))

    # Chebyshev action (the library's fastest Hermitian path — the
    # bench.py headline method): exact Gershgorin interval [-4, 0].
    from exponentialutilities_jl_tpu.models.chebyshev import (
        _chebyshev_apply_scan, _exp_ucoeffs)
    cnp, csc = _exp_ucoeffs(t * 2.0, 1e-7)
    cj = jnp.asarray(cnp * np.exp(t * (-2.0) + csc), dt)
    mc = len(cnp)

    def step_ch(v):
        w = _chebyshev_apply_scan(op, v, cj, -2.0, 0.5)
        return w / jnp.linalg.norm(w)

    t_cheb = _step_time(step_ch, bj)
    w_ch = np.asarray(_chebyshev_apply_scan(op, bj, cj, -2.0, 0.5),
                      np.float64)
    err_ch = float(np.linalg.norm(w_ch - ref) / np.linalg.norm(ref))
    return {"config": 2, "name": "laplacian1d_1e5_expv",
            "expv_ms": round(t_expv * 1e3, 3),
            "vs_scipy_expm_multiply": round(scipy_ms / (t_expv * 1e3), 1),
            "rel_err": err,
            "chebyshev_ms": round(t_cheb * 1e3, 3),
            "chebyshev_vs_scipy": round(scipy_ms / (t_cheb * 1e3), 1),
            "chebyshev_rel_err": err_ch, "chebyshev_degree": mc}


def config3():
    """φ p=0..3 on 2-D Poisson N=1e6, CGS2 orthogonalization."""
    jax = _setup()
    import jax.numpy as jnp
    from exponentialutilities_jl_tpu import phiv, poisson_2d
    from exponentialutilities_jl_tpu.models.expv import build_subspace
    from exponentialutilities_jl_tpu.models.phiv import _phiv_from_basis_device

    dt = jnp.float64
    op = poisson_2d(1000, 1000, dtype=dt)
    n = 1_000_000
    rng = np.random.default_rng(0)
    bj = jnp.asarray(rng.standard_normal(n), dtype=dt)

    def step(v):
        Ks = build_subspace(op, v, 30)
        w, _ = _phiv_from_basis_device(1e-4, Ks, 3, False)
        s = jnp.sum(w, axis=1)
        return s / jnp.linalg.norm(s)

    t_phiv = _step_time(step, bj)
    W = np.asarray(phiv(1e-4, op, bj, 3, m=30, reduced="device"), np.float64)
    # φ identity oracle: t·A·φ₁(tA)b = φ₀(tA)b − b  (z·φ₁ = φ₀ − 1).
    b64 = np.asarray(bj, np.float64)
    lhs = 1e-4 * np.asarray(op.matvec(jnp.asarray(W[:, 1], dt)), np.float64)
    rhs = W[:, 0] - b64
    err = float(np.linalg.norm(lhs - rhs) / np.linalg.norm(rhs))
    return {"config": 3, "name": "poisson2d_1e6_phiv_p3",
            "phiv_ms": round(t_phiv * 1e3, 3), "phi_identity_rel_err": err}


def config4():
    """KIOPS + Niesen–Wright adaptive on stiff 1-D advection–diffusion."""
    _setup()
    import jax.numpy as jnp
    import scipy.linalg as sla
    from exponentialutilities_jl_tpu import (advection_diffusion_1d, kiops,
                                             phiv_timestep)

    n = 2000
    dt = jnp.float64
    op = advection_diffusion_1d(n, peclet=10.0, dtype=dt)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    B = jnp.asarray(np.stack([b, 0.1 * b], axis=1), dtype=dt)

    U = phiv_timestep([1e-4], op, B, adaptive=True, tol=1e-7, m=20)
    t0 = time.perf_counter()
    U = phiv_timestep([1e-4], op, B, adaptive=True, tol=1e-7, m=20)
    t_nw = time.perf_counter() - t0
    Wk, stats = kiops([1e-4], op, B, tol=1e-7)
    t0 = time.perf_counter()
    Wk, stats = kiops([1e-4], op, B, tol=1e-7)
    t_kiops = time.perf_counter() - t0

    # round-2: device-resident drivers (whole adaptive loop in one
    # compiled program per m bucket — no per-substep dispatch latency)
    from exponentialutilities_jl_tpu import (kiops_device,
                                             phiv_timestep_device)
    Ud = phiv_timestep_device([1e-4], op, B, tol=1e-7, m=20)
    t0 = time.perf_counter()
    Ud = phiv_timestep_device([1e-4], op, B, tol=1e-7, m=20)
    t_nw_dev = time.perf_counter() - t0
    Wkd, _ = kiops_device([1e-4], op, B, tol=1e-7)
    t0 = time.perf_counter()
    Wkd, _ = kiops_device([1e-4], op, B, tol=1e-7)
    t_kiops_dev = time.perf_counter() - t0

    Ad = np.asarray(op.to_dense(), np.float64)
    tt = 1e-4
    E2 = np.zeros((n, 1)); E2[:, 0] = b * 0.1
    F2 = sla.expm(np.block([[tt * Ad, tt * E2], [np.zeros((1, n + 1))]]))
    oracle = sla.expm(tt * Ad) @ b + F2[:n, n]
    err_nw = float(np.linalg.norm(np.asarray(U[:, 0], np.float64) - oracle)
                   / np.linalg.norm(oracle))
    err_kiops = float(np.linalg.norm(np.asarray(Wk).ravel() - oracle)
                      / np.linalg.norm(oracle))
    err_nw_dev = float(np.linalg.norm(
        np.asarray(Ud[:, 0], np.float64) - oracle) / np.linalg.norm(oracle))
    err_kiops_dev = float(np.linalg.norm(
        np.asarray(Wkd).ravel() - oracle) / np.linalg.norm(oracle))
    return {"config": 4, "name": "advdiff_stiff_adaptive",
            "nw_ms": round(t_nw * 1e3, 1),
            "kiops_ms": round(t_kiops * 1e3, 1),
            "nw_device_ms": round(t_nw_dev * 1e3, 1),
            "kiops_device_ms": round(t_kiops_dev * 1e3, 1),
            "nw_rel_err": err_nw, "kiops_rel_err": err_kiops,
            "nw_device_rel_err": err_nw_dev,
            "kiops_device_rel_err": err_kiops_dev,
            "kiops_steps": stats.steps}


def config5():
    """10M-row 3-D Laplacian expv — BASELINE's scale config (single chip
    here; the multi-host variant shards the same operator over a mesh)."""
    jax = _setup()
    import jax.numpy as jnp
    from exponentialutilities_jl_tpu import expv, laplacian_nd_stencil
    from exponentialutilities_jl_tpu.models.expv import (_combine_expv,
                                                        _exp_reduced_e1,
                                                        build_subspace)

    nx = ny = nz = 216   # 216³ ≈ 10.08M
    n = nx * ny * nz
    dt = jnp.float32
    op = laplacian_nd_stencil(nz, ny, nx, dtype=dt)
    rng = np.random.default_rng(0)
    bj = jnp.asarray(rng.standard_normal(n), dtype=dt)

    def step(v):
        Ks = build_subspace(op, v, 20)
        w = _combine_expv(Ks, _exp_reduced_e1(Ks, 0.05))
        return w / jnp.linalg.norm(w)

    t_expv = _step_time(step, bj)
    # semigroup oracle: exp(tA)b vs exp(t/2 A) applied twice.
    w = np.asarray(expv(0.05, op, bj, m=20, reduced="device"), np.float64)
    wh = expv(0.025, op, bj, m=20, reduced="device")
    w2 = np.asarray(expv(0.025, op, wh, m=20, reduced="device"), np.float64)
    err = float(np.linalg.norm(w - w2) / np.linalg.norm(w2))
    bytes_per_mv = 2 * n * 4   # stencil traffic: x read + y write

    # Chebyshev action: single pass, no inner products
    from exponentialutilities_jl_tpu.models.chebyshev import (
        _chebyshev_apply_scan, _exp_ucoeffs)
    lo, hi = op.spectral_bounds_hint()
    c5, h5 = 0.5 * (hi + lo), 0.5 * (hi - lo)
    cnp, csc = _exp_ucoeffs(0.05 * h5, 1e-7)
    cj = jnp.asarray(cnp * np.exp(0.05 * c5 + csc), dt)
    mc = len(cnp)

    def step_ch(v):
        w = _chebyshev_apply_scan(op, v, cj, c5, 1.0 / h5)
        return w / jnp.linalg.norm(w)

    t_cheb = _step_time(step_ch, bj)
    out = {"config": 5, "name": "laplacian3d_10M_expv",
           "n": n, "expv_ms": round(t_expv * 1e3, 2),
           "semigroup_rel_err": err,
           "effective_spmv_gbs": round(21 * bytes_per_mv / t_expv / 1e9, 1),
           "chebyshev_ms": round(t_cheb * 1e3, 2),
           "chebyshev_degree": mc}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--no-isolate", action="store_true",
                    help="run all configs in this process")
    args = ap.parse_args()
    cfgs = [int(x) for x in args.configs.split(",")]

    if len(cfgs) > 1 and not args.no_isolate:
        # SEQUENTIAL subprocess per config: each child holds the card
        # alone (the parent never imports jax, so exactly one process
        # reserves device memory at a time); the persistent compile cache
        # keeps the per-child warmup cheap.
        import subprocess
        any_failed = False
        for i, c in enumerate(cfgs):
            r = subprocess.run(
                [sys.executable, __file__, "--configs", str(c)],
                capture_output=True, text=True)
            failed = r.returncode != 0
            for line in r.stdout.splitlines():
                if not line.startswith("{"):
                    continue
                if '"backend"' in line and i > 0:
                    continue                      # print backend once
                if '"error"' in line:
                    failed = True
                print(line, flush=True)
            if failed:
                # surface the child's traceback, not just the JSON line
                sys.stderr.write(r.stderr[-3000:] + "\n")
                sys.stderr.flush()
            if r.returncode != 0:
                print(json.dumps({"config": c,
                                  "error": r.stderr.strip()[-400:]}),
                      flush=True)
            any_failed = any_failed or failed
        if any_failed:
            sys.exit(1)
        return

    fns = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}
    jax = _setup()
    dev = jax.devices()[0]
    print(json.dumps({"backend": dev.platform,
                      "device_kind": dev.device_kind,
                      "n_devices": len(jax.devices())}), flush=True)
    for c in cfgs:
        print(json.dumps(fns[c]()), flush=True)


if __name__ == "__main__":
    main()
