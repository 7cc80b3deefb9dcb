"""1e-10-class accuracy AT SCALE (BASELINE configs 2/3/5) through the f64
host-staged reduced path — VERDICT r1 item 5.

Round 1 recorded f32-grade numbers for the large configs (1.6e-6 / 1.2e-4 /
3.2e-6); the f64 machinery existed but was only driven at n = 2000. This
harness runs it at the BASELINE sizes:

  config-2: expv on the 1-D Laplacian, n = 1e5, f64, vs scipy
            expm_multiply (independent f64 oracle)         → target ≤ 1e-10
  config-3: φ-combination (p = 0..3) on the 2-D Poisson operator,
            n = 1e6, f64; oracle = φ identities
            t·A·φ₁(tA)b = φ₀(tA)b − b (exact in exact
            arithmetic) and the φ-recurrence chain          → target ≤ 1e-10
  config-5: expv on the 3-D Laplacian, n = 10M (216³), f64, via the
            O(n)-memory two-pass path (the f64 basis path exceeds HBM);
            oracles = semigroup identity
            exp(tA)b = exp(t/2·A)(exp(t/2·A)b) + m-convergence → ≤ 1e-10

Everything runs in f64 on the device, reduced problems included.

Run: python benchmarks/accuracy_f64.py
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import exponentialutilities_jl_tpu as eu
from exponentialutilities_jl_tpu.utils.aot import use_compile_cache

use_compile_cache()


def config2():
    import scipy.sparse as sp
    from scipy.sparse.linalg import expm_multiply
    n, t, m = 100_000, 1.0, 40
    op = eu.laplacian_1d(n, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    w = np.asarray(eu.expv(t, op, jnp.asarray(b), m=m, hermitian=True))
    A = sp.diags([np.ones(n - 1), -2.0 * np.ones(n), np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    want = expm_multiply(t * A, b)
    rel = float(np.linalg.norm(w - want) / np.linalg.norm(want))
    return {"config": 2, "n": n, "rel_err_vs_scipy": rel}


def config3():
    n_side = 1000
    n = n_side * n_side
    op = eu.laplacian_nd_stencil(n_side, n_side, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal(n))
    t = 1e-3
    W = np.asarray(eu.phiv(t, op, b, 3, m=40, hermitian=True))
    # φ identity: t·A·φ₁(tA)b = φ₀(tA)b − b
    Aphi1 = t * np.asarray(op.matvec(jnp.asarray(W[:, 1])))
    res1 = float(np.linalg.norm(Aphi1 - (W[:, 0] - np.asarray(b)))
                 / np.linalg.norm(W[:, 0]))
    # recurrence chain: t·A·φ_{k+1} = φ_k − (1/k!)·b
    import math
    res = [res1]
    for k in (1, 2):
        lhs = t * np.asarray(op.matvec(jnp.asarray(W[:, k + 1])))
        rhs = W[:, k] - np.asarray(b) / math.factorial(k)
        res.append(float(np.linalg.norm(lhs - rhs)
                         / max(np.linalg.norm(W[:, k]), 1e-300)))
    return {"config": 3, "n": n, "phi_identity_residuals": res}


def config5():
    # 10M rows in f64 through the O(n)-memory two-pass path. Oracles: the
    # semigroup
    # identity (two independent solves at t/2 vs one at t) and
    # m-convergence (m=30 vs m=40 agree below the target long before
    # either equals the truth).
    shape = (216, 216, 216)
    n = shape[0] * shape[1] * shape[2]
    op = eu.laplacian_nd_stencil(*shape, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.standard_normal(n))
    t, m = 5e-2, 30
    w_tp = np.asarray(eu.expv(t, op, b, m=m, hermitian=True,
                              two_pass=True))
    h1 = eu.expv(t / 2, op, b, m=m, hermitian=True, two_pass=True)
    h2 = np.asarray(eu.expv(t / 2, op, h1, m=m, hermitian=True,
                            two_pass=True))
    rel_semi = float(np.linalg.norm(h2 - w_tp) / np.linalg.norm(w_tp))
    w40 = np.asarray(eu.expv(t, op, b, m=40, hermitian=True,
                             two_pass=True))
    rel_m = float(np.linalg.norm(w40 - w_tp) / np.linalg.norm(w40))
    return {"config": 5, "n": n, "semigroup_residual": rel_semi,
            "m30_vs_m40": rel_m}


def config_phi_pade():
    """Dense f64 Al-Mohy–Liu Padé φ on the device; oracle = host scipy
    block matrix (ops/host_reduced.host_phi)."""
    from exponentialutilities_jl_tpu.ops.host_reduced import host_phi

    n, k = 256, 3
    rng = np.random.default_rng(3)
    A = jnp.asarray(rng.standard_normal((n, n)) / 8, jnp.float64)
    F = np.asarray(eu.phi_pade(A, k))
    want = np.asarray(host_phi(np.asarray(A), k))
    rels = []
    for j in range(k + 1):
        scale = max(float(np.max(np.abs(want[j]))), 1e-30)
        rels.append(float(np.max(np.abs(F[j] - want[j])) / scale))
    return {"config": "phi_pade_f64", "n": n, "k": k,
            "max_rel_vs_host_oracle": max(rels), "per_order": rels}


def main():
    results = {"backend": jax.default_backend()}
    for fn in (config2, config3, config5, config_phi_pade):
        t0 = time.time()
        r = fn()
        r["wall_s"] = round(time.time() - t0, 1)
        results[f"config{r['config']}"] = r
        print(json.dumps(r), flush=True)
    with open("/tmp/accuracy_f64.json", "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
