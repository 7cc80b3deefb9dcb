"""Batched dense exp/φ benchmark with an audited FLOP rate.

Algorithmic FLOPs are read off the compiled executable
(``compile().cost_analysis()`` 'flops' — XLA's own count of the
optimized HLO); the hand counts are printed as a cross-check. Each rate
is reported as a share of the rate the plain batched f32 matmul reaches
in the same run (the measured roofline of this card at "highest"
precision), not of a published peak.

Paths measured at (B, n) ∈ {(512,128), (128,256), (32,512)}, f32,
per-matrix 1-norm exactly 20:

  * matmul       — einsum bik baseline under mxu_full_precision
  * expm(batch)  — expm_higham2005_batched (the expm() route for
                   stacked input: ONE Padé branch + unmasked squaring)
  * vmap(expm)   — the per-element lax.switch form (kept to show the
                   gap the batched route closes)
  * expm_taylor  — vmapped static-structure Taylor
  * phi4         — vmap(phi(·, 4)) Taylor scaling-and-recovering

Timing: median warm wall time of one jitted call, ending in
``block_until_ready``.

Run: python benchmarks/bench_dense_mfu.py [512|128|32]
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from exponentialutilities_jl_tpu.ops.expm import (  # noqa: E402
    expm_higham2005, expm_higham2005_batched, expm_taylor)
from exponentialutilities_jl_tpu.ops.phi_dense import phi  # noqa: E402
from exponentialutilities_jl_tpu.utils.aot import (  # noqa: E402
    use_compile_cache)
from exponentialutilities_jl_tpu.utils.precision import (  # noqa: E402
    mxu_full_precision)


def warm_seconds(fn, *args, reps=10):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def hlo_flops(fn, *args):
    """XLA's flop count of the optimized single-call executable."""
    try:
        ca = jax.jit(fn).lower(*args).compile().cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        return float(ca.get("flops", float("nan")))
    except Exception as e:                      # noqa: BLE001
        print("  (cost_analysis unavailable:", repr(e), ")", flush=True)
        return float("nan")


def bench_case(B, n, rng):
    A = rng.standard_normal((B, n, n)).astype(np.float32)
    A *= (20.0 / np.linalg.norm(A, 1, axis=(1, 2)))[:, None, None]
    Aj = jnp.asarray(A)

    rows = []

    def run(name, body, analytic_gemms=None):
        t_call = warm_seconds(jax.jit(body), Aj)
        fl = hlo_flops(lambda a: body(a), Aj)
        rate = fl / t_call
        rows.append((name, t_call, fl, rate))
        extra = ""
        if analytic_gemms is not None:
            extra = (f"  [hand-count {analytic_gemms:.1f} GEMMs = "
                     f"{analytic_gemms * B * 2 * n**3 / 1e9:.1f} GF vs "
                     f"HLO {fl/1e9:.1f} GF]")
        print(f"  {name:12s}: {t_call*1e3:8.3f} ms  "
              f"HLO {fl/1e9:8.1f} GF  -> {rate/1e12:6.2f} TF/s{extra}",
              flush=True)
        return rate

    print(f"B={B} n={n}", flush=True)

    @mxu_full_precision
    def mm(X):
        return jnp.einsum("bij,bjk->bik", X, X)

    mm_rate = run("matmul", mm)

    # f32 path: degree-7 cap (θ7 = 3.93) → s = ceil(log2(20/3.93)) = 3
    run("expm_batch", expm_higham2005_batched,
        analytic_gemms=4 + 1.33 + 3)
    run("vmap_expm", jax.vmap(expm_higham2005))
    run("expm_taylor", jax.vmap(expm_taylor))
    run("phi4_batch", lambda X: phi(X, 4))      # stacked → batched route
    run("phi4_vmap", jax.vmap(lambda a: phi(a, 4)))

    print("  -- % of matmul roofline:", flush=True)
    for name, t_call, fl, rate in rows[1:]:
        print(f"  {name:12s}: {100 * rate / mm_rate:5.1f}% of matmul",
              flush=True)
    return {name: (t_call, fl, rate) for name, t_call, fl, rate in rows}


def main():
    use_compile_cache()
    print("devices:", jax.devices(), jax.devices()[0].device_kind,
          flush=True)
    rng = np.random.default_rng(0)
    import scipy.linalg as sla
    A0 = rng.standard_normal((8, 128, 128)).astype(np.float32)
    A0 *= 20.0 / np.linalg.norm(A0[0], 1)
    E = np.asarray(expm_higham2005_batched(jnp.asarray(A0)))
    rel = max(np.linalg.norm(E[i] - sla.expm(A0[i].astype(np.float64)))
              / np.linalg.norm(sla.expm(A0[i].astype(np.float64)))
              for i in range(3))
    print(f"expm_batched vs scipy (f32): {rel:.2e}", flush=True)

    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    cases = {"512": (512, 128), "128": (128, 256), "32": (32, 512)}
    for key, (B, n) in cases.items():
        if which in ("all", key):
            bench_case(B, n, rng)


if __name__ == "__main__":
    main()
