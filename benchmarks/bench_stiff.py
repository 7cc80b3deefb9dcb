"""Stiff-horizon expv on the 10M-row 3-D Laplacian: one-pass Chebyshev
vs the device-resident Niesen–Wright driver at matched tolerance.

t = 100 with spectrum [-12, 0] → t·‖A‖ = 1200. The Chebyshev-U tail for
a decay spectrum cuts at degree O(√(t·‖A‖·ln 1/tol)) (~150 here), so the
whole horizon is ONE reduction-free pass; the NW driver substeps with
Krylov rebuilds. Timing: single warm calls (both paths are one or few
dispatches).

Run: python benchmarks/bench_stiff.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from exponentialutilities_jl_tpu.utils.aot import use_compile_cache
    use_compile_cache()

    from exponentialutilities_jl_tpu import (expv_chebyshev,
                                             expv_timestep_device,
                                             laplacian_nd_stencil)

    print(f"device: {jax.devices()[0].device_kind}")
    nx = ny = nz = 216
    n = nx * ny * nz
    dt = jnp.float32
    t = 100.0
    tol = 1e-6
    op = laplacian_nd_stencil(nz, ny, nx, dtype=dt)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(n), dt)

    # --- one-pass Chebyshev ---
    w_ch = expv_chebyshev(t, op, b, tol=tol)       # compile + warm
    jax.block_until_ready(w_ch)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(expv_chebyshev(t, op, b, tol=tol))
        ts.append(time.perf_counter() - t0)
    t_ch = min(ts)
    from exponentialutilities_jl_tpu.models.chebyshev import _exp_ucoeffs
    deg = len(_exp_ucoeffs(t * 6.0, tol)[0])
    print(f"chebyshev one-pass (degree {deg}): {t_ch*1e3:.1f} ms")

    # --- device-resident NW driver ---
    w_nw = expv_timestep_device(t, op, b, tol=tol, m=30)
    jax.block_until_ready(w_nw)
    ts = []
    for _ in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(expv_timestep_device(t, op, b, tol=tol,
                                                   m=30))
        ts.append(time.perf_counter() - t0)
    t_nw = min(ts)
    print(f"NW device-resident driver : {t_nw*1e3:.1f} ms "
          f"({t_nw/t_ch:.1f}x slower)")

    wc = np.asarray(w_ch, np.float64)
    wn = np.asarray(w_nw, np.float64).reshape(-1)
    rel = np.linalg.norm(wc - wn) / max(np.linalg.norm(wn), 1e-300)
    print(f"cross-path rel diff: {rel:.2e} "
          f"(norms {np.linalg.norm(wc):.3e} / {np.linalg.norm(wn):.3e})")

    # semigroup check on the Chebyshev path: t vs 2 x t/2
    wh = expv_chebyshev(t / 2, op, b, tol=tol)
    w2 = np.asarray(expv_chebyshev(t / 2, op, wh, tol=tol), np.float64)
    print(f"semigroup rel diff: "
          f"{np.linalg.norm(wc - w2)/max(np.linalg.norm(w2), 1e-300):.2e}")


if __name__ == "__main__":
    main()
