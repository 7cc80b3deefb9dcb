"""Non-Hermitian stiff φ-combination at scale: the Leja NW driver vs
the device-resident adaptive NW driver.

Operator: 1-D advection–diffusion, n = 1e6, Gershgorin interval
(−4400, 0) → t·s = 1100 over the t = 1 horizon (q = 28 substeps at
max_z = 40). Both drivers are device-resident (one/few dispatches);
timing = best-of warm calls.

Run: python benchmarks/bench_leja.py
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

    from exponentialutilities_jl_tpu import (StencilOperator,
                                             phiv_timestep_device)
    from exponentialutilities_jl_tpu.models.leja import (
        phiv_timestep_leja, real_interval)

    print(f"device: {jax.devices()[0].device_kind}")
    n = 1_000_000
    dt = jnp.float32
    # Diffusion-dominated advection–diffusion (mesh Peclet 0.1): the
    # field of values' imaginary extent (±a) must stay well inside the
    # real half-width (~2d) for real-Leja interpolation to converge —
    # an advection-dominated variant (a = 4d) diverges by design (the
    # driver raises; use the Krylov drivers there).
    d_c, a_c = 1e3, 2e2
    op = StencilOperator((n,), ((-1,), (0,), (1,)),
                         jnp.asarray([d_c + a_c, -2 * d_c - a_c, d_c],
                                     dt), is_hermitian=False)
    lo, hi = real_interval(op)
    s = (hi - lo) / 4
    t_end = 1.0
    print(f"interval=({lo:.0f},{hi:.0f}), t*s={t_end*s:.0f}")
    rng = np.random.default_rng(0)
    B = jnp.asarray(rng.standard_normal((n, 3)), dt)

    def best(fn, reps=3):
        fn()                                    # compile + warm
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    u_leja = {}

    def run_leja():
        u = phiv_timestep_leja(t_end, op, B, tol=1e-7)
        jax.block_until_ready(u)
        u_leja["u"] = u

    t_leja = best(run_leja)
    print(f"leja NW driver (fixed-τ scan): {t_leja*1e3:8.1f} ms")

    u_nw = {}

    def run_nw():
        u = phiv_timestep_device(t_end, op, B, tol=1e-7, m=30, iop=2)
        jax.block_until_ready(u)
        u_nw["u"] = u

    t_nw = best(run_nw)
    print(f"NW device-resident adaptive  : {t_nw*1e3:8.1f} ms "
          f"({t_nw/t_leja:.1f}x slower)")

    wl = np.asarray(u_leja["u"], np.float64).reshape(-1)
    wn = np.asarray(u_nw["u"], np.float64).reshape(-1)
    print(f"cross-driver rel diff: "
          f"{np.linalg.norm(wl-wn)/max(np.linalg.norm(wn),1e-300):.2e} "
          f"(norms {np.linalg.norm(wl):.3e}/{np.linalg.norm(wn):.3e})")


if __name__ == "__main__":
    main()
