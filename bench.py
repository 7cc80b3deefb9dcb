"""Benchmark: expv on the 1-D Laplacian, N=1e5 (BASELINE config #2).

Prints the device line, then ONE JSON line:
  metric       warm wall time of one ``expv_chebyshev`` call, exp(tA)b by
               the library's single-pass method for this Hermitian stencil
               (exact Gershgorin interval, degree from the 1e-7
               coefficient tail), in ms
  value        that time, median of the warm calls
  dtype        the dtype that was timed
  vs_baseline  speedup over scipy.sparse.linalg.expm_multiply on the host
               CPU — the Python stand-in for the reference's expv path
               (the reference publishes no numbers of its own, BASELINE.md)

The storage-free two-pass Lanczos ``expv(two_pass=True)`` time is reported
alongside. Both are timed through the public entry points; every call ends
in ``block_until_ready`` and the first call (compilation) is excluded. The
bytes per step of the bare recurrences, and their share of HBM bandwidth,
are in ``chip_smoke.py``'s kernel phase.

Run: python bench.py
"""

import json
import time

import numpy as np


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import scipy.sparse as sp
    from scipy.sparse.linalg import expm_multiply

    import exponentialutilities_jl_tpu as eu
    from exponentialutilities_jl_tpu.utils.aot import use_compile_cache
    from exponentialutilities_jl_tpu.utils.profiling import timed

    use_compile_cache()
    dev = jax.devices()[0]
    print(json.dumps({"platform": dev.platform, "device_kind":
                      dev.device_kind, "count": len(jax.devices())}),
          flush=True)

    n, m, t = 100_000, 30, 0.5
    dtype = jnp.float32
    op = eu.laplacian_nd_stencil(n, dtype=dtype)
    b_host = np.random.default_rng(0).standard_normal(n)
    b = jnp.asarray(b_host, dtype)
    bounds = op.spectral_bounds_hint()               # [-4, 0] exactly

    w, _, cheb_s = timed(
        lambda: eu.expv_chebyshev(t, op, b, bounds=bounds, tol=1e-7), 20)
    _, _, lanczos_s = timed(lambda: eu.expv(t, op, b, m=m, two_pass=True),
                            20)

    A = sp.diags([np.ones(n - 1), -2 * np.ones(n), np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    t0 = time.perf_counter()
    ref = expm_multiply(t * A, b_host)
    scipy_ms = (time.perf_counter() - t0) * 1e3
    w = np.asarray(w, np.float64)
    rel_err = float(np.linalg.norm(w - ref) / np.linalg.norm(ref))
    op64 = eu.laplacian_nd_stencil(n, dtype=jnp.float64)
    w64 = np.asarray(eu.expv(t, op64, jnp.asarray(b_host), m=40,
                             two_pass=True))
    rel_err_64 = float(np.linalg.norm(w64 - ref) / np.linalg.norm(ref))

    ms = cheb_s * 1e3
    print(json.dumps({
        "metric": "expv_laplacian1d_n1e5_ms",
        "value": ms,
        "unit": "ms",
        "dtype": np.dtype(dtype).name,
        "vs_baseline": scipy_ms / ms,
        "device_kind": dev.device_kind,
        "method": "expv_chebyshev",
        "two_pass_lanczos_m30_ms": lanczos_s * 1e3,
        "rel_err_vs_scipy": rel_err,
        "rel_err_f64_vs_scipy": rel_err_64,
        "scipy_expm_multiply_ms": scipy_ms,
        # stencil SpMV traffic per matvec in the timed dtype: x read +
        # y write (the stencil's coefficients are 3 scalars)
        "bytes_per_matvec": 2 * n * np.dtype(dtype).itemsize,
    }))


if __name__ == "__main__":
    main()
