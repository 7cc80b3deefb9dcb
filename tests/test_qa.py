"""API hygiene — the analogue of the reference's QA group
(test/qa/qa.jl: Aqua + ExplicitImports public-API checks)."""

import importlib
import inspect

import pytest

import exponentialutilities_jl_tpu as eu


def test_all_exports_exist():
    for name in eu.__all__:
        assert hasattr(eu, name), f"__all__ lists missing symbol {name}"


def test_submodule_alls_resolve():
    for mod in ["ops.expm", "ops.phi_dense", "ops.krylov", "ops.sparse",
                "ops.host_reduced", "models.expv", "models.phiv",
                "models.timestepping", "models.kiops", "models.expv_taylor",
                "utils.linop", "utils.testmatrices", "parallel.ops",
                "parallel.krylov", "parallel.gspmd"]:
        m = importlib.import_module(f"exponentialutilities_jl_tpu.{mod}")
        for name in getattr(m, "__all__", []):
            assert hasattr(m, name), f"{mod}.__all__ lists missing {name}"


def test_public_functions_documented():
    undocumented = [n for n in eu.__all__
                    if callable(getattr(eu, n))
                    and not inspect.getdoc(getattr(eu, n))]
    assert not undocumented, f"undocumented public symbols: {undocumented}"


def test_version():
    assert eu.__version__


def test_profiling_hooks_smoke(tmp_path):
    # SURVEY §5: optional jax.profiler hooks — must work (or no-op
    # gracefully) on any backend
    import numpy as np
    import jax.numpy as jnp
    import exponentialutilities_jl_tpu as eu
    from exponentialutilities_jl_tpu.utils.profiling import annotate, trace

    A = np.diag(-2.0 * np.ones(32)) + np.diag(np.ones(31), 1) \
        + np.diag(np.ones(31), -1)
    b = np.ones(32)
    with trace(str(tmp_path / "trace")):
        with annotate("expv-smoke"):
            w = eu.expv(0.1, A, jnp.asarray(b), m=10)
    assert np.all(np.isfinite(np.asarray(w)))


@pytest.mark.parametrize("reps", [0, 1, 4])
def test_timed_counts_calls_and_returns_last_result(reps):
    from exponentialutilities_jl_tpu.utils.profiling import timed

    calls = []

    def fn():
        calls.append(1)
        return len(calls)

    out, first, warm = timed(fn, reps)
    assert out == reps + 1 and len(calls) == reps + 1
    assert first >= 0
    assert (warm is None) if reps == 0 else warm >= 0


def test_no_tracer_leaks_representative_workload(rng=None):
    """JET/AllocCheck analogue (VERDICT r2 'partial' row): JAX's static
    hygiene checks are (a) tracer-LEAK detection — a leaked tracer is the
    JAX analogue of a type instability escaping a function barrier — and
    (b) strict rank promotion, which catches silent broadcasting bugs the
    way a type-check pass catches mismatched containers. Run a
    representative slice of the library under both."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import exponentialutilities_jl_tpu as eu

    rng = np.random.default_rng(7)
    prev = jax.config.jax_numpy_rank_promotion
    try:
        jax.config.update("jax_numpy_rank_promotion", "raise")
        with jax.checking_leaks():
            A = jnp.asarray(rng.standard_normal((24, 24)) / 6)
            b = jnp.asarray(rng.standard_normal(24))
            eu.expm(A)
            eu.phi(A, 2)
            eu.expv(0.5, A, b, m=16)
            eu.phiv(0.5, A, b, 2, m=16)
            op = eu.laplacian_1d(64)
            b64 = jnp.asarray(rng.standard_normal(64))
            eu.expv_chebyshev(0.05, op, b64)
            eu.expv_taylor(0.3, A, b)
            U, stats = eu.phiv_timestep([0.5, 1.0], op,
                                        b64[:, None], return_stats=True)
            assert stats.info == 0
    finally:
        jax.config.update("jax_numpy_rank_promotion", prev)
