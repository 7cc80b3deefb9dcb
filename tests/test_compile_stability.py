"""Compile-stability (no-rework) regression guards across the hot APIs.

The reference pins per-call cost with allocation guards
(reference: test/basictests.jl:907-948: `@allocated` deltas on
phiv!/expv!/phiv_timestep! must be zero once caches are warm). The JAX
analogue of "zero allocations" is "zero new XLA compilations": once a
signature is warm, repeated calls — at any operator norm, time value, or
adaptation path of the same shape/dtype — must reuse the compiled
executables. These tests count actual backend compiles via the
`/jax/core/compile/backend_compile_duration` monitoring event (a monotone
counter of real XLA compilations, immune to the jitted-function-object
cache being bypassed or rebuilt).

Contracts pinned here:
  * ``expv`` / ``phiv`` / ``make_expv`` / ``make_phiv``: zero compiles after
    warmup across varying t and operator scaling.
  * adaptive ``phiv_timestep`` / ``kiops``: the m-bucket ladder
    (timestepping._M_BUCKETS) bounds the number of compiled programs — a
    long many-substep adaptive solve must NOT compile per-substep or
    per-distinct-m; re-running the same solve compiles nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import exponentialutilities_jl_tpu as eu


class _CompileCounter:
    """Monotone count of XLA backend compiles via jax.monitoring."""

    _installed = False
    _count = 0

    @classmethod
    def install(cls):
        if not cls._installed:
            def _listener(event, duration, **kw):
                if event == "/jax/core/compile/backend_compile_duration":
                    cls._count += 1
            jax.monitoring.register_event_duration_secs_listener(_listener)
            cls._installed = True

    @classmethod
    def count(cls):
        return cls._count


@pytest.fixture
def compiles():
    _CompileCounter.install()
    return _CompileCounter.count


def _dense_spd(rng, n):
    A = rng.standard_normal((n, n))
    return jnp.asarray(-(A @ A.T) / n - np.eye(n))


def test_expv_no_recompile_across_inputs(rng, compiles):
    A = _dense_spd(rng, 32)
    b = jnp.asarray(rng.standard_normal(32))
    # Pre-build the scaled inputs: the eager `scale * A` itself compiles a
    # (legitimate, one-time) elementwise program we don't want to count.
    cases = [(t, jnp.asarray(s * np.asarray(A)))
             for t, s in [(0.1, 1.0), (0.9, 3.0), (2.5, 0.25), (-0.4, 1.0)]]
    eu.expv(0.5, A, b, m=12)          # warm
    n0 = compiles()
    for t, As in cases:
        eu.expv(t, As, b, m=12)
    assert compiles() == n0, "expv recompiled for same-shape inputs"


def test_phiv_no_recompile_across_inputs(rng, compiles):
    A = _dense_spd(rng, 24)
    b = jnp.asarray(rng.standard_normal(24))
    cases = [(t, jnp.asarray(s * np.asarray(A)))
             for t, s in [(0.2, 1.0), (1.5, 2.0), (0.7, 0.5)]]
    eu.phiv(0.5, A, b, 2, m=10)       # warm
    n0 = compiles()
    for t, As in cases:
        eu.phiv(t, As, b, 2, m=10)
    assert compiles() == n0, "phiv recompiled for same-shape inputs"


def test_make_expv_factory_no_recompile(rng, compiles):
    op = eu.laplacian_1d(64)
    f = eu.make_expv(op, m=16)
    b = jnp.asarray(rng.standard_normal(64))
    f(0.3, b)                          # warm
    n0 = compiles()
    for t in (0.05, 0.8, 1.7, -0.2):
        f(t, b)
    assert compiles() == n0, "make_expv executable not reused"


def test_make_phiv_factory_no_recompile(rng, compiles):
    op = eu.laplacian_1d(48)
    f = eu.make_phiv(op, 2, m=12)
    b = jnp.asarray(rng.standard_normal(48))
    f(0.3, b)                          # warm
    n0 = compiles()
    for t in (0.1, 0.6, 1.2):
        f(t, b)
    assert compiles() == n0, "make_phiv executable not reused"


class TestAdaptiveDriverProgramBound:
    """The m-bucket contract: compiled-program count is bounded by the
    bucket ladder, never by the substep/rejection count."""

    def test_nw_many_substeps_bounded_programs(self, rng, compiles):
        # Stiff enough to force many substeps and (m, tau) adaptation.
        n = 96
        op = eu.laplacian_1d(n)
        B = jnp.asarray(rng.standard_normal((n, 3)))
        ts = np.linspace(0.0, 40.0, 5)[1:]

        n0 = compiles()
        U, stats = eu.phiv_timestep(ts, op, B, m=8, tol=1e-8,
                                    return_stats=True)
        first_solve = compiles() - n0
        assert stats.steps >= 8, "bench precondition: want a many-substep solve"
        # Program count must be ladder-bounded, NOT substep-bounded. Each
        # visited bucket compiles a handful of programs (build/coeffs/
        # replay/update); the whole solve on top of a warm package must stay
        # far below one-compile-per-substep.
        from exponentialutilities_jl_tpu.models.timestepping import _M_BUCKETS
        per_bucket_programs = 6
        fixed_overhead = 24   # W columns, reduced exp, combine, stats paths
        bound = len(_M_BUCKETS) * per_bucket_programs + fixed_overhead
        assert first_solve <= bound, (
            f"adaptive NW compiled {first_solve} programs over a "
            f"{stats.steps}-substep solve; ladder bound is {bound}")

        # Re-running the identical solve must compile NOTHING.
        n1 = compiles()
        U2, stats2 = eu.phiv_timestep(ts, op, B, m=8, tol=1e-8,
                                      return_stats=True)
        assert compiles() == n1, "second identical NW solve recompiled"
        np.testing.assert_allclose(np.asarray(U2), np.asarray(U),
                                   rtol=0, atol=0)

        # A different adaptation path (different stiffness, same shapes)
        # may only touch NEW buckets — bounded growth, and zero if the
        # bucket set repeats.
        n2 = compiles()
        eu.phiv_timestep(ts / 4.0, op, B, m=8, tol=1e-8)
        assert compiles() - n2 <= per_bucket_programs * len(_M_BUCKETS)

    def test_kiops_repeat_solve_no_recompile(self, rng, compiles):
        n = 64
        op = eu.laplacian_1d(n)
        u = jnp.asarray(rng.standard_normal((n, 4)))   # columns: b, φ1..φ3
        eu.kiops([1.0], op, u, tol=1e-8)          # warm (adaptive path)
        eu.kiops([1.0], op, u, tol=1e-8)
        n0 = compiles()
        out = eu.kiops([1.0], op, u, tol=1e-8)
        assert compiles() == n0, "second identical kiops solve recompiled"
        # and across a *rescaled* problem of the same shape, growth is at
        # most the not-yet-visited m buckets, never per-substep:
        n1 = compiles()
        eu.kiops([1.0], op, 0.1 * u, tol=1e-8)
        eu.kiops([2.0], op, u, tol=1e-6)
        assert compiles() - n1 <= 40
