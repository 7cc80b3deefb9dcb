"""Niesen–Wright adaptive time-stepping + KIOPS + Taylor expv tests
(reference: test/basictests.jl:513-572, 664-689)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

import exponentialutilities_jl_tpu as eu


def laplacian_1d(n):
    A = np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
    return A


def phi_combination_oracle(ts, A, B):
    # u(t) = sum_j t^j phi_j(tA) b_j via block-matrix phi oracle
    n, ppo = B.shape
    p = ppo - 1
    out = np.zeros((n, len(ts)))
    for i, t in enumerate(ts):
        k = max(p, 1)
        E = np.zeros((n, k * n)); E[:, :n] = np.eye(n)
        J = np.kron(np.diag(np.ones(k - 1), 1), np.eye(n)) if k > 1 else np.zeros((n, n))
        P = sla.expm(np.block([[t * A, E], [np.zeros((k * n, n)), J]]))
        u = sla.expm(t * A) @ B[:, 0]
        for j in range(1, p + 1):
            u = u + (t ** j) * (P[:n, j * n:(j + 1) * n] @ B[:, j])
        out[:, i] = u
    return out


class TestPhivTimestep:
    def test_adaptive_hits_tolerance(self, rng):
        # reference: test/basictests.jl:664-689 — n=100 tridiagonal
        # Laplacian, t=5, two snapshots, tol 1e-7 vs dense phi oracle.
        n = 100
        A = laplacian_1d(n)
        B = rng.standard_normal((n, 3))
        ts = np.array([2.5, 5.0])
        U = eu.phiv_timestep(ts, A, B, adaptive=True, tol=1e-7, m=10)
        exact = phi_combination_oracle(ts, A, B)
        for i in range(2):
            rel = np.linalg.norm(np.asarray(U)[:, i] - exact[:, i]) / np.linalg.norm(exact[:, i])
            assert rel < 1e-6, (i, rel)

    def test_nonadaptive_small_steps(self, rng):
        n = 60
        A = laplacian_1d(n) * 0.5
        B = rng.standard_normal((n, 2))
        U = eu.phiv_timestep(1.0, A, B, tau=0.05, m=20)
        exact = phi_combination_oracle([1.0], A, B)[:, 0]
        assert np.linalg.norm(np.asarray(U) - exact) / np.linalg.norm(exact) < 1e-7

    def test_scalar_ts_returns_vector(self, rng):
        n = 30
        A = laplacian_1d(n)
        B = rng.standard_normal((n, 2))
        u = eu.phiv_timestep(1.0, A, B, adaptive=True, tol=1e-6)
        assert np.asarray(u).shape == (n,)

    def test_stats(self, rng):
        n = 40
        A = laplacian_1d(n)
        B = rng.standard_normal((n, 2))
        u, stats = eu.phiv_timestep(3.0, A, B, adaptive=True, tol=1e-7,
                                    return_stats=True)
        assert stats.steps >= 1 and stats.matvecs > 0

    def test_unsorted_ts_restored(self, rng):
        n = 40
        A = laplacian_1d(n)
        B = rng.standard_normal((n, 2))
        ts = np.array([3.0, 1.0, 2.0])
        U = np.asarray(eu.phiv_timestep(ts, A, B, adaptive=True, tol=1e-6))
        exact = phi_combination_oracle(ts, A, B)
        for i in range(3):
            assert np.linalg.norm(U[:, i] - exact[:, i]) / np.linalg.norm(exact[:, i]) < 1e-5


class TestExpvTimestep:
    def test_vs_expm(self, rng):
        n = 80
        A = laplacian_1d(n)
        b = rng.standard_normal(n)
        ts = np.array([1.0, 5.0])
        U = eu.expv_timestep(ts, A, b, adaptive=True, tol=1e-8)
        for i, t in enumerate(ts):
            exact = sla.expm(t * A) @ b
            assert np.linalg.norm(np.asarray(U)[:, i] - exact) / np.linalg.norm(exact) < 1e-6

    def test_opnorm_seeding(self, rng):
        n = 50
        A = laplacian_1d(n)
        b = rng.standard_normal(n)
        u = eu.expv_timestep(2.0, A, b, adaptive=True, tol=1e-7, opnorm=4.0)
        exact = sla.expm(2.0 * A) @ b
        assert np.linalg.norm(np.asarray(u) - exact) / np.linalg.norm(exact) < 1e-6


class TestKiops:
    def test_phi_combination(self, rng):
        # reference: test/basictests.jl kiops vs dense phi
        n = 60
        A = laplacian_1d(n)
        u = rng.standard_normal((n, 4))
        w, stats = eu.kiops([1.0], A, u, tol=1e-10)
        # kiops computes sum_j t^j phi_j(tA) u_j (reference oracle:
        # test/basictests.jl:533-534 divides u_j by t^j to recover plain phi)
        exact = phi_combination_oracle([1.0], A, np.asarray(u))[:, 0]
        assert np.linalg.norm(np.asarray(w)[:, 0] - exact) / np.linalg.norm(exact) < 1e-7
        assert stats.steps >= 1

    def test_multiple_tstops(self, rng):
        n = 40
        A = laplacian_1d(n) * 0.5
        u = rng.standard_normal((n, 2))
        W, _ = eu.kiops([0.5, 1.0], A, u, tol=1e-9)
        W = np.asarray(W)
        for i, t in enumerate([0.5, 1.0]):
            # w(t) = exp(tA)u0 + t·phi_1(tA)u1 (t^j prefactors, like NW)
            exact = phi_combination_oracle([t], A, np.asarray(u))[:, 0]
            assert np.linalg.norm(W[:, i] - exact) / np.linalg.norm(exact) < 1e-6, i

    def test_expv_special_case(self, rng):
        # p=0: kiops pads a zero column and reduces to exp(tA)u0
        n = 50
        A = laplacian_1d(n)
        b = rng.standard_normal(n)
        w, _ = eu.kiops(2.0, A, b, tol=1e-10)   # scalar tstop -> vector out
        exact = sla.expm(2.0 * A) @ b
        assert np.asarray(w).shape == (n,)
        assert np.linalg.norm(np.asarray(w) - exact) / np.linalg.norm(exact) < 1e-7

    def test_stiff_operator_adapts(self, rng):
        # advection-diffusion-ish stiff operator
        n = 64
        A = laplacian_1d(n) * (n / 10.0) ** 2 + np.diag(np.ones(n - 1), 1) * n / 20.0
        b = rng.standard_normal(n)
        w, stats = eu.kiops([0.1], A, b, tol=1e-8)
        exact = sla.expm(0.1 * A) @ b
        assert np.linalg.norm(np.asarray(w)[:, 0] - exact) / np.linalg.norm(exact) < 1e-5
        assert stats.steps >= 1


class TestExpvTaylor:
    def test_dense_small(self, rng):
        # reference ext: SMatrix expv path
        for n in [4, 8, 20]:
            A = rng.standard_normal((n, n))
            b = rng.standard_normal(n)
            w = eu.expv_taylor(0.9, A, b)
            exact = sla.expm(0.9 * A) @ b
            assert np.linalg.norm(np.asarray(w) - exact) / np.linalg.norm(exact) < 1e-12

    def test_large_norm(self, rng):
        n = 12
        A = rng.standard_normal((n, n)) * 30
        b = rng.standard_normal(n)
        w = eu.expv_taylor(1.0, A, b)
        exact = sla.expm(A) @ b
        assert np.linalg.norm(np.asarray(w) - exact) / np.linalg.norm(exact) < 1e-9

    def test_operator_path(self, rng):
        n = 200
        A = laplacian_1d(n)
        op = eu.DenseOperator(jnp.asarray(A), is_hermitian=True)
        b = rng.standard_normal(n)
        w = eu.expv_taylor(1.0, op, b)   # uses opnorm_hint
        exact = sla.expm(A) @ b
        assert np.linalg.norm(np.asarray(w) - exact) / np.linalg.norm(exact) < 1e-10

    def test_matrix_free_requires_norm(self, rng):
        op = eu.MatrixFreeOperator(lambda x: x, (5, 5), dtype=np.float64)
        with pytest.raises(ValueError):
            eu.expv_taylor(1.0, op, np.ones(5))

    def test_zero_matrix(self):
        w = eu.expv_taylor(1.0, np.zeros((6, 6)), np.ones(6))
        assert np.allclose(np.asarray(w), np.ones(6))

    def test_f32(self, rng):
        n = 16
        A = rng.standard_normal((n, n)).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        w = eu.expv_taylor(np.float32(0.5), A, b)
        assert w.dtype == jnp.float32
        exact = sla.expm(0.5 * A.astype(np.float64)) @ b
        assert np.linalg.norm(np.asarray(w, np.float64) - exact) / np.linalg.norm(exact) < 1e-5


class TestWarmup:
    def test_aot_warmup_compiles(self):
        import jax.numpy as jnp
        from exponentialutilities_jl_tpu.utils.aot import warmup
        out = warmup(n=32, m=10, k=1, dtype=jnp.float64)
        assert set(out) >= {"expm", "expv", "phiv"}

    def test_aot_warmup_sharded(self):
        import jax.numpy as jnp
        from exponentialutilities_jl_tpu.parallel import make_mesh
        from exponentialutilities_jl_tpu.utils.aot import warmup
        out = warmup(n=64, m=8, dtype=jnp.float64, dense=False,
                     mesh=make_mesh(8))
        assert "expv_sharded" in out


class TestFusedTimestep:
    """One-jit fixed-tau stepping (phiv_timestep_fused)."""

    def test_expv_fused_vs_expm(self, rng):
        import scipy.linalg as sla
        from exponentialutilities_jl_tpu import expv_timestep_fused
        n = 60
        A = rng.standard_normal((n, n)) / 8
        b = rng.standard_normal(n)
        u, eps = expv_timestep_fused(1.0, jnp.asarray(A), jnp.asarray(b),
                                     nsteps=8, m=20)
        oracle = sla.expm(A) @ b
        np.testing.assert_allclose(np.asarray(u), oracle, rtol=1e-8,
                                   atol=1e-10)
        assert eps.shape == (8,)

    def test_phiv_fused_matches_host_driver(self, rng):
        from exponentialutilities_jl_tpu import (phiv_timestep,
                                                 phiv_timestep_fused)
        n = 50
        A = rng.standard_normal((n, n)) / 10
        B = rng.standard_normal((n, 3))
        u, _ = phiv_timestep_fused(0.8, jnp.asarray(A), jnp.asarray(B),
                                   nsteps=4, m=25)
        U = phiv_timestep(0.8, jnp.asarray(A), jnp.asarray(B), tau=0.2,
                          m=25, adaptive=False)
        np.testing.assert_allclose(np.asarray(u), np.asarray(U), rtol=1e-7,
                                   atol=1e-9)

    def test_fused_hermitian_stencil(self, rng):
        import scipy.linalg as sla
        from exponentialutilities_jl_tpu import (expv_timestep_fused,
                                                 laplacian_1d)
        op = laplacian_1d(64)
        b = rng.standard_normal(64)
        u, _ = expv_timestep_fused(0.5, op, jnp.asarray(b), nsteps=4, m=20)
        oracle = sla.expm(0.5 * np.asarray(op.to_dense())) @ b
        np.testing.assert_allclose(np.asarray(u), oracle, rtol=1e-8,
                                   atol=1e-10)


def test_make_phiv_timestep_calibrated(rng):
    """Calibrate-then-fuse serving wrapper matches the adaptive driver."""
    import scipy.linalg as sla
    from exponentialutilities_jl_tpu import make_phiv_timestep
    n = 60
    A = rng.standard_normal((n, n)) / 8
    B = rng.standard_normal((n, 2))
    fn = make_phiv_timestep(1.0, jnp.asarray(A), jnp.asarray(B), tol=1e-8,
                            m=15)
    u, eps = fn(jnp.asarray(B))
    # oracle: u = phi0(A)b0 + phi1(A)b1
    E = np.zeros((n, 1)); E[:, 0] = B[:, 1]
    F = sla.expm(np.block([[A, E], [np.zeros((1, n + 1))]]))
    oracle = sla.expm(A) @ B[:, 0] + F[:n, n]
    np.testing.assert_allclose(np.asarray(u), oracle, rtol=1e-6, atol=1e-8)
    assert fn.nsteps >= 1 and eps.shape == (fn.nsteps,)


def test_kiops_task1_scaling(rng):
    """task1=True divides w(t) by t^p (reference: src/kiops.jl task1)."""
    n = 40
    A = rng.standard_normal((n, n)) / 10
    b = rng.standard_normal(n)
    B = jnp.asarray(np.stack([b, 0.5 * b], axis=1))
    from exponentialutilities_jl_tpu import kiops
    w1, _ = kiops([2.0], jnp.asarray(A), B, task1=False)
    w2, _ = kiops([2.0], jnp.asarray(A), B, task1=True)
    np.testing.assert_allclose(np.asarray(w2).ravel() * 2.0,
                               np.asarray(w1).ravel(), rtol=1e-10)


def test_kiops_two_pass_matches(rng):
    """Storage-free KIOPS (compact Hessenberg + replay) matches the
    basis-storing path."""
    from exponentialutilities_jl_tpu import kiops
    n = 50
    A = rng.standard_normal((n, n)) / 10
    b = rng.standard_normal(n)
    B = jnp.asarray(np.stack([b, 0.3 * b, 0.1 * b], axis=1))
    w1, s1 = kiops([1.0], jnp.asarray(A), B, tol=1e-9)
    w2, s2 = kiops([1.0], jnp.asarray(A), B, tol=1e-9, two_pass=True)
    np.testing.assert_allclose(np.asarray(w2).ravel(),
                               np.asarray(w1).ravel(), rtol=1e-8,
                               atol=1e-11)


class TestFailureProtocol:
    """No-throw failure contract threaded through the drivers: a NaN
    matvec appearing MID-solve must terminate with ``stats.info != 0`` and
    NaN outputs — never hang (KIOPS ``ω ≤ δ`` with NaN) or silently accept
    (NW ``ω > δ`` with NaN). Reference: src/phi_almohy.jl:110-142 +
    test/basictests.jl:444-456; VERDICT r1 weak #3."""

    @staticmethod
    def _poisoned_op(n):
        # matvec = M@v + NaN injected only once component j0 is nonzero.
        # b below has b[j0] = 0, so the FIRST matvec is clean and the NaN
        # appears mid-Krylov-build (a genuinely traced injection — the
        # condition is data, jnp.where keeps it inside jit).
        M = jnp.asarray(laplacian_1d(n))
        j0 = n // 2
        e0 = jnp.zeros(n).at[0].set(1.0)

        def mv(v):
            bad = jnp.where(jnp.abs(v[j0]) > 0, jnp.nan, 0.0)
            return M @ v + bad * e0

        return eu.MatrixFreeOperator(mv, (n, n), dtype=jnp.float64,
                                     is_hermitian=False, opnorm=4.0)

    def test_nw_terminates_with_info(self, rng):
        n = 16
        op = self._poisoned_op(n)
        b = np.zeros(n)
        b[0] = 1.0          # b[j0] = 0 → first matvec clean
        U, stats = eu.phiv_timestep(1.0, op, b[:, None], adaptive=True,
                                    opnorm=4.0, return_stats=True)
        assert stats.info != 0
        assert not np.all(np.isfinite(np.asarray(U)))

    def test_nw_nonadaptive_flags(self, rng):
        n = 16
        op = self._poisoned_op(n)
        b = np.zeros(n)
        b[0] = 1.0
        U, stats = eu.phiv_timestep(1.0, op, b[:, None], adaptive=False,
                                    tau=0.5, opnorm=4.0, return_stats=True)
        assert stats.info != 0
        assert not np.all(np.isfinite(np.asarray(U)))

    def test_kiops_terminates_with_info(self, rng):
        n = 16
        op = self._poisoned_op(n)
        b = np.zeros(n)
        b[0] = 1.0
        w, stats = eu.kiops([1.0], op, b[:, None], return_stats=True)
        assert stats.info != 0
        assert not np.all(np.isfinite(np.asarray(w)))

    def test_clean_solves_report_info_zero(self, rng):
        n = 16
        A = laplacian_1d(n)
        b = rng.standard_normal(n)
        _, s1 = eu.phiv_timestep(1.0, A, b[:, None], adaptive=True,
                                 return_stats=True)
        _, s2 = eu.kiops([1.0], A, b[:, None], return_stats=True)
        assert s1.info == 0 and s2.info == 0


class TestTwoPassTimestep:
    """Storage-free NW driver: O(n)-memory substeps, reduced-only τ trials
    (VERDICT r1 item 8; counterpart of kiops two_pass)."""

    def test_hermitian_matches_basis_path(self, rng):
        n, p = 100, 3
        A = laplacian_1d(n)
        B = rng.standard_normal((n, p + 1))
        U1 = eu.phiv_timestep([2.5, 5.0], A, B, adaptive=True, hermitian=True)
        U2 = eu.phiv_timestep([2.5, 5.0], A, B, adaptive=True, hermitian=True,
                              two_pass=True)
        assert (np.linalg.norm(np.asarray(U1) - np.asarray(U2))
                / np.linalg.norm(np.asarray(U1)) < 1e-7)

    def test_arnoldi_iop_matches_basis_path(self, rng):
        n, p = 80, 2
        A = laplacian_1d(n) + 0.5 * (np.diag(np.ones(n - 1), 1)
                                     - np.diag(np.ones(n - 1), -1))
        B = rng.standard_normal((n, p + 1))
        U1 = eu.phiv_timestep([1.0], A, B, adaptive=True, hermitian=False,
                              iop=4)
        U2 = eu.phiv_timestep([1.0], A, B, adaptive=True, hermitian=False,
                              iop=4, two_pass=True)
        assert (np.linalg.norm(np.asarray(U1) - np.asarray(U2))
                / np.linalg.norm(np.asarray(U1)) < 1e-7)

    def test_two_pass_vs_oracle_with_snapshots(self, rng):
        n, p = 60, 2
        A = laplacian_1d(n)
        B = rng.standard_normal((n, p + 1))
        ts = [0.7, 1.3, 2.0]
        U = eu.phiv_timestep(ts, A, B, adaptive=True, tol=1e-8,
                             hermitian=True, two_pass=True)
        want = phi_combination_oracle(ts, A, B)
        assert (np.linalg.norm(np.asarray(U) - want)
                / np.linalg.norm(want) < 1e-6)

    def test_two_pass_rejects_correct_kwarg(self, rng):
        n = 16
        A = laplacian_1d(n)
        with pytest.raises(NotImplementedError):
            eu.phiv_timestep(1.0, A, np.ones((n, 2)), two_pass=True,
                             correct=True)


class TestDeviceResidentNW:
    """Device-resident adaptive driver (models/nw_device.py): whole
    accept/reject control flow in one compiled while_loop per m bucket
    (VERDICT r1 item 4)."""

    def test_matches_host_driver_hermitian(self, rng):
        n, p = 100, 3
        A = laplacian_1d(n)
        B = rng.standard_normal((n, p + 1))
        U1, s1 = eu.phiv_timestep([2.5, 5.0], A, B, adaptive=True,
                                  hermitian=True, return_stats=True)
        U2, s2 = eu.phiv_timestep_device([2.5, 5.0], A, B, hermitian=True,
                                         return_stats=True)
        assert s2.info == 0
        assert (np.linalg.norm(np.asarray(U1) - np.asarray(U2))
                / np.linalg.norm(np.asarray(U1)) < 1e-9)

    def test_advection_diffusion_vs_oracle(self, rng):
        # config-4 class problem: stiff advection–diffusion, non-Hermitian
        n, p = 200, 2
        A = 40.0 * laplacian_1d(n) + 10.0 * (np.diag(np.ones(n - 1), 1)
                                             - np.diag(np.ones(n - 1), -1))
        B = rng.standard_normal((n, p + 1))
        ts = [0.05, 0.1]
        U, stats = eu.phiv_timestep_device(ts, A, B, tol=1e-7, iop=4,
                                           hermitian=False,
                                           return_stats=True)
        assert stats.info == 0
        want = phi_combination_oracle(ts, A, B)
        rel = np.linalg.norm(np.asarray(U) - want) / np.linalg.norm(want)
        assert rel < 1e-6, rel

    def test_expm_taylor_reduced_engine(self, rng):
        # the solver-free reduced engine (expm_method="taylor") must agree
        n, p = 80, 2
        A = laplacian_1d(n)
        B = rng.standard_normal((n, p + 1))
        U1 = eu.phiv_timestep_device(1.0, A, B, hermitian=True,
                                     expm_method="higham2005")
        U2 = eu.phiv_timestep_device(1.0, A, B, hermitian=True,
                                     expm_method="taylor")
        assert (np.linalg.norm(np.asarray(U1) - np.asarray(U2))
                / np.linalg.norm(np.asarray(U1)) < 1e-12)

    def test_expv_device_wrapper(self, rng):
        n = 64
        A = laplacian_1d(n)
        b = rng.standard_normal(n)
        w = eu.expv_timestep_device(1.0, A, b, hermitian=True)
        want = sla.expm(1.0 * A) @ b
        assert np.linalg.norm(np.asarray(w) - want) / np.linalg.norm(want) < 1e-6

    def test_failure_protocol_device(self, rng):
        n = 16
        op = TestFailureProtocol._poisoned_op(n)
        b = np.zeros(n)
        b[0] = 1.0
        U, stats = eu.phiv_timestep_device(1.0, op, b[:, None], opnorm=4.0,
                                           return_stats=True)
        assert stats.info != 0
        assert not np.all(np.isfinite(np.asarray(U)))


def test_expm_taylor_method(rng):
    # solver-free expm engine vs scipy across norm scales
    for scale in [0.1, 1.0, 10.0, 300.0]:
        A = rng.standard_normal((20, 20)) * scale / 4
        X = np.asarray(eu.expm(A, method="taylor"))
        want = sla.expm(A)
        rel = np.max(np.abs(X - want)) / np.max(np.abs(want))
        # forward error scales with u*kappa ~ u*||A||; 1e-12 covers the
        # norm-300 case
        assert rel < 1e-12, (scale, rel)


class TestDeviceResidentKiops:
    """Device-resident KIOPS (models/kiops_device.py): the augmented-
    subspace adaptive loop as one while_loop program per m bucket."""

    def test_matches_host_kiops(self, rng):
        n, p = 100, 2
        A = laplacian_1d(n)
        B = rng.standard_normal((n, p + 1))
        w1, s1 = eu.kiops([1.0], A, B, tol=1e-8)
        w2, s2 = eu.kiops_device([1.0], A, B, tol=1e-8)
        assert s2.info == 0
        rel = (np.linalg.norm(np.asarray(w1).ravel() - np.asarray(w2).ravel())
               / np.linalg.norm(np.asarray(w1).ravel()))
        assert rel < 1e-7

    def test_snapshots_and_task1(self, rng):
        n, p = 80, 2
        A = laplacian_1d(n) + 0.5 * (np.diag(np.ones(n - 1), 1)
                                     - np.diag(np.ones(n - 1), -1))
        B = rng.standard_normal((n, p + 1))
        w1, _ = eu.kiops([0.4, 1.0], A, B, tol=1e-8, task1=True)
        w2, s2 = eu.kiops_device([0.4, 1.0], A, B, tol=1e-8, task1=True)
        assert s2.info == 0
        assert (np.linalg.norm(np.asarray(w1) - np.asarray(w2))
                / np.linalg.norm(np.asarray(w1)) < 1e-7)

    def test_failure_protocol(self, rng):
        n = 100
        A = laplacian_1d(n)
        Mj = jnp.asarray(A)
        e0 = jnp.zeros(n).at[0].set(1.0)

        def mv(v):
            return Mj @ v + jnp.where(jnp.abs(v[3]) > 0, jnp.nan, 0.0) * e0

        op = eu.MatrixFreeOperator(mv, (n, n), dtype=jnp.float64,
                                   opnorm=4.0)
        b0 = np.zeros(n)
        b0[0] = 1.0
        w, stats = eu.kiops_device([1.0], op, b0[:, None], tol=1e-8)
        assert stats.info != 0
        assert not np.all(np.isfinite(np.asarray(w)))


class TestSignedTimes:
    """t ≤ 0 output times (VERDICT r2 weak #1): the forward-marching NW
    drivers used to return silently-zero U for tend ≤ 0. Now: all-zero ts
    → b₀ columns; negative ts → sign-marching via the NegatedOperator
    reduction u(-σ; A, b_j) = u(σ; -A, (-1)^j b_j); mixed signs → both
    sides marched from t = 0 (reference precedent: kiops marches
    abs(tau), src/kiops.jl:129)."""

    def test_all_zero_ts_returns_b0(self, rng):
        n = 40
        A = laplacian_1d(n)
        B = rng.standard_normal((n, 2))
        U = eu.phiv_timestep(np.array([0.0]), A, B, adaptive=True)
        np.testing.assert_allclose(np.asarray(U)[:, 0], B[:, 0])
        u = eu.phiv_timestep(0.0, A, B, adaptive=True)
        assert np.asarray(u).shape == (n,)
        np.testing.assert_allclose(np.asarray(u), B[:, 0])

    def test_negative_t_expv(self, rng):
        n = 50
        A = laplacian_1d(n) * 0.7
        b = rng.standard_normal(n)
        u = eu.expv_timestep(-1.0, A, b, adaptive=True, tol=1e-9, m=20)
        exact = sla.expm(-1.0 * A) @ b
        rel = np.linalg.norm(np.asarray(u) - exact) / np.linalg.norm(exact)
        assert rel < 1e-6, rel

    def test_negative_phiv_combination(self, rng):
        n = 40
        A = laplacian_1d(n)
        B = rng.standard_normal((n, 3))
        ts = [-1.0, -0.4]
        U = eu.phiv_timestep(np.array(ts), A, B, adaptive=True, tol=1e-8,
                             m=20)
        exact = phi_combination_oracle(ts, A, B)
        for i in range(len(ts)):
            rel = (np.linalg.norm(np.asarray(U)[:, i] - exact[:, i])
                   / np.linalg.norm(exact[:, i]))
            assert rel < 1e-6, (i, rel)

    def test_mixed_sign_ts(self, rng):
        n = 40
        A = laplacian_1d(n)
        B = rng.standard_normal((n, 2))
        ts = [-0.8, 0.0, 0.6]
        U = eu.phiv_timestep(np.array(ts), A, B, adaptive=True, tol=1e-8,
                             m=20)
        exact = phi_combination_oracle(ts, A, B)
        np.testing.assert_allclose(np.asarray(U)[:, 1], B[:, 0])
        for i in (0, 2):
            rel = (np.linalg.norm(np.asarray(U)[:, i] - exact[:, i])
                   / np.linalg.norm(exact[:, i]))
            assert rel < 1e-6, (i, rel)

    def test_mixed_sign_stats_combine(self, rng):
        n = 24
        A = laplacian_1d(n)
        b = rng.standard_normal(n)
        U, stats = eu.phiv_timestep(np.array([-0.5, 0.5]), A, b[:, None],
                                    adaptive=True, return_stats=True)
        assert stats.steps >= 2 and stats.info == 0
        assert np.all(np.isfinite(np.asarray(U)))

    def test_two_pass_negative(self, rng):
        n = 40
        A = laplacian_1d(n)
        b = rng.standard_normal(n)
        u = eu.expv_timestep(-0.9, A, b, adaptive=True, two_pass=True,
                             tol=1e-8, m=20)
        exact = sla.expm(-0.9 * A) @ b
        rel = np.linalg.norm(np.asarray(u) - exact) / np.linalg.norm(exact)
        assert rel < 1e-6, rel

    def test_device_driver_negative_and_zero(self, rng):
        n = 40
        A = laplacian_1d(n)
        B = rng.standard_normal((n, 2))
        ts = [-0.7, 0.0]
        U = eu.phiv_timestep_device(np.array(ts), A, B, tol=1e-8, m=20)
        exact = phi_combination_oracle(ts, A, B)
        rel = (np.linalg.norm(np.asarray(U)[:, 0] - exact[:, 0])
               / np.linalg.norm(exact[:, 0]))
        assert rel < 1e-6, rel
        np.testing.assert_allclose(np.asarray(U)[:, 1], B[:, 0])

    def test_fused_negative_tend(self, rng):
        n = 40
        A = laplacian_1d(n)
        b = rng.standard_normal(n)
        u, eps_hist = eu.expv_timestep_fused(-1.0, A, b, nsteps=20, m=20)
        exact = sla.expm(-1.0 * A) @ b
        rel = np.linalg.norm(np.asarray(u) - exact) / np.linalg.norm(exact)
        assert rel < 1e-6, rel


class TestDiscardedInfoWarning:
    """stats.info ≠ 0 with return_stats=False must WARN (VERDICT r2 weak
    #3: the default return path silently dropped the failure code while
    the returned U was partially NaN)."""

    def test_nonadaptive_warns(self, rng):
        n = 16
        op = TestFailureProtocol._poisoned_op(n)
        b = np.zeros(n)
        b[0] = 1.0
        with pytest.warns(RuntimeWarning, match="info="):
            U = eu.phiv_timestep(1.0, op, b[:, None], adaptive=False,
                                 tau=0.5, opnorm=4.0)
        assert not np.all(np.isfinite(np.asarray(U)))

    def test_adaptive_device_warns(self, rng):
        n = 16
        op = TestFailureProtocol._poisoned_op(n)
        b = np.zeros(n)
        b[0] = 1.0
        with pytest.warns(RuntimeWarning, match="info="):
            U = eu.phiv_timestep_device(1.0, op, b[:, None], opnorm=4.0)
        assert not np.all(np.isfinite(np.asarray(U)))

    def test_clean_solve_does_not_warn(self, rng):
        import warnings
        n = 16
        A = laplacian_1d(n)
        b = rng.standard_normal(n)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            eu.phiv_timestep(1.0, A, b[:, None], adaptive=True)


def test_verbose_output_captured(capsys, rng):
    # reference parity: the stdout-capture verbose test
    # (test/basictests.jl:191-203) — verbose=True prints the adaptation
    # trail, verbose=False prints nothing
    import exponentialutilities_jl_tpu as eu
    A = rng.standard_normal((40, 40)) / 8
    A = A + A.T
    b = rng.standard_normal(40)
    eu.expv_timestep([1.0], A, b, adaptive=True, verbose=True,
                     hermitian=True)
    out = capsys.readouterr().out
    assert out.strip()                   # something was printed
    eu.expv_timestep([1.0], A, b, adaptive=True, hermitian=True)
    assert capsys.readouterr().out == ""
