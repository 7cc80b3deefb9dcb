"""Chebyshev matrix-function actions (models/chebyshev.py).

Oracles are independent of the implementation: scipy dense expm /
expm_multiply, the φ block-matrix identities, dense cosm, and the
Krylov expv path (which shares no code with the Chebyshev recurrence).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg as sla

from exponentialutilities_jl_tpu import (
    DenseOperator, expv, expv_chebyshev, phiv_chebyshev, funm_chebyshev,
    chebyshev_apply, spectral_bounds, laplacian_1d, phiv,
)
from exponentialutilities_jl_tpu.ops.stencil import (
    laplacian_nd_stencil, variable_diffusion_nd_stencil)
from exponentialutilities_jl_tpu.models.chebyshev import (
    _exp_ucoeffs, _phi_scalar_np, _fun_ucoeffs)


def _rand_sym(rng, n, scale=1.0):
    A = rng.standard_normal((n, n))
    return scale * (A + A.T) / 2


class TestCoefficients:
    def test_exp_ucoeffs_reconstruct(self):
        """Σ b_k U_k(x) must reproduce e^{z x} pointwise on [-1, 1]."""
        for z in (0.3, 4.0, -12.5, 40.0):
            b, scale = _exp_ucoeffs(z, 1e-14)
            x = np.linspace(-1, 1, 201)
            theta = np.arccos(np.clip(x, -1, 1))
            # U_k(cos θ) = sin((k+1)θ)/sin θ (limits at endpoints: k+1)
            k = np.arange(len(b))[:, None]
            with np.errstate(invalid="ignore", divide="ignore"):
                U = np.sin((k + 1) * theta[None, :]) / np.sin(theta[None, :])
            U[:, 0] = ((k + 1) * (-1.0) ** k)[:, 0]
            U[:, -1] = (k + 1)[:, 0]
            vals = (b[:, None] * U).sum(0) * np.exp(scale)
            ref = np.exp(z * x)
            assert np.max(np.abs(vals - ref) / np.abs(ref).max()) < 1e-12

    def test_exp_ucoeffs_degree_scales_with_z(self):
        m_small = len(_exp_ucoeffs(1.0, 1e-10)[0])
        m_big = len(_exp_ucoeffs(100.0, 1e-10)[0])
        assert m_small < 30
        # tail cut at k ≈ √(2z·ln(1/tol)) ≈ 68 for z=100, tol=1e-10
        assert 50 < m_big < 120

    def test_phi_scalar_np_small_large(self):
        z = np.array([1e-8, 0.3, 0.7, 5.0, -30.0])
        vals = _phi_scalar_np(z, 3)
        # φ-recurrence identity z·φ_{k+1} = φ_k − 1/k!
        import math
        for k in range(3):
            lhs = z * vals[k + 1]
            rhs = vals[k] - 1.0 / math.factorial(k)
            assert np.max(np.abs(lhs - rhs)) < 1e-12 * np.abs(vals[k]).max()

    def test_fun_ucoeffs_matches_exp(self):
        """DCT coefficient path must agree with the Bessel path for exp."""
        z = 7.3
        b_dct = _fun_ucoeffs(lambda x: np.exp(z * x), 1e-13, 512)
        if b_dct.ndim == 2:
            b_dct = b_dct[:, 0]
        b_bessel, scale = _exp_ucoeffs(z, 1e-13)
        m = min(len(b_dct), len(b_bessel))
        assert np.allclose(b_dct[:m], b_bessel[:m] * np.exp(scale),
                           rtol=1e-9, atol=1e-12 * np.exp(z))


class TestSpectralBounds:
    def test_encloses_dense_spectrum(self, rng):
        A = _rand_sym(rng, 200, 3.0)
        lo, hi = spectral_bounds(DenseOperator(A, is_hermitian=True), k=60)
        w = np.linalg.eigvalsh(A)
        assert lo <= w[0] and hi >= w[-1]
        assert hi - lo < 3 * (w[-1] - w[0])   # not uselessly loose

    def test_stencil_gershgorin_hint(self):
        op = laplacian_nd_stencil(8, 8, 8)
        lo, hi = op.spectral_bounds_hint()
        w = np.linalg.eigvalsh(np.asarray(op.to_banded().to_dense()))
        assert lo <= w[0] and hi >= w[-1]
        assert lo == pytest.approx(-12.0) and hi == pytest.approx(0.0)

    def test_variable_stencil_hint(self, rng):
        a = 0.5 + rng.random((6, 7, 8))
        op = variable_diffusion_nd_stencil(a)
        lo, hi = op.spectral_bounds_hint()
        w = np.linalg.eigvalsh(np.asarray(op.to_banded().to_dense()))
        assert lo <= w[0] + 1e-12 and hi >= w[-1] - 1e-12


class TestExpvChebyshev:
    def test_vs_dense_exp(self, rng):
        A = _rand_sym(rng, 150, 2.0)
        b = rng.standard_normal(150)
        w = expv_chebyshev(1.0, DenseOperator(A, is_hermitian=True), b,
                           tol=1e-12)
        ref = sla.expm(A) @ b
        assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-10

    def test_laplacian_vs_krylov(self, rng):
        op = laplacian_1d(400)
        b = jnp.asarray(rng.standard_normal(400))
        t = 0.75
        w_cheb = expv_chebyshev(t, op, b, tol=1e-12)
        w_kry = expv(t, op, b, m=60)
        assert np.linalg.norm(w_cheb - w_kry) / np.linalg.norm(w_kry) < 1e-9

    def test_stencil_hint_no_lanczos_estimate(self, rng):
        """Gershgorin hint path: no probe Lanczos run is needed."""
        op = laplacian_nd_stencil(6, 6, 6)
        n = 216
        b = jnp.asarray(rng.standard_normal(n))
        w = expv_chebyshev(0.3, op, b, tol=1e-12)
        ref = sla.expm(0.3 * np.asarray(op.to_banded().to_dense())) @ \
            np.asarray(b)
        assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-10

    def test_negative_and_positive_t(self, rng):
        A = _rand_sym(rng, 80, 1.5)
        b = rng.standard_normal(80)
        op = DenseOperator(A, is_hermitian=True)
        for t in (-2.0, 2.0):
            w = expv_chebyshev(t, op, b, tol=1e-12)
            ref = sla.expm(t * A) @ b
            assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-9

    def test_complex_t(self, rng):
        """Complex t over a real Hermitian operator (complex Bessel
        coefficients on the real recurrence)."""
        A = _rand_sym(rng, 60, 1.0)
        b = rng.standard_normal(60)
        t = 0.4 + 0.9j
        w = expv_chebyshev(t, DenseOperator(A, is_hermitian=True), b,
                           tol=1e-12)
        ref = sla.expm(t * A) @ b
        assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-9

    def test_scalar_multiple_of_identity(self):
        op = DenseOperator(jnp.eye(5) * 2.0, is_hermitian=True)
        b = jnp.arange(1.0, 6.0)
        w = expv_chebyshev(1.0, op, b, bounds=(2.0, 2.0))
        assert np.allclose(w, np.exp(2.0) * np.asarray(b), rtol=1e-12)

    def test_fixed_degree_override(self, rng):
        A = _rand_sym(rng, 50, 1.0)
        b = rng.standard_normal(50)
        op = DenseOperator(A, is_hermitian=True)
        w_low = expv_chebyshev(1.0, op, b, m=4)
        w_full = expv_chebyshev(1.0, op, b, tol=1e-13)
        ref = sla.expm(A) @ b
        err_low = np.linalg.norm(w_low - ref)
        err_full = np.linalg.norm(w_full - ref)
        assert err_full < 1e-9 and err_low > 100 * err_full

    def test_rejects_non_hermitian(self, rng):
        A = rng.standard_normal((20, 20))
        with pytest.raises(ValueError, match="Hermitian"):
            expv_chebyshev(1.0, DenseOperator(A, is_hermitian=False),
                           rng.standard_normal(20))


class TestPhivChebyshev:
    def test_vs_phiv_krylov(self, rng):
        op = laplacian_1d(300)
        b = jnp.asarray(rng.standard_normal(300))
        t = 0.5
        P_cheb = phiv_chebyshev(t, op, b, 3, tol=1e-12)
        P_kry = phiv(t, op, b, 3, m=60)
        assert P_cheb.shape == (300, 4)
        err = np.linalg.norm(np.asarray(P_cheb) - np.asarray(P_kry)) \
            / np.linalg.norm(np.asarray(P_kry))
        assert err < 1e-8

    def test_phi_identity(self, rng):
        """t·A·φ_{k+1}(tA)b = φ_k(tA)b − b/k! (the φ recurrence)."""
        import math
        A = _rand_sym(rng, 120, 1.0)
        op = DenseOperator(A, is_hermitian=True)
        b = rng.standard_normal(120)
        t = 0.8
        P = np.asarray(phiv_chebyshev(t, op, b, 3, tol=1e-13))
        for k in range(3):
            lhs = t * (A @ P[:, k + 1])
            rhs = P[:, k] - b / math.factorial(k)
            assert np.linalg.norm(lhs - rhs) < 1e-9 * max(
                np.linalg.norm(P[:, k]), 1.0)


class TestFunmChebyshev:
    def test_cosm(self, rng):
        A = _rand_sym(rng, 100, 2.0)
        b = rng.standard_normal(100)
        w = funm_chebyshev(np.cos, DenseOperator(A, is_hermitian=True), b,
                           tol=1e-12)
        ref = sla.cosm(A) @ b
        assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-9

    def test_inverse_sqrt_shifted(self, rng):
        """Spectral function with no exp structure at all."""
        A = _rand_sym(rng, 90, 1.0)
        A = A @ A.T / 10 + np.eye(90)          # SPD, spectrum ≥ 1
        b = rng.standard_normal(90)
        op = DenseOperator(jnp.asarray(A), is_hermitian=True)
        w = funm_chebyshev(lambda x: 1.0 / np.sqrt(x), op, b, tol=1e-12)
        wA, Q = np.linalg.eigh(A)
        ref = Q @ ((Q.T @ b) / np.sqrt(wA))
        assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-9

    def test_matches_expv_chebyshev(self, rng):
        A = _rand_sym(rng, 64, 1.0)
        b = rng.standard_normal(64)
        op = DenseOperator(A, is_hermitian=True)
        w1 = funm_chebyshev(np.exp, op, b, tol=1e-13)
        w2 = expv_chebyshev(1.0, op, b, tol=1e-13)
        assert np.linalg.norm(w1 - w2) / np.linalg.norm(w2) < 1e-11


class TestChebyshevApply:
    def test_matrix_coeffs_shape(self, rng):
        op = laplacian_1d(50)
        b = jnp.asarray(rng.standard_normal(50))
        coeffs = jnp.asarray(rng.standard_normal((8, 3)))
        w = chebyshev_apply(op, b, coeffs, (-4.0, 0.0))
        assert w.shape == (50, 3)

    def test_empty_interval_raises(self, rng):
        op = laplacian_1d(10)
        with pytest.raises(ValueError, match="interval"):
            chebyshev_apply(op, jnp.ones(10), jnp.ones(3), (1.0, 1.0))


class TestPhivTimestepChebyshev:
    def test_vs_nw_driver(self, rng):
        """One-pass Chebyshev combination vs the NW substepped driver."""
        from exponentialutilities_jl_tpu import phiv_timestep
        from exponentialutilities_jl_tpu.models.chebyshev import (
            phiv_timestep_chebyshev)
        op = laplacian_1d(200)
        B = jnp.asarray(rng.standard_normal((200, 4)))
        ts = [0.3, 0.7, 1.0]
        U_ch = phiv_timestep_chebyshev(ts, op, B, tol=1e-10)
        U_nw = phiv_timestep(ts, op, B, adaptive=True, tol=1e-10, m=40)
        assert U_ch.shape == (200, 3)
        err = np.linalg.norm(np.asarray(U_ch) - np.asarray(U_nw)) \
            / np.linalg.norm(np.asarray(U_nw))
        assert err < 1e-8

    def test_vs_dense_oracle_stiff(self, rng):
        """Stiff decay: t·||A|| ≈ 800 without substepping."""
        from exponentialutilities_jl_tpu.models.chebyshev import (
            phiv_timestep_chebyshev)
        import math
        n = 120
        op = laplacian_1d(n, scale=200.0)    # spectrum ~ [-800, 0]
        A = np.asarray(op.to_dense())
        B = rng.standard_normal((n, 3))
        t = 1.0
        u = phiv_timestep_chebyshev(t, op, jnp.asarray(B), tol=1e-11)
        wA, Q = np.linalg.eigh(A)
        from exponentialutilities_jl_tpu.models.chebyshev import _phi_scalar_np
        ref = np.zeros(n)
        for j in range(3):
            phij = _phi_scalar_np(t * wA, j)[j]
            ref += (t ** j) * (Q @ (phij * (Q.T @ B[:, j])))
        err = np.linalg.norm(np.asarray(u) - ref) / np.linalg.norm(ref)
        assert err < 1e-9

    def test_scalar_ts_shape(self, rng):
        from exponentialutilities_jl_tpu.models.chebyshev import (
            phiv_timestep_chebyshev)
        op = laplacian_1d(50)
        B = jnp.asarray(rng.standard_normal((50, 2)))
        u = phiv_timestep_chebyshev(0.5, op, B)
        assert u.shape == (50,)


def _dense_of(op):
    """Dense f64 matrix of a matrix-free operator, column by column."""
    n = op.shape[0]
    eye = jnp.eye(n, dtype=op.dtype)
    return np.asarray(jax.vmap(op.matvec)(eye), np.float64).T


class TestStencilChebyshevF32:
    """f32 Chebyshev actions on 3-D stencils against the dense f64 exp."""

    def test_laplacian_3d_matches_dense(self, rng):
        op = laplacian_nd_stencil(6, 6, 6, dtype=jnp.float32)
        b = rng.standard_normal(216).astype(np.float32)
        w = expv_chebyshev(0.3, op, jnp.asarray(b))
        dense = _dense_of(op)
        ref = sla.expm(0.3 * dense) @ b.astype(np.float64)
        assert np.linalg.norm(np.asarray(w, np.float64) - ref) \
            / np.linalg.norm(ref) < 1e-5

    def test_variable_stencil_matches_dense(self, rng):
        a = (0.5 + rng.random((6, 6, 6))).astype(np.float32)
        op = variable_diffusion_nd_stencil(a, dtype=np.float32)
        b = rng.standard_normal(216).astype(np.float32)
        w = expv_chebyshev(0.2, op, jnp.asarray(b))
        dense = _dense_of(op)
        ref = sla.expm(0.2 * dense) @ b.astype(np.float64)
        assert np.linalg.norm(np.asarray(w, np.float64) - ref) \
            / np.linalg.norm(ref) < 1e-5


class TestConvergenceGuards:
    def test_exp_degree_cap_raises(self):
        """Degree beyond the cap (√(2z·ln 1/tol) > 4096 needs
        z ≳ 4e5) must raise, not silently truncate (silent truncation
        returned rel err 4e79 on a scale-3e5 Laplacian in review)."""
        with pytest.raises(ValueError, match="did not converge"):
            _exp_ucoeffs(6e5, 1e-9)

    def test_expv_chebyshev_stiff_raises(self):
        op = laplacian_1d(64, scale=3e5)      # half-width h = 6e5
        with pytest.raises(ValueError, match="did not converge"):
            expv_chebyshev(1.0, op, jnp.ones(64), tol=1e-9)

    def test_fun_ucoeffs_aliasing_resamples(self):
        """A function whose coefficient tail stays significant past the
        initial sample count must auto-resample (not alias): cos(300·x)
        has O(1) coefficients up to k ≈ 300 with only 256 samples."""
        b = _fun_ucoeffs(lambda x: np.cos(300.0 * x), 1e-10, 256)
        bb = np.asarray(b)[:, 0] if np.asarray(b).ndim == 2 \
            else np.asarray(b)
        assert len(bb) > 290           # resampled past the first 256
        xs = 0.37
        theta = np.arccos(xs)
        k = np.arange(len(bb))
        U = np.sin((k + 1) * theta) / np.sin(theta)
        val = (bb * U).sum()
        assert abs(val - np.cos(300 * xs)) < 1e-8

    def test_phiv_timestep_chebyshev_unconvergible_raises(self):
        from exponentialutilities_jl_tpu.models.chebyshev import (
            phiv_timestep_chebyshev)
        op = laplacian_1d(64, scale=1e7)
        B = jnp.ones((64, 2))
        with pytest.raises(ValueError, match="did not converge"):
            phiv_timestep_chebyshev(1.0, op, B, tol=1e-9)


class TestFinitenessGuard:
    """No-silent-NaN protocol for the Chebyshev drivers (ADVICE r2 low):
    a non-enclosing spectral interval diverges the U_k recurrence — the
    drivers must raise FloatingPointError, never return inf/NaN."""

    def test_expv_diverges_loudly_on_bad_bounds(self, rng):
        # spectrum reaches -2000 but bounds claim [-20, 0]: the mapped
        # extreme |x| = 199 makes U_k blow up ~ 398^k → f32 overflow
        n = 50
        d = np.linspace(-2000.0, 0.0, n)
        A = jnp.asarray(np.diag(d), jnp.float32)
        b = jnp.asarray(rng.standard_normal(n), jnp.float32)
        with pytest.raises(FloatingPointError, match="enclose"):
            expv_chebyshev(1.0, DenseOperator(A, is_hermitian=True), b,
                           bounds=(-20.0, 0.0))

    def test_phiv_timestep_diverges_loudly(self, rng):
        from exponentialutilities_jl_tpu import phiv_timestep_chebyshev
        n = 50
        d = np.linspace(-2000.0, 0.0, n)
        A = jnp.asarray(np.diag(d), jnp.float32)
        B = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
        with pytest.raises(FloatingPointError, match="enclose"):
            phiv_timestep_chebyshev(1.0, DenseOperator(A, is_hermitian=True),
                                    B, bounds=(-20.0, 0.0))

    def test_good_bounds_do_not_raise(self, rng):
        n = 50
        d = np.linspace(-200.0, 0.0, n)
        A = jnp.asarray(np.diag(d))
        b = jnp.asarray(rng.standard_normal(n))
        w = expv_chebyshev(1.0, DenseOperator(A, is_hermitian=True), b,
                           bounds=(-201.0, 1.0))
        want = np.exp(1.0 * d) * np.asarray(b)
        assert np.linalg.norm(np.asarray(w) - want) < 1e-6


class TestSpectralBoundsProbes:
    def test_multi_probe_union_encloses(self, rng):
        from exponentialutilities_jl_tpu.models.chebyshev import \
            spectral_bounds
        n = 120
        M = rng.standard_normal((n, n))
        A = jnp.asarray((M + M.T) / 2)
        w = np.linalg.eigvalsh(np.asarray(A))
        lo, hi = spectral_bounds(DenseOperator(A, is_hermitian=True))
        assert lo <= w[0] and hi >= w[-1]

    def test_explicit_probe_still_works(self, rng):
        from exponentialutilities_jl_tpu.models.chebyshev import \
            spectral_bounds
        n = 80
        M = rng.standard_normal((n, n))
        A = jnp.asarray((M + M.T) / 2)
        probe = jnp.asarray(rng.standard_normal(n))
        lo, hi = spectral_bounds(DenseOperator(A, is_hermitian=True),
                                 probe, k=40)
        w = np.linalg.eigvalsh(np.asarray(A))
        assert lo <= w[0] + 1e-6 and hi >= w[-1] - 1e-6
