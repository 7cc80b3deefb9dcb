"""Faber-series actions on the field-of-values ellipse (models/faber.py).

Oracles: scipy dense expm, the Sidje augmented-matrix φ oracle, and
scipy.sparse expm_multiply at sizes where dense is too big. The headline
capability pinned here is the one the Leja Newton basis cannot deliver:
a SINGLE substep at z = |t|·γ ≥ 500 at full accuracy (the Newton form's
conditioning envelope ends at z ≈ 150 — models/leja.py docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import exponentialutilities_jl_tpu as eu
from exponentialutilities_jl_tpu.models.faber import (
    expv_faber, phiv_faber, phiv_timestep_faber, fov_ellipse)


def _dense(op):
    return np.asarray(op.to_dense())


def _phi_oracle(t, Ad, B):
    """u(t) = Σ_j t^j φ_j(tA) b_j via augmented-matrix exponentials."""
    n = Ad.shape[0]
    u = sla.expm(t * Ad) @ B[:, 0]
    for j in range(1, B.shape[1]):
        Au = np.zeros((n + j, n + j))
        Au[:n, :n] = t * Ad
        Au[:n, n] = B[:, j]
        for i in range(j - 1):
            Au[n + i, n + i + 1] = 1.0
        u = u + (t ** j) * sla.expm(Au)[:n, n + j - 1]
    return u


class TestFovEllipse:
    def test_encloses_eigenvalues_dense(self, rng):
        for _ in range(3):
            M = rng.standard_normal((40, 40))
            c, a, b = fov_ellipse(jnp.asarray(M))
            ev = np.linalg.eigvals(M)
            assert np.all(np.real(ev) >= c - a - 1e-9)
            assert np.all(np.real(ev) <= c + a + 1e-9)
            assert np.all(np.abs(np.imag(ev)) <= b + 1e-9)

    def test_encloses_eigenvalues_banded(self, rng):
        op = eu.advection_diffusion_1d(200, peclet=50.0)
        c, a, b = fov_ellipse(op)
        ev = np.linalg.eigvals(_dense(op))
        assert np.all(np.real(ev) >= c - a - 1e-6)
        assert np.all(np.real(ev) <= c + a + 1e-6)
        assert np.all(np.abs(np.imag(ev)) <= b + 1e-6)

    def test_hermitian_has_zero_beta(self):
        c, a, b = fov_ellipse(eu.laplacian_1d(100))
        assert b == 0.0
        assert a > 0


class TestExpvFaber:
    def test_advection_diffusion_vs_scipy(self, rng):
        op = eu.advection_diffusion_1d(200, peclet=10.0)
        Ad = _dense(op)
        b = rng.standard_normal(200)
        for t in (1e-4, 1e-3):
            w = np.asarray(expv_faber(t, op, b, tol=1e-12))
            ref = sla.expm(t * Ad) @ b
            assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-10

    def test_hermitian_interval_case(self, rng):
        # β = 0 → ρ = 1: the ellipse basis degenerates to Chebyshev
        op = eu.laplacian_1d(300)
        b = rng.standard_normal(300)
        w = np.asarray(expv_faber(0.3, op, b, tol=1e-12))
        ref = sla.expm(0.3 * _dense(op)) @ b
        assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-11

    def test_fat_ellipse_advection_dominated(self, rng):
        # β/α ≈ 0.8 — far outside the Leja real-interval domain
        op = eu.advection_diffusion_1d(300, peclet=3000.0)
        c, a, bet = fov_ellipse(op)
        assert bet / a > 0.5
        b = rng.standard_normal(300)
        t = 200.0 / (0.5 * (a + bet))
        w = np.asarray(expv_faber(t, op, b, tol=1e-10))
        ref = sla.expm(t * _dense(op)) @ b
        assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-9

    def test_skew_dominant_disk_case(self, rng):
        # β > α → enclosed by the disk, ρ = 0 (Taylor basis)
        n = 60
        S = rng.standard_normal((n, n))
        M = (S - S.T) / 2 - 0.05 * np.eye(n)
        b = rng.standard_normal(n)
        w = np.asarray(expv_faber(0.8, jnp.asarray(M), b, tol=1e-12))
        ref = sla.expm(0.8 * M) @ b
        assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-10

    def test_single_substep_z_500(self, rng):
        # THE capability: one substep at z ≥ 500 (Newton basis caps ~150)
        n = 800
        op = eu.advection_diffusion_1d(n, peclet=10.0)
        c, a, bet = fov_ellipse(op)
        gamma = 0.5 * (a + bet)
        b = rng.standard_normal(n)
        diags = np.asarray(op.diags)
        rows, cols, vals = [], [], []
        for k, o in enumerate(op.offsets):
            i = np.arange(max(0, -o), min(n, n - o))
            rows.append(i); cols.append(i + o); vals.append(diags[k][i])
        A_sp = sp.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))
        t = 500.0 / gamma
        w = np.asarray(expv_faber(t, op, b, tol=1e-10, max_z=512.0))
        ref = spla.expm_multiply(t * A_sp, b)
        rel = np.linalg.norm(w - ref) / np.linalg.norm(ref)
        assert rel < 1e-8, rel

    def test_negative_t(self, rng):
        op = eu.advection_diffusion_1d(150, peclet=5.0)
        b = rng.standard_normal(150)
        t = -2e-5
        w = np.asarray(expv_faber(t, op, b, tol=1e-12))
        ref = sla.expm(t * _dense(op)) @ b
        assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-10

    def test_substepping_matches_single(self, rng):
        op = eu.advection_diffusion_1d(150, peclet=10.0)
        c, a, bet = fov_ellipse(op)
        gamma = 0.5 * (a + bet)
        b = rng.standard_normal(150)
        t = 100.0 / gamma
        w1 = np.asarray(expv_faber(t, op, b, tol=1e-12, max_z=128.0))
        w2 = np.asarray(expv_faber(t, op, b, tol=1e-12, max_z=30.0))
        ref = sla.expm(t * _dense(op)) @ b
        for w in (w1, w2):
            assert np.linalg.norm(w - ref) / np.linalg.norm(ref) < 1e-10


class TestPhivFaber:
    def test_orders_vs_augmented_oracle(self, rng):
        n, k = 200, 3
        op = eu.advection_diffusion_1d(n, peclet=10.0)
        Ad = _dense(op)
        b = rng.standard_normal(n)
        t = 1e-3
        W = np.asarray(phiv_faber(t, op, b, k, tol=1e-12))
        refs = [sla.expm(t * Ad) @ b]
        for j in range(1, k + 1):
            Au = np.zeros((n + j, n + j))
            Au[:n, :n] = t * Ad
            Au[:n, n] = b
            for i in range(j - 1):
                Au[n + i, n + i + 1] = 1.0
            refs.append(sla.expm(Au)[:n, n + j - 1])
        for j in range(k + 1):
            rel = (np.linalg.norm(W[:, j] - refs[j])
                   / np.linalg.norm(refs[j]))
            assert rel < 1e-10, (j, rel)

    def test_stiff_raise_points_to_driver(self, rng):
        op = eu.advection_diffusion_1d(100, peclet=10.0)
        b = rng.standard_normal(100)
        with pytest.raises(ValueError, match="phiv_timestep_faber"):
            phiv_faber(1.0, op, b, 2, max_z=10.0)


class TestTimestepFaber:
    def _setup(self, rng, n=300, peclet=3000.0):
        op = eu.advection_diffusion_1d(n, peclet=peclet)
        Ad = _dense(op)
        B = rng.standard_normal((n, 3))
        c, a, bet = fov_ellipse(op)
        return op, Ad, B, 0.5 * (a + bet)

    def test_tol_tracking_vs_dense_oracle(self, rng):
        op, Ad, B, gamma = self._setup(rng)
        t = 200.0 / gamma
        ref = _phi_oracle(t, Ad, B)
        for tol, want in [(1e-7, 1e-5), (1e-11, 1e-9)]:
            U = np.asarray(phiv_timestep_faber([t], op, B, tol=tol)).ravel()
            rel = np.linalg.norm(U - ref) / np.linalg.norm(ref)
            assert rel < want, (tol, rel)

    def test_snapshots_zero_and_negative(self, rng):
        op, Ad, B, gamma = self._setup(rng, peclet=10.0)
        t = 100.0 / gamma
        ts = [-0.5 * t, 0.0, 0.7 * t, t]
        U = np.asarray(phiv_timestep_faber(ts, op, B, tol=1e-10))
        for i, tt in enumerate(ts):
            ref = B[:, 0] if tt == 0.0 else _phi_oracle(tt, Ad, B)
            rel = (np.linalg.norm(U[:, i] - np.asarray(ref))
                   / max(np.linalg.norm(np.asarray(ref)), 1e-300))
            assert rel < 1e-8, (tt, rel)

    def test_caller_order_restored(self, rng):
        op, Ad, B, gamma = self._setup(rng, peclet=10.0)
        t = 50.0 / gamma
        U_f = np.asarray(phiv_timestep_faber([t, 0.5 * t], op, B, tol=1e-10))
        U_b = np.asarray(phiv_timestep_faber([0.5 * t, t], op, B, tol=1e-10))
        np.testing.assert_allclose(U_f[:, 0], U_b[:, 1], rtol=1e-12)
        np.testing.assert_allclose(U_f[:, 1], U_b[:, 0], rtol=1e-12)

    def test_scalar_ts(self, rng):
        op, Ad, B, gamma = self._setup(rng, peclet=10.0)
        t = 50.0 / gamma
        u = np.asarray(phiv_timestep_faber(t, op, B, tol=1e-10))
        assert u.ndim == 1
        ref = _phi_oracle(t, Ad, B)
        assert np.linalg.norm(u - ref) / np.linalg.norm(ref) < 1e-8


class TestFailureProtocol:
    def test_bad_ellipse_raises(self, rng):
        op = eu.advection_diffusion_1d(300, peclet=3000.0)
        c, a, bet = fov_ellipse(op)
        b = rng.standard_normal(300)
        t = 200.0 / (0.5 * (a + bet))
        with pytest.raises((FloatingPointError, ValueError)):
            expv_faber(t, op, b, ellipse=(c, a / 50, bet / 50), tol=1e-8)

    def test_growth_overflow_raises(self, rng):
        # growth spectrum pushed past e^709 on the boundary
        op = eu.laplacian_1d(50)
        b = rng.standard_normal(50)
        with pytest.raises(FloatingPointError, match="overflow"):
            expv_faber(-400.0, op, b, ellipse=(-2.0, 2.0, 0.0),
                       tol=1e-8, max_z=2000.0)

    def test_nonconvergence_raises_without_override(self, rng):
        # skew spectrum: |exp| = 1 on the ellipse boundary, so the degree
        # needed grows linearly in z — z = 5000 exceeds the probe cap
        n = 40
        S = rng.standard_normal((n, n))
        M = (S - S.T) / 2
        b = rng.standard_normal(n)
        c, a, bet = fov_ellipse(jnp.asarray(M))
        t = 5000.0 / (0.5 * (a + bet))
        with pytest.raises((ValueError, FloatingPointError)):
            expv_faber(t, jnp.asarray(M), b, tol=1e-10, max_z=1e9)

    def test_fixed_degree_override(self, rng):
        op = eu.advection_diffusion_1d(100, peclet=10.0)
        b = rng.standard_normal(100)
        w = expv_faber(1e-4, op, b, tol=1e-10, m=64)
        ref = sla.expm(1e-4 * _dense(op)) @ b
        assert (np.linalg.norm(np.asarray(w) - ref)
                / np.linalg.norm(ref)) < 1e-6


class TestStencil3D:
    """Faber/Leja on the asymmetric 3-D stencil container, checked
    against the dense oracle."""

    def _setup(self, rng):
        op = eu.advection_diffusion_3d_stencil(6, 6, 6, peclet=5.0)
        I = np.eye(216)
        Ad = np.stack([np.asarray(op.matvec(jnp.asarray(I[:, j])))
                       for j in range(216)], axis=1)
        return op, Ad, rng.standard_normal(216)

    def test_fov_encloses_eigenvalues(self, rng):
        op, Ad, _ = self._setup(rng)
        c, a, bet = fov_ellipse(op)
        ev = np.linalg.eigvals(Ad)
        assert np.all(np.real(ev) >= c - a - 1e-6)
        assert np.all(np.real(ev) <= c + a + 1e-6)
        assert np.all(np.abs(np.imag(ev)) <= bet + 1e-6)

    def test_expv_faber_and_leja(self, rng):
        op, Ad, b = self._setup(rng)
        t = 1e-4
        ref = sla.expm(t * Ad) @ b
        for w in (expv_faber(t, op, b, tol=1e-10),
                  eu.expv_leja(t, op, b, tol=1e-10)):
            assert (np.linalg.norm(np.asarray(w) - ref)
                    / np.linalg.norm(ref)) < 1e-9

    def test_driver_on_stencil(self, rng):
        op, Ad, _ = self._setup(rng)
        B = rng.standard_normal((216, 3))
        t = 2e-4
        U = np.asarray(phiv_timestep_faber(t, op, B, tol=1e-10))
        ref = _phi_oracle(t, Ad, B)
        assert np.linalg.norm(U - ref) / np.linalg.norm(ref) < 1e-8
