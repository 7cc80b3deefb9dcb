"""Dense φ tests — recurrence oracle, block-matrix oracle, adversarial
matrices, NaN no-throw protocol (reference: test/basictests.jl:305-466)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

import exponentialutilities_jl_tpu as eu


def phi_recurrence_oracle(z, k):
    # φ_0 = e^z, φ_{j+1} = (φ_j - φ_j(0))/z  (reference oracle,
    # test/basictests.jl:305-333)
    out = [np.exp(z)]
    for j in range(k):
        out.append((out[-1] - 1.0 / math.factorial(j)) / z)
    return np.array(out)


def phi_block_oracle(A, k):
    # independent block-matrix oracle exp([A E; 0 J]) (Al-Mohy–Liu Thm 2.1;
    # reference: test/basictests.jl:335-399)
    n = A.shape[0]
    E = np.zeros((n, k * n))
    E[:, :n] = np.eye(n)
    J = np.kron(np.diag(np.ones(k - 1), 1), np.eye(n)) if k > 1 else np.zeros((n, n))
    Big = np.block([[A, E], [np.zeros((k * n, n)), J]])
    P = sla.expm(Big)
    return [sla.expm(A)] + [P[:n, j * n:(j + 1) * n] for j in range(1, k + 1)]


def test_phi_scalar_vs_recurrence():
    for z in [0.5, -1.2, 3.0 + 1.0j]:
        got = np.asarray(eu.phi_scalar(z, 5))
        want = phi_recurrence_oracle(z, 5)
        assert np.max(np.abs(got - want)) < 1e-11 * max(1, abs(np.exp(z)))


def test_phi_scalar_batched():
    z = np.linspace(-2, 2, 7)   # includes z = 0
    got = np.asarray(eu.phi_scalar(z, 3))
    assert got.shape == (7, 4)
    for i, zi in enumerate(z):
        if zi == 0.0:
            want = np.array([1.0 / math.factorial(j) for j in range(4)])
        else:
            want = phi_recurrence_oracle(zi, 3)
        assert np.max(np.abs(got[i] - want)) < 1e-12


ADVERSARIAL = {
    "random": lambda rng, n: rng.standard_normal((n, n)),
    "nonnormal": lambda rng, n: np.triu(rng.standard_normal((n, n))) * 3,
    "large_norm": lambda rng, n: rng.standard_normal((n, n)) * 50,
    "hessenberg": lambda rng, n: np.triu(rng.standard_normal((n, n)), -1),
    "zero": lambda rng, n: np.zeros((n, n)),
    "tiny": lambda rng, n: rng.standard_normal((n, n)) * 1e-8,
}


@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
@pytest.mark.parametrize("k", [1, 3])
def test_phi_matrix_adversarial(rng, name, k):
    n = 12
    A = ADVERSARIAL[name](rng, n)
    got = np.asarray(eu.phi(A, k))
    want = phi_block_oracle(A, k)
    scale = max(np.max(np.abs(want[0])), 1.0)
    for j in range(k + 1):
        assert np.max(np.abs(got[j] - want[j])) / scale < 1e-8, (name, j)


def test_phi_complex(rng):
    n, k = 10, 2
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    got = np.asarray(eu.phi(A, k))
    want = phi_block_oracle(A, k)
    scale = max(np.max(np.abs(want[0])), 1.0)
    for j in range(k + 1):
        assert np.max(np.abs(got[j] - want[j])) / scale < 1e-9


def test_phi_high_order(rng):
    # reference: p up to 30 (test/basictests.jl:399)
    n, k = 6, 30
    A = rng.standard_normal((n, n))
    got = np.asarray(eu.phi(A, k))
    want = phi_block_oracle(A, k)
    for j in [0, 1, 10, 30]:
        denom = max(np.max(np.abs(want[j])), 1e-30)
        assert np.max(np.abs(got[j] - want[j])) / denom < 1e-6, j


def test_phi_coefficient_overflow_guard():
    # reference: coefficient stress p<=500 (test/basictests.jl:440s) — must
    # not raise, coefficients for giant orders underflow to zero gracefully.
    A = np.diag([0.1, 0.2])
    out = np.asarray(eu.phi(A, 200))
    assert out.shape == (201, 2, 2)
    assert np.all(np.isfinite(out[:50]))


@pytest.mark.parametrize("solve", ["device", "newton"])
@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
@pytest.mark.parametrize("k", [1, 3])
def test_phi_pade_adversarial_tight(rng, name, k, solve):
    # The Padé path with cost-model (m, s, τ) selection must hit f64-grade
    # accuracy (rtol 1e-12) across the adversarial set — tighter than the
    # 1e-8 shared bound above (VERDICT round-1 done-criterion; reference
    # algorithm: src/phi_almohy.jl:327-368). Both denominator engines:
    # the device LU and the solver-free Newton–Schulz inverse must pass
    # identically.
    n = 12
    A = ADVERSARIAL[name](rng, n)
    got = np.asarray(eu.phi_pade(A, k, solve=solve))
    want = phi_block_oracle(A, k)
    for j in range(k + 1):
        scale = max(np.max(np.abs(want[j])), 1e-30)
        assert np.max(np.abs(got[j] - want[j])) / scale < 1e-12, (name, j)


def test_phi_pade_norm_1e3(rng):
    # ‖A‖₁ = 1e3, skew-symmetric (normal, imaginary spectrum): exact
    # spectral oracle; forward error bounded by u·κ ≈ 1e-13.
    n, k = 12, 3
    S = rng.standard_normal((n, n))
    S = S - S.T
    A = S / np.max(np.sum(np.abs(S), 0)) * 1e3
    lam, V = np.linalg.eig(A)
    Vi = np.linalg.inv(V)
    got = np.asarray(eu.phi_pade(A, k))
    for j in range(k + 1):
        pj = np.array([phi_recurrence_oracle(z, k)[j] for z in lam])
        want = (V * pj) @ Vi
        scale = max(np.max(np.abs(want)), 1e-30)
        assert np.max(np.abs(got[j] - want)) / scale < 1e-12, j


def test_phi_pade_norm_1e6_quasinilpotent(rng):
    # ‖A‖₁ = 1e6 but nilpotent: the η/α 1-norm-of-powers probes (the whole
    # point of the Al-Mohy–Liu selection, src/phi_almohy.jl:345-368) must
    # see the small effective norm — both cheap (few squarings) and
    # essentially exact, where a plain ‖A‖-driven scaling would grind
    # through ~17 stages. Oracle: φ_j(A) = Σ_{i<n} A^i/(i+j)! exactly.
    n, k = 12, 3
    N = np.triu(rng.standard_normal((n, n)), 1)
    A = N / np.max(np.sum(np.abs(N), 0)) * 1e6
    pows = [np.eye(n)]
    for _ in range(1, n):
        pows.append(pows[-1] @ A)
    got = np.asarray(eu.phi_pade(A, k))
    for j in range(k + 1):
        want = sum(pows[i] / math.factorial(i + j) for i in range(n))
        assert np.max(np.abs(got[j] - want)) / np.max(np.abs(want)) < 1e-12, j


def test_phi_pade_norm_1e6_conditioning_bound(rng):
    # ‖A‖₁ = 1e6 skew: κ_exp ≈ ‖A‖₁, so u·κ ≈ 1e-10 is forward-optimal for
    # ANY backward-stable method — assert we achieve that class.
    n, k = 12, 2
    S = rng.standard_normal((n, n))
    S = S - S.T
    A = S / np.max(np.sum(np.abs(S), 0)) * 1e6
    lam, V = np.linalg.eig(A)
    Vi = np.linalg.inv(V)
    got = np.asarray(eu.phi_pade(A, k))
    for j in range(k + 1):
        pj = np.array([phi_recurrence_oracle(z, k)[j] for z in lam])
        want = (V * pj) @ Vi
        scale = max(np.max(np.abs(want)), 1e-30)
        assert np.max(np.abs(got[j] - want)) / scale < 5e-9, j


def test_phi_pade_matches_taylor(rng):
    n, k = 10, 3
    A = rng.standard_normal((n, n))
    a = np.asarray(eu.phi_pade(A, k))
    b = np.asarray(eu.phi_taylor(A, k))
    assert np.max(np.abs(a - b)) < 1e-11


def test_phi_pade_newton_large_norms(rng):
    # the solver-free Newton–Schulz engine must survive the large-norm
    # stress cases too (its D_m conditioning argument relies on the cost
    # model's degree cap — exercise it where s is large)
    n, k = 12, 2
    S = rng.standard_normal((n, n))
    S = S - S.T
    A = S / np.max(np.sum(np.abs(S), 0)) * 1e3
    lam, V = np.linalg.eig(A)
    Vi = np.linalg.inv(V)
    got = np.asarray(eu.phi_pade(A, k, solve="newton"))
    for j in range(k + 1):
        pj = np.array([phi_recurrence_oracle(z, k)[j] for z in lam])
        want = (V * pj) @ Vi
        scale = max(np.max(np.abs(want)), 1e-30)
        assert np.max(np.abs(got[j] - want)) / scale < 1e-12, j


def test_phi_pade_newton_nan_no_throw(rng):
    # the Newton–Schulz while_loop must EXIT on non-finite input (its
    # cond carries an isfinite guard) and propagate NaN per the protocol
    A = np.full((6, 6), np.nan)
    out = np.asarray(eu.phi_pade(A, 2, solve="newton"))
    assert not np.all(np.isfinite(out))


def test_phi_pade_newton_complex(rng):
    n, k = 10, 2
    A = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))) / 3
    got = np.asarray(eu.phi_pade(A, k, solve="newton"))
    want = phi_block_oracle(A, k)
    for j in range(k + 1):
        scale = max(np.max(np.abs(want[j])), 1e-30)
        assert np.max(np.abs(got[j] - want[j])) / scale < 1e-12, j


def test_host_phi_matches_oracle(rng):
    from exponentialutilities_jl_tpu.ops.host_reduced import host_phi
    n, k = 14, 3
    A = rng.standard_normal((n, n)) / 2
    got = np.asarray(host_phi(A, k))
    want = phi_block_oracle(A, k)
    for j in range(k + 1):
        scale = max(np.max(np.abs(want[j])), 1e-30)
        assert np.max(np.abs(got[j] - want[j])) / scale < 1e-13, j
    e = np.asarray(host_phi(A, 0))
    assert np.max(np.abs(e[0] - sla.expm(A))) < 1e-13


def test_phi_method_dispatch(rng):
    # auto → pade for f64 k≥1; explicit methods agree; bad method raises.
    A = rng.standard_normal((8, 8)) / 4
    auto = np.asarray(eu.phi(A, 2))
    pade = np.asarray(eu.phi(A, 2, method="pade"))
    assert np.array_equal(auto, pade)
    with pytest.raises(ValueError):
        eu.phi(A, 2, method="nope")
    with pytest.raises(ValueError):
        eu.phi_pade(A, 0)


def test_phi_nan_no_throw_protocol():
    # reference: NaN-input → NaN-output + info≠0, no exception
    # (test/basictests.jl:444-456, src/phi_almohy.jl:110-142)
    A = np.full((4, 4), np.nan)
    out, info = eu.phi_with_info(A, 2)
    assert int(info) != 0
    assert not np.all(np.isfinite(np.asarray(out)))
    ok, info_ok = eu.phi_with_info(np.eye(4) * 0.3, 2)
    assert int(info_ok) == 0


def test_phi_diagonal_entrywise(rng):
    # reference: Diagonal specialization applies scalar phi per entry
    # (src/phi.jl:235-246)
    d = rng.standard_normal(8)
    got = np.asarray(eu.phi_scalar(d, 3))          # (8, 4)
    want = phi_block_oracle(np.diag(d), 3)
    for j in range(4):
        assert np.max(np.abs(np.diag(got[:, j]) - want[j])) < 1e-11


def test_phiv_dense_vs_oracle(rng):
    n, k = 15, 4
    A = rng.standard_normal((n, n))
    v = rng.standard_normal(n)
    got = np.asarray(eu.phiv_dense(A, v, k))
    want = phi_block_oracle(A, k)
    for j in range(k + 1):
        w = want[j] @ v
        assert np.linalg.norm(got[:, j] - w) / np.linalg.norm(w) < 1e-10


def test_phiv_dense_k0(rng):
    n = 10
    A = rng.standard_normal((n, n))
    v = rng.standard_normal(n)
    got = np.asarray(eu.phiv_dense(A, v, 0))
    assert got.shape == (n, 1)
    assert np.linalg.norm(got[:, 0] - sla.expm(A) @ v) < 1e-10


class TestBatchedPhi:
    """phi_taylor_batched: batch-uniform scaling (VERDICT r4 #4)."""

    def test_mixed_norm_batch_vs_per_element(self, rng):
        mats = []
        for scale in (1e-3, 0.5, 8.0, 40.0):
            A = rng.standard_normal((16, 16))
            mats.append(A * (scale / np.linalg.norm(A, 1)))
        A = jnp.asarray(np.stack(mats))
        P = eu.phi(A, 3)                 # stacked → batched route
        assert P.shape == (4, 4, 16, 16)
        for i in range(4):
            Pi = np.asarray(eu.phi(jnp.asarray(mats[i]), 3,
                                   method="taylor"))
            np.testing.assert_allclose(np.asarray(P[i]), Pi,
                                       atol=1e-11, rtol=1e-9)

    def test_batched_f32(self, rng):
        A = rng.standard_normal((3, 24, 24)).astype(np.float32)
        A *= 4.0 / np.linalg.norm(A, 1, axis=(1, 2))[:, None, None]
        P = eu.phi_taylor_batched(jnp.asarray(A), 2)
        assert P.dtype == jnp.float32
        for i in range(3):
            Pi = np.asarray(eu.phi(jnp.asarray(A[i].astype(np.float64)),
                                   2, method="taylor"))
            np.testing.assert_allclose(np.asarray(P[i]), Pi,
                                       atol=5e-6, rtol=1e-4)

    def test_matches_block_oracle(self, rng):
        # the (k+1)-block augmented-exponential oracle per element
        import scipy.linalg as sla
        n, kk = 12, 2
        A = rng.standard_normal((2, n, n)) / 3
        P = np.asarray(eu.phi(jnp.asarray(A), kk))
        for i in range(2):
            aug = np.zeros((n + kk, n + kk))
            aug[:n, :n] = A[i]
            aug[:n, n] = 0.0
            # phi_j(A) columns via exp of the Jordan-augmented matrix:
            # use scalar identity phi_j = series on eigen-free route —
            # simpler: compare phi_0 with expm and the recurrence
            # phi_{j}(A) = A phi_{j+1}(A) + I/j!
            E = sla.expm(A[i])
            np.testing.assert_allclose(P[i, 0], E, atol=1e-12, rtol=1e-9)
            for j in range(kk):
                lhs = P[i, j]
                rhs = A[i] @ P[i, j + 1] + np.eye(n) / math.factorial(j)
                np.testing.assert_allclose(lhs, rhs, atol=1e-11,
                                           rtol=1e-8)


def test_batched_phi_differentiable_grad(rng):
    # review r5: differentiable=True must survive the stacked route
    import jax
    A = jnp.asarray(rng.standard_normal((2, 6, 6)) / 3)

    def loss(A):
        return jnp.sum(eu.phi(A, 2, differentiable=True))

    g = jax.grad(loss)(A)
    eps = 1e-6
    d = rng.standard_normal(A.shape)
    fd = (loss(A + eps * d) - loss(A - eps * d)) / (2 * eps)
    assert abs(float(jnp.vdot(g, d)) - float(fd)) < 1e-5
