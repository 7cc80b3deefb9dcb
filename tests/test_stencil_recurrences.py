"""Stencil operators through the XLA recurrences, against sparse oracles.

One catalog of constant- and variable-coefficient stencils (1-D to 3-D,
nearest-neighbour to |offset| = 3 stars and 125-point boxes, symmetric
and advective) is driven through the matvec, the two-pass Lanczos
``expv``, the Chebyshev action and the Leja/Faber actions. The oracle is
an independent scipy CSR matrix assembled from the operator's diagonal
storage (``to_banded``) and ``scipy.sparse.linalg.expm_multiply``.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.linalg import expm_multiply

import exponentialutilities_jl_tpu as eu
from exponentialutilities_jl_tpu.ops.stencil import (
    StencilOperator, VariableStencilOperator, advection_diffusion_3d_stencil,
    advection_diffusion_1d_stencil, laplacian_nd_stencil,
    variable_diffusion_nd_stencil)


def sparse_of(op):
    """CSR matrix of a stencil/banded operator from its diagonal storage."""
    bo = op.to_banded() if hasattr(op, "to_banded") else op
    D = np.asarray(bo.diags, np.float64)
    n = D.shape[1]
    i = np.arange(n)
    rows, cols, vals = [], [], []
    for k, o in enumerate(bo.offsets):
        j = i + o
        ok = (j >= 0) & (j < n) & (D[k] != 0)
        rows.append(i[ok])
        cols.append(j[ok])
        vals.append(D[k][ok])
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


def _symmetric_offsets(d, reach, box):
    """Offsets of a symmetric star (axis-aligned) or box stencil."""
    if box:
        return [o for o in itertools.product(range(-reach, reach + 1),
                                             repeat=d)]
    offs = [tuple([0] * d)]
    for a in range(d):
        for r in range(1, reach + 1):
            for s in (-r, r):
                o = [0] * d
                o[a] = s
                offs.append(tuple(o))
    return offs


def _const_stencil(shape, reach, box, dtype, rng, hermitian=True):
    """Diagonally dominant constant stencil: symmetric pairs share one
    coefficient; the advective variant perturbs each +/- pair apart."""
    offs = _symmetric_offsets(len(shape), reach, box)
    coeffs = {}
    for o in offs:
        if any(o):
            key = max(o, tuple(-x for x in o))
            coeffs.setdefault(key, rng.uniform(0.2, 1.0))
    c = []
    for o in offs:
        if not any(o):
            c.append(0.0)
            continue
        v = coeffs[max(o, tuple(-x for x in o))]
        if not hermitian:
            v = v * (1.5 if o > tuple(-x for x in o) else 0.5)
        c.append(v)
    c = np.asarray(c)
    c[offs.index(tuple([0] * len(shape)))] = -1.05 * np.abs(c).sum()
    return StencilOperator(shape, offs, jnp.asarray(c, dtype),
                           is_hermitian=hermitian)


def _variable_2d_9pt(shape, dtype, rng):
    """Symmetric variable-coefficient 9-point stencil: each undirected
    edge gets one random weight, read from both of its cells."""
    offs = _symmetric_offsets(2, 1, True)
    ny, nx = shape
    fields = np.zeros((len(offs), ny * nx))
    idx = np.arange(ny * nx).reshape(shape)
    for k, o in enumerate(offs):
        if o <= (0, 0):
            continue
        w = rng.uniform(0.2, 1.0, shape)
        kk = offs.index((-o[0], -o[1]))
        for y in range(ny):
            for x in range(nx):
                y2, x2 = y + o[0], x + o[1]
                if 0 <= y2 < ny and 0 <= x2 < nx:
                    fields[k, idx[y, x]] = w[y, x]
                    fields[kk, idx[y2, x2]] = w[y, x]
    fields[offs.index((0, 0))] = -1.05 * np.abs(fields).sum(axis=0) - 0.1
    return VariableStencilOperator(shape, offs, jnp.asarray(fields, dtype),
                                   is_hermitian=True)


def _variable_diffusion(shape, dtype, rng):
    a = rng.uniform(0.5, 2.0, shape)
    return variable_diffusion_nd_stencil(a.astype(dtype))


# name -> builder(dtype, rng). Shapes cover thin axes (4), long fast axes
# (130-260), non-power-of-two sizes and grids with a single plane.
HERMITIAN = {
    "lap7_6x5x7": lambda dt, r: laplacian_nd_stencil(6, 5, 7, dtype=dt),
    "lap7_4x4x130": lambda dt, r: laplacian_nd_stencil(4, 4, 130, dtype=dt),
    "lap7_6x6x6": lambda dt, r: laplacian_nd_stencil(6, 6, 6, dtype=dt),
    "lap7_pancake_2x40x40": lambda dt, r: laplacian_nd_stencil(2, 40, 40,
                                                               dtype=dt),
    "lap7_3x64x50": lambda dt, r: laplacian_nd_stencil(3, 64, 50, dtype=dt),
    "lap5_37x150": lambda dt, r: laplacian_nd_stencil(37, 150, dtype=dt),
    "lap5_16x40": lambda dt, r: laplacian_nd_stencil(16, 40, dtype=dt),
    "lap5_9x260": lambda dt, r: laplacian_nd_stencil(9, 260, dtype=dt),
    "lap5_64x130": lambda dt, r: laplacian_nd_stencil(64, 130, dtype=dt),
    "lap3_1000": lambda dt, r: laplacian_nd_stencil(1000, dtype=dt),
    "lap3_1001": lambda dt, r: laplacian_nd_stencil(1001, dtype=dt),
    "star_1d_reach3_700": lambda dt, r: _const_stencil((700,), 3, False,
                                                       dt, r),
    "star_1d_reach130_600": lambda dt, r: StencilOperator(
        (600,), [(0,), (-130,), (130,), (-1,), (1,)],
        jnp.asarray([-4.2, 1.0, 1.0, 1.0, 1.0], dt), is_hermitian=True),
    "box27_6x6x6": lambda dt, r: _const_stencil((6, 6, 6), 1, True, dt, r),
    "box9_20x24": lambda dt, r: _const_stencil((20, 24), 1, True, dt, r),
    "star13_6x7x8": lambda dt, r: _const_stencil((6, 7, 8), 2, False, dt, r),
    "box125_7x7x7": lambda dt, r: _const_stencil((7, 7, 7), 2, True, dt, r),
    "box25_20x20": lambda dt, r: _const_stencil((20, 20), 2, True, dt, r),
    "star19_8x8x8": lambda dt, r: _const_stencil((8, 8, 8), 3, False, dt, r),
    "star_2d_reach3_20x24": lambda dt, r: _const_stencil((20, 24), 3, False,
                                                         dt, r),
    "var7_5x6x7": lambda dt, r: _variable_diffusion((5, 6, 7), dt, r),
    "var7_4x4x130": lambda dt, r: _variable_diffusion((4, 4, 130), dt, r),
    "var5_12x30": lambda dt, r: _variable_diffusion((12, 30), dt, r),
    "var9_14x17": lambda dt, r: _variable_2d_9pt((14, 17), dt, r),
}

ADVECTIVE = {
    "advdiff7_6x5x7": lambda dt, r: advection_diffusion_3d_stencil(
        6, 5, 7, peclet=10.0, dtype=dt),
    "advdiff7_4x6x9": lambda dt, r: advection_diffusion_3d_stencil(
        4, 6, 9, peclet=4.0, dtype=dt),
    "advdiff3_400": lambda dt, r: advection_diffusion_1d_stencil(
        400, peclet=10.0, dtype=dt),
    "asym27_5x5x5": lambda dt, r: _const_stencil((5, 5, 5), 1, True, dt, r,
                                                 hermitian=False),
    "asym9_16x18": lambda dt, r: _const_stencil((16, 18), 1, True, dt, r,
                                                hermitian=False),
    "asym13_6x6x7": lambda dt, r: _const_stencil((6, 6, 7), 2, False, dt, r,
                                                 hermitian=False),
}

ALL = {**HERMITIAN, **ADVECTIVE}


def _case(name, table, dtype, seed=0):
    rng = np.random.default_rng(seed)
    op = table[name](dtype, rng)
    n = op.shape[0]
    b = rng.standard_normal(n).astype(dtype)
    A = sparse_of(op)
    # time scale with |t|·‖A‖ ≈ 2: a few dozen matvecs of work
    t = 2.0 / abs(sp.linalg.norm(A, 1))
    return op, b, A, t


def _rel(w, ref):
    return (np.linalg.norm(np.asarray(w, np.float64) - ref)
            / np.linalg.norm(ref))


@pytest.mark.parametrize("name", sorted(ALL))
def test_matvec_matches_sparse_oracle(name):
    op, b, A, _ = _case(name, ALL, np.float32)
    y = np.asarray(op.matvec(jnp.asarray(b)), np.float64)
    want = A @ b.astype(np.float64)
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5


@pytest.mark.parametrize("name", sorted(HERMITIAN))
def test_two_pass_expv_f32(name):
    op, b, A, t = _case(name, HERMITIAN, np.float32)
    w = eu.expv(t, op, jnp.asarray(b), m=30, two_pass=True)
    ref = expm_multiply(t * A, b.astype(np.float64))
    assert _rel(w, ref) < 1e-5


@pytest.mark.parametrize("name", sorted(HERMITIAN))
def test_chebyshev_expv_f64(name):
    op, b, A, t = _case(name, HERMITIAN, np.float64)
    w = eu.expv_chebyshev(t, op, jnp.asarray(b), tol=1e-13)
    ref = expm_multiply(t * A, b)
    assert _rel(w, ref) < 1e-10


@pytest.mark.parametrize("method", ["leja", "faber"])
@pytest.mark.parametrize("name", sorted(ADVECTIVE))
def test_polynomial_expv_advective(name, method):
    op, b, A, t = _case(name, ADVECTIVE, np.float64)
    fn = eu.expv_leja if method == "leja" else eu.expv_faber
    w = fn(t, op, jnp.asarray(b), tol=1e-12)
    ref = expm_multiply(t * A, b)
    assert _rel(w, ref) < 1e-8


# ---- 1-D and banded operators: φ stacks, snapshots, breakdown ----------

def _dense_phi_e(tA, k):
    """[φ_0(tA) … φ_k(tA)] from one block-matrix exponential (f64)."""
    import scipy.linalg as sla
    n = tA.shape[0]
    M = np.zeros(((k + 1) * n, (k + 1) * n))
    M[:n, :n] = tA
    for j in range(k):
        M[j * n:(j + 1) * n, (j + 1) * n:(j + 2) * n] = np.eye(n)
    E = sla.expm(M)
    return [E[:n, j * n:(j + 1) * n] for j in range(k + 1)]


def test_phiv_chebyshev_stack_1d():
    b = np.random.default_rng(2).standard_normal(300)
    op = laplacian_nd_stencil(300, dtype=np.float64)
    A = sparse_of(op).toarray()
    W = np.asarray(eu.phiv_chebyshev(0.5, op, jnp.asarray(b), 3, tol=1e-13))
    for j, P in enumerate(_dense_phi_e(0.5 * A, 3)):
        assert _rel(W[:, j], P @ b) < 1e-10


def test_phiv_timestep_chebyshev_snapshots_1d():
    rng = np.random.default_rng(3)
    op = laplacian_nd_stencil(200, dtype=np.float64)
    A = sparse_of(op).toarray()
    B = rng.standard_normal((200, 3))
    ts = [0.2, 0.7, 1.5]
    U = np.asarray(eu.phiv_timestep_chebyshev(ts, op, jnp.asarray(B),
                                              tol=1e-13))
    for s, t in enumerate(ts):
        P = _dense_phi_e(t * A, 2)
        want = sum(t ** j * P[j] @ B[:, j] for j in range(3))
        assert _rel(U[:, s], want) < 1e-10


def test_phiv_two_pass_1d():
    rng = np.random.default_rng(4)
    op = laplacian_nd_stencil(400, dtype=np.float64)
    A = sparse_of(op).toarray()
    b = rng.standard_normal(400)
    W = np.asarray(eu.phiv(0.3, op, jnp.asarray(b), 3, m=40, two_pass=True))
    for j, P in enumerate(_dense_phi_e(0.3 * A, 3)):
        assert _rel(W[:, j], P @ b) < 1e-10


def test_two_pass_eigenvector_breakdown():
    # b an eigenvector: the Lanczos recurrence breaks down after one step
    n = 257
    op = laplacian_nd_stencil(n, dtype=np.float64)
    k = 5
    v = np.sin(np.arange(1, n + 1) * k * np.pi / (n + 1))
    lam = -4 * np.sin(k * np.pi / (2 * (n + 1))) ** 2
    w = eu.expv(0.7, op, jnp.asarray(v), m=30, two_pass=True)
    assert _rel(w, np.exp(0.7 * lam) * v) < 1e-12


def test_two_pass_zero_vector():
    op = laplacian_nd_stencil(64, dtype=np.float32)
    w = eu.expv(0.5, op, jnp.zeros(64, jnp.float32), m=10, two_pass=True)
    assert np.all(np.asarray(w) == 0)


def test_banded_poisson_chebyshev():
    rng = np.random.default_rng(5)
    op = eu.poisson_2d(16, 16, dtype=jnp.float64)
    b = rng.standard_normal(256)
    w = eu.expv_chebyshev(0.3, op, jnp.asarray(b), tol=1e-13)
    ref = expm_multiply(0.3 * sparse_of(op), b)
    assert _rel(w, ref) < 1e-10


def test_banded_and_stencil_chebyshev_agree():
    rng = np.random.default_rng(6)
    st = laplacian_nd_stencil(12, 20, dtype=np.float64)
    b = jnp.asarray(rng.standard_normal(240))
    w_st = eu.expv_chebyshev(0.4, st, b, tol=1e-13)
    w_bd = eu.expv_chebyshev(0.4, st.to_banded(), b, tol=1e-13)
    assert _rel(w_st, np.asarray(w_bd)) < 1e-12
