"""Row-partitioned stencil actions on the 8-virtual-device CPU mesh.

Each sharded action (``shard_map`` with ``ppermute`` halos, one ``psum``
per Lanczos step) is compared with the same action on one device and
with ``scipy.sparse.linalg.expm_multiply`` on the assembled matrix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.sparse.linalg import expm_multiply

import exponentialutilities_jl_tpu as eu
from exponentialutilities_jl_tpu.ops.stencil import StencilOperator
from exponentialutilities_jl_tpu.parallel import (
    expv_chebyshev_sharded, expv_faber_sharded, expv_leja_sharded,
    expv_sharded, make_mesh, shard_vector)

from test_stencil_recurrences import _const_stencil, _rel, sparse_of


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def _lap(*shape):
    return eu.laplacian_nd_stencil(*shape, dtype=jnp.float32)


OPERATORS = {
    "lap7_16x6x10": lambda: _lap(16, 6, 10),
    "star13_16x6x10": lambda: _const_stencil(
        (16, 6, 10), 2, False, np.float32, np.random.default_rng(1)),
    "lap5_16x40": lambda: _lap(16, 40),
    "box9_16x24": lambda: _const_stencil(
        (16, 24), 1, True, np.float32, np.random.default_rng(2)),
    "advdiff7_16x6x10": lambda: eu.advection_diffusion_3d_stencil(
        16, 6, 10, peclet=1.5, dtype=jnp.float32),
}

CASES = [
    ("chebyshev", "lap7_16x6x10"), ("chebyshev", "star13_16x6x10"),
    ("chebyshev", "lap5_16x40"), ("chebyshev", "box9_16x24"),
    ("two_pass", "lap7_16x6x10"), ("two_pass", "lap5_16x40"),
    ("basis", "lap7_16x6x10"),
    ("leja", "advdiff7_16x6x10"), ("faber", "advdiff7_16x6x10"),
]


def _run(method, t, op, b, mesh=None):
    if method == "chebyshev":
        return (expv_chebyshev_sharded(t, op, b, mesh, tol=1e-6) if mesh
                else eu.expv_chebyshev(t, op, b, tol=1e-6))
    if method in ("two_pass", "basis"):
        tp = method == "two_pass"
        return (expv_sharded(t, op, b, mesh, m=30, two_pass=tp) if mesh
                else eu.expv(t, op, b, m=30, two_pass=tp))
    if method == "leja":
        return (expv_leja_sharded(t, op, b, mesh, tol=1e-6) if mesh
                else eu.expv_leja(t, op, b, tol=1e-6))
    return (expv_faber_sharded(t, op, b, mesh, tol=1e-6) if mesh
            else eu.expv_faber(t, op, b, tol=1e-6))


@pytest.mark.parametrize("method,name", CASES)
def test_sharded_matches_one_device_and_oracle(mesh, method, name):
    op = OPERATORS[name]()
    A = sparse_of(op)
    t = 2.0 / abs(float(np.max(np.abs(A).sum(axis=1))))
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(op.shape[0]), jnp.float32)
    w_sh = _run(method, t, op, b, mesh)
    assert len(w_sh.sharding.device_set) == 8
    w_1 = np.asarray(_run(method, t, op, b), np.float64)
    assert _rel(w_sh, w_1) < 5e-6
    ref = expm_multiply(t * A, np.asarray(b, np.float64))
    assert _rel(w_sh, ref) < 1e-5


def test_halo_deeper_than_shard_raises(mesh, rng):
    # |dz| = 2 halo planes > 1 plane per shard on 8 shards
    offs = [(0, 0, 0), (2, 0, 0), (-2, 0, 0), (0, 1, 0), (0, -1, 0)]
    op = StencilOperator((8, 6, 10), tuple(offs),
                         jnp.asarray([-2.0, 0.5, 0.5, 0.5, 0.5],
                                     jnp.float32), is_hermitian=True)
    b = jnp.asarray(rng.standard_normal(480), jnp.float32)
    with pytest.raises(ValueError, match="halo"):
        expv_chebyshev_sharded(0.05, op, b, mesh)


def test_chebyshev_census_permute_only(mesh):
    # the sharded Chebyshev recurrence communicates only through halo
    # collective-permutes: no all-reduce in the compiled program
    from exponentialutilities_jl_tpu.models.chebyshev import (
        _chebyshev_apply_scan)
    from exponentialutilities_jl_tpu.parallel.krylov import _sharded_call
    op = _lap(16, 6, 10)
    coeffs = jnp.linspace(1.0, 0.1, 9).astype(jnp.float32)
    run, params = _sharded_call(
        op, mesh, "shard",
        lambda lop, b: _chebyshev_apply_scan(lop, b, coeffs, -6.0, 1 / 6))
    b = shard_vector(jnp.ones(960, jnp.float32), mesh)
    hlo = run.lower(params, b).compile().as_text()
    assert "all-reduce" not in hlo
    assert "collective-permute" in hlo


def test_zero_vector_returns_zero(mesh):
    op = _lap(16, 6, 10)
    w = expv_sharded(0.1, op, jnp.zeros(960, jnp.float32), mesh, m=10,
                     two_pass=True)
    assert np.all(np.asarray(w) == 0)


def test_complex_t_two_pass(mesh, rng):
    op = _lap(16, 6, 10)
    b = jnp.asarray(rng.standard_normal(960), jnp.float32)
    w = expv_sharded(0.1j, op, b, mesh, m=30, two_pass=True)
    assert jnp.iscomplexobj(w)
    want = expm_multiply(0.1j * sparse_of(op), np.asarray(b, np.float64))
    assert (np.linalg.norm(np.asarray(w) - want)
            / np.linalg.norm(want)) < 1e-4


def test_variable_stencil_points_to_gspmd(mesh, rng):
    a = rng.uniform(0.5, 2.0, (16, 6, 10)).astype(np.float32)
    op = eu.variable_diffusion_nd_stencil(a)
    with pytest.raises(TypeError, match="GSPMD"):
        expv_chebyshev_sharded(0.05, op, jnp.ones(960, jnp.float32), mesh)


def test_variable_stencil_gspmd_route(mesh, rng):
    # GSPMD: shard the vector and call the single-device action
    a = rng.uniform(0.5, 2.0, (16, 6, 10)).astype(np.float32)
    op = eu.variable_diffusion_nd_stencil(a)
    b = jnp.asarray(rng.standard_normal(960), jnp.float32)
    w_sh = eu.expv_chebyshev(0.05, op, shard_vector(b, mesh), tol=1e-6)
    w_1 = eu.expv_chebyshev(0.05, op, b, tol=1e-6)
    assert _rel(w_sh, np.asarray(w_1, np.float64)) < 5e-6
    ref = expm_multiply(0.05 * sparse_of(op), np.asarray(b, np.float64))
    assert _rel(w_sh, ref) < 1e-5
