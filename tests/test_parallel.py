"""Distributed (shard_map) path on the 8-virtual-device CPU mesh.

This is the test pattern SURVEY.md §4 prescribes: the same code that runs on
several GPUs runs here over ``xla_force_host_platform_device_count=8``,
so the row-partitioned matvec (ppermute halo exchange), the psum-reduced
Gram–Schmidt, and the replicated reduced problem are all exercised without
hardware. Oracles are the single-device implementations and scipy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

from exponentialutilities_jl_tpu import (
    advection_diffusion_1d, expv, laplacian_1d, phiv, poisson_2d,
)
from exponentialutilities_jl_tpu.parallel import (
    expv_sharded, make_expv_step, make_mesh, phiv_sharded, shard_banded,
    shard_vector,
)
from jax.sharding import PartitionSpec as P


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


class TestHaloMatvec:
    def test_banded_matvec_matches_global(self, mesh, rng):
        op = poisson_2d(16, 8)  # n=128, offsets up to ±16 (= local size)
        x = jnp.asarray(rng.standard_normal(128))
        diags_sharded, make_local = shard_banded(op, mesh)

        import functools
        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P(None, "shard"), P("shard")),
                           out_specs=P("shard"))
        def mv(diags_local, x_local):
            return make_local(diags_local).matvec(x_local)

        y = mv(diags_sharded, shard_vector(x, mesh))
        np.testing.assert_allclose(np.asarray(y), np.asarray(op.matvec(x)),
                                   rtol=1e-13, atol=1e-13)

    def test_wide_offsets_rejected(self, mesh, rng):
        op = poisson_2d(32, 4)  # offset 32 > local size 16
        x = jnp.asarray(rng.standard_normal(128))
        with pytest.raises(ValueError, match="halo"):
            expv_sharded(0.1, op, x, mesh, m=10)


class TestShardedExpv:
    def test_hermitian_vs_single_device(self, mesh, rng):
        op = laplacian_1d(256)
        b = jnp.asarray(rng.standard_normal(256))
        w_sharded = expv_sharded(0.5, op, b, mesh, m=40)
        w_single = expv(0.5, op, b, m=40)
        np.testing.assert_allclose(np.asarray(w_sharded),
                                   np.asarray(w_single), rtol=1e-10,
                                   atol=1e-12)

    def test_vs_scipy_oracle(self, mesh, rng):
        op = laplacian_1d(128)
        b = jnp.asarray(rng.standard_normal(128))
        w = expv_sharded(0.3, op, b, mesh, m=50)
        oracle = sla.expm(0.3 * np.asarray(op.to_dense())) @ np.asarray(b)
        np.testing.assert_allclose(np.asarray(w), oracle, rtol=1e-9,
                                   atol=1e-10)

    def test_nonhermitian_arnoldi(self, mesh, rng):
        op = advection_diffusion_1d(128, peclet=3.0)
        b = jnp.asarray(rng.standard_normal(128))
        w = expv_sharded(5e-4, op, b, mesh, m=40)
        oracle = sla.expm(5e-4 * np.asarray(op.to_dense())) @ np.asarray(b)
        np.testing.assert_allclose(np.asarray(w), oracle, rtol=1e-8,
                                   atol=1e-9)

    def test_step_factory_reuse(self, mesh, rng):
        op = laplacian_1d(128)
        step, diags = make_expv_step(op, mesh, m=30)
        b = shard_vector(jnp.asarray(rng.standard_normal(128)), mesh)
        w1 = step(0.1, diags, b)
        w2 = step(0.2, diags, b)
        o1 = sla.expm(0.1 * np.asarray(op.to_dense())) @ np.asarray(b)
        o2 = sla.expm(0.2 * np.asarray(op.to_dense())) @ np.asarray(b)
        np.testing.assert_allclose(np.asarray(w1), o1, rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(np.asarray(w2), o2, rtol=1e-9, atol=1e-10)


class TestShardedPhiv:
    def test_vs_single_device(self, mesh, rng):
        op = laplacian_1d(128)
        b = jnp.asarray(rng.standard_normal(128))
        w_sharded, err_s = phiv_sharded(0.2, op, b, 3, mesh, m=40)
        w_single, err_d = phiv(0.2, op, b, 3, m=40, errest=True)
        np.testing.assert_allclose(np.asarray(w_sharded),
                                   np.asarray(w_single), rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(float(err_s), float(err_d), rtol=1e-8,
                                   atol=1e-14)


class TestGspmdAutoSharding:
    """The whole stack distributed by sharding annotations alone
    (parallel/gspmd.py): expv, phiv_timestep, kiops on sharded inputs."""

    def test_expv_sharded_output(self, mesh, rng):
        from exponentialutilities_jl_tpu.parallel import shard_operator
        op = laplacian_1d(256)
        b = rng.standard_normal(256)
        op_s = shard_operator(op, mesh)
        b_s = shard_vector(jnp.asarray(b), mesh)
        w = expv(0.5, op_s, b_s, m=40)
        oracle = sla.expm(0.5 * np.asarray(op.to_dense())) @ b
        np.testing.assert_allclose(np.asarray(w), oracle, rtol=1e-9,
                                   atol=1e-11)
        assert "shard" in str(w.sharding)

    def test_ell_operator_sharded(self, mesh, rng):
        from exponentialutilities_jl_tpu.parallel import shard_operator
        op = laplacian_1d(256).to_ell()
        b = rng.standard_normal(256)
        w = expv(0.5, shard_operator(op, mesh),
                 shard_vector(jnp.asarray(b), mesh), m=40, hermitian=True)
        oracle = sla.expm(0.5 * np.asarray(laplacian_1d(256).to_dense())) @ b
        np.testing.assert_allclose(np.asarray(w), oracle, rtol=1e-9,
                                   atol=1e-11)

    def test_timestepping_inherits_distribution(self, mesh, rng):
        from exponentialutilities_jl_tpu import expv_timestep
        from exponentialutilities_jl_tpu.parallel import shard_operator
        op = laplacian_1d(256)
        b = rng.standard_normal(256)
        U = expv_timestep([0.5], shard_operator(op, mesh),
                          shard_vector(jnp.asarray(b), mesh), adaptive=True)
        oracle = sla.expm(0.5 * np.asarray(op.to_dense())) @ b
        np.testing.assert_allclose(np.asarray(U[:, 0]), oracle, rtol=1e-6,
                                   atol=1e-8)

    def test_kiops_inherits_distribution(self, mesh, rng):
        from exponentialutilities_jl_tpu import kiops
        from exponentialutilities_jl_tpu.parallel import shard_operator
        op = laplacian_1d(256)
        b = rng.standard_normal(256)
        w, _ = kiops([0.5], shard_operator(op, mesh),
                     shard_vector(jnp.asarray(b), mesh)[:, None])
        oracle = sla.expm(0.5 * np.asarray(op.to_dense())) @ b
        np.testing.assert_allclose(np.asarray(w).ravel(), oracle, rtol=1e-6,
                                   atol=1e-8)

    def test_nw_device_inherits_distribution(self, mesh, rng):
        """The device-resident adaptive NW driver (one lax.while_loop
        program) partitions under GSPMD like the host driver: sharded
        operator arrays + sharded B, no distributed-specific code."""
        from exponentialutilities_jl_tpu.models.nw_device import (
            phiv_timestep_device)
        from exponentialutilities_jl_tpu.parallel import shard_operator
        op = laplacian_1d(256)
        b = rng.standard_normal(256)
        U = phiv_timestep_device([0.5], shard_operator(op, mesh),
                                 shard_vector(jnp.asarray(b), mesh)[:, None],
                                 m=20)
        oracle = sla.expm(0.5 * np.asarray(op.to_dense())) @ b
        np.testing.assert_allclose(np.asarray(U[:, 0]), oracle, rtol=1e-6,
                                   atol=1e-8)

    def test_kiops_device_inherits_distribution(self, mesh, rng):
        from exponentialutilities_jl_tpu.models.kiops_device import (
            kiops_device)
        from exponentialutilities_jl_tpu.parallel import shard_operator
        op = laplacian_1d(256)
        b = rng.standard_normal(256)
        w, info = kiops_device([0.5], shard_operator(op, mesh),
                               shard_vector(jnp.asarray(b), mesh)[:, None])
        oracle = sla.expm(0.5 * np.asarray(op.to_dense())) @ b
        np.testing.assert_allclose(np.asarray(w).ravel(), oracle, rtol=1e-6,
                                   atol=1e-8)

    def test_exprb_device_adaptive_sharded(self, mesh, rng):
        """Adaptive device-resident exprb43 on a sharded semilinear
        problem: the while-loop program partitions over the mesh; the
        result keeps the row sharding and matches the unsharded run."""
        from exponentialutilities_jl_tpu.models.integrators import (
            exprb43_device)
        from exponentialutilities_jl_tpu.parallel import shard_operator
        op = laplacian_1d(256)
        u0_np = rng.standard_normal(256) * 0.1

        def make_f(A):
            return lambda u: A.matvec(u) - u ** 3

        op_s = shard_operator(op, mesh)
        u1, stats = exprb43_device(
            make_f(op_s), shard_vector(jnp.asarray(u0_np), mesh),
            (0.0, 0.05), adaptive=True, m=12, rtol=1e-6, atol=1e-9,
            return_stats=True)
        assert int(stats.info) == 0
        assert "shard" in str(u1.sharding)
        u1_ref, stats_ref = exprb43_device(
            make_f(op), jnp.asarray(u0_np), (0.0, 0.05), adaptive=True,
            m=12, rtol=1e-6, atol=1e-9, return_stats=True)
        assert int(stats.steps) == int(stats_ref.steps)
        np.testing.assert_allclose(np.asarray(u1), np.asarray(u1_ref),
                                   rtol=1e-10, atol=1e-12)


class TestShardedStencil:
    """Plane-halo sharded stencil operators (parallel/stencil.py)."""

    def test_matvec_matches_global(self, mesh, rng):
        import functools
        from exponentialutilities_jl_tpu import laplacian_nd_stencil
        from exponentialutilities_jl_tpu.parallel import shard_stencil
        st = laplacian_nd_stencil(16, 4, 4)   # 256 points, axis0=16 over 8
        x = jnp.asarray(rng.standard_normal(256))
        coeffs, make_local = shard_stencil(st, mesh)

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P(), P("shard")),
                           out_specs=P("shard"))
        def mv(c, x_local):
            return make_local(c).matvec(x_local)

        y = mv(coeffs, shard_vector(x, mesh))
        np.testing.assert_allclose(np.asarray(y), np.asarray(st.matvec(x)),
                                   rtol=1e-13, atol=1e-13)

    def test_expv_sharded_stencil(self, mesh, rng):
        from exponentialutilities_jl_tpu import laplacian_nd_stencil
        st = laplacian_nd_stencil(16, 4, 4)
        b = jnp.asarray(rng.standard_normal(256))
        w = expv_sharded(0.1, st, b, mesh, m=40)
        dense = np.asarray(st.to_banded().to_dense())
        oracle = sla.expm(0.1 * dense) @ np.asarray(b)
        np.testing.assert_allclose(np.asarray(w), oracle, rtol=1e-9,
                                   atol=1e-10)

    def test_phiv_sharded_stencil(self, mesh, rng):
        from exponentialutilities_jl_tpu import laplacian_nd_stencil, phiv
        st = laplacian_nd_stencil(16, 4, 4)
        b = jnp.asarray(rng.standard_normal(256))
        w_s, err_s = phiv_sharded(0.2, st, b, 2, mesh, m=30)
        w_d, err_d = phiv(0.2, st, b, 2, m=30, errest=True,
                          reduced="device")
        np.testing.assert_allclose(np.asarray(w_s), np.asarray(w_d),
                                   rtol=1e-9, atol=1e-11)

    def test_matvec_wide_halo(self, mesh, rng):
        # round-4: |axis-0 offset| up to 3 — the h0-deep plane halo
        # (ppermute of h0 boundary planes) must match the single-device
        # wide-star matvec; the sharded layer was generic in h0 all
        # along but only h0 = 1 was exercised
        import functools
        from exponentialutilities_jl_tpu import StencilOperator
        from exponentialutilities_jl_tpu.parallel import shard_stencil
        shape = (32, 3, 5)                  # axis0 = 32 over 8 → local 4
        offs = [(0, 0, 0)]
        for ax in range(3):
            for o in (1, -1, 2, -2, 3, -3):
                off = [0, 0, 0]
                off[ax] = o
                offs.append(tuple(off))
        co = rng.standard_normal(len(offs)) / 6
        st = StencilOperator(shape, offs, jnp.asarray(co))
        n = int(np.prod(shape))
        x = jnp.asarray(rng.standard_normal(n))
        coeffs, make_local = shard_stencil(st, mesh)

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P(), P("shard")),
                           out_specs=P("shard"))
        def mv(c, x_local):
            return make_local(c).matvec(x_local)

        y = mv(coeffs, shard_vector(x, mesh))
        np.testing.assert_allclose(np.asarray(y), np.asarray(st.matvec(x)),
                                   rtol=1e-12, atol=1e-12)

    def test_expv_sharded_wide_stencil(self, mesh, rng):
        # symmetric 6th-order-class star through the full sharded Krylov
        from exponentialutilities_jl_tpu import StencilOperator
        shape = (32, 3, 5)
        n = int(np.prod(shape))
        offs, co = [(0, 0, 0)], [-3.0 * 49 / 18]
        for ax in range(3):
            for o, c in ((1, 1.5), (-1, 1.5), (2, -0.15), (-2, -0.15),
                         (3, 1 / 90), (-3, 1 / 90)):
                off = [0, 0, 0]
                off[ax] = o
                offs.append(tuple(off))
                co.append(c)
        st = StencilOperator(shape, offs, jnp.asarray(np.asarray(co) / 4),
                             is_hermitian=True)
        b = jnp.asarray(rng.standard_normal(n))
        w_s = expv_sharded(0.3, st, b, mesh, m=40)
        w_d = expv(0.3, st, b, m=40)
        np.testing.assert_allclose(np.asarray(w_s), np.asarray(w_d),
                                   rtol=1e-9, atol=1e-10)

    def test_halo_deeper_than_slab_rejected(self, mesh, rng):
        # h0 = 3 > local slab depth 2 cannot be served by one ppermute
        # ring hop — must raise, not silently corrupt
        import functools
        from exponentialutilities_jl_tpu import StencilOperator
        from exponentialutilities_jl_tpu.parallel import shard_stencil
        st = StencilOperator((16, 4, 4), [(3, 0, 0), (0, 0, 0), (-3, 0, 0)],
                             jnp.asarray([1.0, -2.0, 1.0]))
        coeffs, make_local = shard_stencil(st, mesh)   # local depth 2

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P(), P("shard")),
                           out_specs=P("shard"))
        def mv(c, x_local):
            return make_local(c).matvec(x_local)

        with pytest.raises(ValueError, match="halo"):
            mv(coeffs, shard_vector(
                jnp.asarray(rng.standard_normal(256)), mesh))

    def test_make_expv_step_stencil(self, mesh, rng):
        from exponentialutilities_jl_tpu import laplacian_nd_stencil
        from exponentialutilities_jl_tpu.parallel import make_expv_step
        st = laplacian_nd_stencil(16, 4, 4)
        step, params = make_expv_step(st, mesh, m=20)
        b = shard_vector(jnp.asarray(rng.standard_normal(256)), mesh)
        w = step(0.1, params, b)
        dense = np.asarray(st.to_banded().to_dense())
        np.testing.assert_allclose(np.asarray(w),
                                   sla.expm(0.1 * dense) @ np.asarray(b),
                                   rtol=1e-9, atol=1e-10)


def test_expv_sharded_two_pass(mesh, rng):
    """Storage-free two-pass Lanczos under shard_map (psum reductions +
    halo matvec, O(n_local) memory per shard)."""
    op = laplacian_1d(256)
    b = jnp.asarray(rng.standard_normal(256))
    w = expv_sharded(0.5, op, b, mesh, m=40, two_pass=True)
    oracle = sla.expm(0.5 * np.asarray(op.to_dense())) @ np.asarray(b)
    np.testing.assert_allclose(np.asarray(w), oracle, rtol=1e-9, atol=1e-10)


def test_2d_mesh_batched_expv(rng):
    """dp × rows 2-D mesh: batch of RHS sharded on "data", operator rows on
    "shard" — GSPMD parallelizes both axes (the dp+sp composition)."""
    from jax.sharding import Mesh, NamedSharding
    from exponentialutilities_jl_tpu import BandedOperator, expv_batched

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh2 = Mesh(devs, ("data", "shard"))
    op = laplacian_1d(128)
    diags_s = jax.device_put(op.diags, NamedSharding(mesh2, P(None, "shard")))
    op_s = BandedOperator(diags_s, op.offsets, is_hermitian=True)
    B = rng.standard_normal((4, 128))
    B_s = jax.device_put(jnp.asarray(B),
                         NamedSharding(mesh2, P("data", "shard")))
    W = expv_batched(0.3, op_s, B_s, m=30)
    E = sla.expm(0.3 * np.asarray(op.to_dense()))
    np.testing.assert_allclose(np.asarray(W), (E @ B.T).T, rtol=1e-10,
                               atol=1e-12)
    assert "data" in str(W.sharding) and "shard" in str(W.sharding)


import exponentialutilities_jl_tpu as eu


class TestMultiHost:
    """Multi-host entry points emulated on the virtual mesh
    (parallel/multihost.py; VERDICT r1 missing #5)."""

    def test_global_mesh_expv_matches_dense(self, rng):
        import scipy.linalg as sla
        from exponentialutilities_jl_tpu.parallel import (make_expv_step,
                                                          make_global_mesh,
                                                          shard_vector)
        mesh = make_global_mesh()
        assert mesh.devices.size == 8
        n = 64
        op = eu.laplacian_1d(n, dtype=jnp.float64)
        step, diags = make_expv_step(op, mesh, m=20)
        b = rng.standard_normal(n)
        w = np.asarray(step(0.1, diags, shard_vector(jnp.asarray(b), mesh)))
        want = sla.expm(0.1 * np.asarray(op.to_dense())) @ b
        assert np.linalg.norm(w - want) / np.linalg.norm(want) < 1e-10

    def test_host_data_mesh_batched(self, rng):
        import scipy.linalg as sla
        from jax.sharding import NamedSharding, PartitionSpec as P
        from exponentialutilities_jl_tpu.parallel import make_host_data_mesh
        mesh = make_host_data_mesh(n_hosts=2)
        assert mesh.shape["data"] == 2 and mesh.shape["shard"] == 4
        n = 32
        op = eu.laplacian_1d(n, dtype=jnp.float64)
        diags_s = jax.device_put(op.diags,
                                 NamedSharding(mesh, P(None, "shard")))
        op_s = eu.BandedOperator(diags_s, op.offsets, is_hermitian=True)
        B = rng.standard_normal((4, n))
        Bs = jax.device_put(jnp.asarray(B),
                            NamedSharding(mesh, P("data", "shard")))
        W = np.asarray(eu.expv_batched(0.1, op_s, Bs, m=16))
        E = sla.expm(0.1 * np.asarray(op.to_dense()))
        for i in range(4):
            want = E @ B[i]
            assert np.linalg.norm(W[i] - want) / np.linalg.norm(want) < 1e-9

    def test_initialize_distributed_single_process_noop(self):
        from exponentialutilities_jl_tpu.parallel import initialize_distributed
        assert initialize_distributed() is False

    def test_data_mesh_krylov_body_has_no_data_axis_collective(self):
        # The data x rows layout's selling point: the compiled Krylov body
        # contains no all-reduce over the data (DCN) axis. Verified on the
        # optimized HLO: every all-reduce's replica_groups must only pair
        # devices within one data row (i.e. groups of size <= 4 devices of
        # the shard axis).
        import re
        from jax.sharding import NamedSharding, PartitionSpec as P
        from exponentialutilities_jl_tpu.parallel import make_host_data_mesh
        mesh = make_host_data_mesh(n_hosts=2)
        n = 32
        op = eu.laplacian_1d(n, dtype=jnp.float32)
        diags_s = jax.device_put(op.diags,
                                 NamedSharding(mesh, P(None, "shard")))
        op_s = eu.BandedOperator(diags_s, op.offsets, is_hermitian=True)
        B = jax.device_put(jnp.ones((4, n), jnp.float32),
                           NamedSharding(mesh, P("data", "shard")))
        fn = jax.jit(lambda B: eu.expv_batched(0.1, op_s, B, m=8))
        hlo = fn.lower(B).compile().as_text()
        # shard-axis groups on the (2,4) mesh are {0..3} and {4..7}
        for groups in re.findall(r"replica_groups=\{(.*?)\}\}", hlo):
            for grp in re.findall(r"\{([\d,]+)\}", "{" + groups + "}}"):
                ids = [int(x) for x in grp.split(",")]
                rows = {i // 4 for i in ids}
                assert len(rows) == 1, f"collective crosses data axis: {ids}"


class TestShardedChebyshev:
    def test_vs_single_device_and_oracle(self, mesh, rng):
        from exponentialutilities_jl_tpu.parallel import (
            expv_chebyshev_sharded)
        from exponentialutilities_jl_tpu import expv_chebyshev
        op = laplacian_1d(256)
        b = jnp.asarray(rng.standard_normal(256))
        w_sh = expv_chebyshev_sharded(0.5, op, b, mesh, tol=1e-12)
        w_1 = expv_chebyshev(0.5, op, b, tol=1e-12,
                             bounds=op.spectral_bounds_hint())
        np.testing.assert_allclose(np.asarray(w_sh), np.asarray(w_1),
                                   rtol=1e-10, atol=1e-12)
        oracle = sla.expm(0.5 * np.asarray(op.to_dense())) @ np.asarray(b)
        np.testing.assert_allclose(np.asarray(w_sh), oracle, rtol=1e-9,
                                   atol=1e-10)

    def test_stencil_sharded(self, mesh, rng):
        from exponentialutilities_jl_tpu.parallel import (
            expv_chebyshev_sharded)
        from exponentialutilities_jl_tpu.ops.stencil import (
            laplacian_nd_stencil)
        op = laplacian_nd_stencil(256, dtype=jnp.float64)
        b = jnp.asarray(rng.standard_normal(256))
        w = expv_chebyshev_sharded(0.4, op, b, mesh, tol=1e-12)
        bop = op.to_banded()
        oracle = sla.expm(0.4 * np.asarray(bop.to_dense())) @ np.asarray(b)
        np.testing.assert_allclose(np.asarray(w), oracle, rtol=1e-9,
                                   atol=1e-10)

    def test_banded_gershgorin_hint(self):
        op = laplacian_1d(64)
        lo, hi = op.spectral_bounds_hint()
        w = np.linalg.eigvalsh(np.asarray(op.to_dense()))
        assert lo <= w[0] and hi >= w[-1]
        assert lo == pytest.approx(-4.0) and hi == pytest.approx(0.0)


class TestGspmdChebyshev:
    def test_chebyshev_gspmd_autosharded(self, mesh, rng):
        """The Chebyshev scan under GSPMD: sharded operator + vector in,
        row-sharded result out, numerics identical to single-device."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from exponentialutilities_jl_tpu import expv_chebyshev
        from exponentialutilities_jl_tpu.parallel import shard_operator
        op = laplacian_1d(256)
        op_s = shard_operator(op, mesh)
        b = jnp.asarray(rng.standard_normal(256))
        b_s = jax.device_put(b, NamedSharding(mesh, P("shard")))
        w_s = expv_chebyshev(0.5, op_s, b_s, tol=1e-12,
                             bounds=op.spectral_bounds_hint())
        w_1 = expv_chebyshev(0.5, op, b, tol=1e-12,
                             bounds=op.spectral_bounds_hint())
        np.testing.assert_allclose(np.asarray(w_s), np.asarray(w_1),
                                   rtol=1e-11, atol=1e-13)

    def test_chebyshev_vmap_multi_rhs(self, rng):
        """vmapped Chebyshev over a batch of right-hand sides (shared
        coefficients — one compiled program, batched matvecs)."""
        from exponentialutilities_jl_tpu.models.chebyshev import (
            _chebyshev_apply_scan, _full_exp_coeffs)
        op = laplacian_1d(128)
        Bm = jnp.asarray(rng.standard_normal((5, 128)))
        full, c, h = _full_exp_coeffs(0.4, -4.0, 0.0, 1e-12, None)
        coeffs = jnp.asarray(full)
        wb = jax.vmap(lambda b: _chebyshev_apply_scan(op, b, coeffs, c,
                                                      1.0 / h))(Bm)
        from exponentialutilities_jl_tpu import expv_chebyshev
        for i in range(5):
            w1 = expv_chebyshev(0.4, op, Bm[i], tol=1e-12,
                                bounds=(-4.0, 0.0))
            np.testing.assert_allclose(np.asarray(wb[i]), np.asarray(w1),
                                       rtol=1e-10, atol=1e-12)


class TestShardedPoly:
    """Sharded NON-HERMITIAN polynomial actions (parallel/poly.py —
    VERDICT r3 #2): Leja and Faber under shard_map with halo-only
    communication, plus the GSPMD route for the adaptive phi drivers."""

    def _op(self):
        from exponentialutilities_jl_tpu import advection_diffusion_3d_stencil
        return advection_diffusion_3d_stencil(16, 8, 8, peclet=4.0)

    def _dense(self, op, n):
        A = np.zeros((n, n))
        for i in range(n):
            e = np.zeros(n)
            e[i] = 1
            A[:, i] = np.asarray(op.matvec(jnp.asarray(e)))
        return A

    def test_leja_sharded_vs_single_and_oracle(self, mesh, rng):
        from exponentialutilities_jl_tpu import expv_leja
        from exponentialutilities_jl_tpu.parallel import expv_leja_sharded
        op = self._op()
        n = 16 * 8 * 8
        b = jnp.asarray(rng.standard_normal(n))
        t = 0.004
        ws = expv_leja_sharded(t, op, b, mesh)
        w1 = expv_leja(t, op, b)
        # same coefficients, same recurrence: f64-roundoff-identical
        assert float(jnp.linalg.norm(jnp.asarray(ws) - w1)
                     / jnp.linalg.norm(w1)) < 1e-13
        want = sla.expm(t * self._dense(op, n)) @ np.asarray(b)
        assert (np.linalg.norm(np.asarray(ws) - want)
                / np.linalg.norm(want)) < 1e-6

    def test_faber_sharded_vs_single_and_oracle(self, mesh, rng):
        from exponentialutilities_jl_tpu import expv_faber
        from exponentialutilities_jl_tpu.parallel import expv_faber_sharded
        op = self._op()
        n = 16 * 8 * 8
        b = jnp.asarray(rng.standard_normal(n))
        t = 0.004
        wf = expv_faber_sharded(t, op, b, mesh)
        w1 = expv_faber(t, op, b)
        assert float(jnp.linalg.norm(jnp.asarray(wf) - w1)
                     / jnp.linalg.norm(w1)) < 1e-13
        want = sla.expm(t * self._dense(op, n)) @ np.asarray(b)
        assert (np.linalg.norm(np.asarray(wf) - want)
                / np.linalg.norm(want)) < 1e-6

    def test_leja_sharded_zero_allreduce(self, mesh, rng):
        # the selling point: the compiled per-iteration body has NO
        # all-reduce at all — communication is the halo permute alone
        import re
        import functools
        from jax.sharding import PartitionSpec as P
        from exponentialutilities_jl_tpu.models.leja import _leja_apply
        from exponentialutilities_jl_tpu.parallel.krylov import _shard_op
        op = self._op()
        n = 16 * 8 * 8
        params, make_local, pspec = _shard_op(op, mesh, "shard")
        d = jnp.asarray(rng.standard_normal(12))
        xi = jnp.asarray(rng.standard_normal(12))

        @jax.jit
        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(pspec, P("shard")),
                           out_specs=P("shard"))
        def run(c, b_local):
            return _leja_apply(make_local(c), b_local, d, xi, 0.0, 1.0,
                               12, 1)

        b = shard_vector(jnp.ones(n), mesh)
        hlo = run.lower(params, b).compile().as_text()
        assert "all-reduce" not in hlo
        assert "collective-permute" in hlo      # the halo exchange

    def test_gspmd_phiv_timestep_leja_faber(self, mesh, rng):
        # the adaptive phi drivers inherit multi-chip execution through
        # sharding annotations alone: shard B, call the ordinary driver
        from jax.sharding import NamedSharding, PartitionSpec as P
        from exponentialutilities_jl_tpu import (phiv_timestep_faber,
                                                 phiv_timestep_leja)
        op = self._op()
        n = 16 * 8 * 8
        b = jnp.asarray(rng.standard_normal(n))
        B = jnp.stack([b, 0.1 * b], axis=1)
        Bs = jax.device_put(B, NamedSharding(mesh, P("shard", None)))
        for drv in (phiv_timestep_leja, phiv_timestep_faber):
            U1 = drv([0.003], op, B)
            U2 = drv([0.003], op, Bs)
            assert float(jnp.linalg.norm(jnp.asarray(U2) - jnp.asarray(U1))
                         / jnp.linalg.norm(jnp.asarray(U1))) < 1e-13
