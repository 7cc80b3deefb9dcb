"""SELL-window packs and their SpMV (ops/sell.py): packer invariants,
roll-gather and residue variants vs scipy, window widths (VERDICT r1
item 1 — unstructured SpMV layout)."""

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp

from exponentialutilities_jl_tpu.ops.sell import (
    SellData, sell_pack, sell_spmv_ref, sell_spmv_ref)


def banded_random(rng, n, d, band):
    rows = np.repeat(np.arange(n), d)
    cols = np.clip(rows + rng.integers(-band // 2, band // 2, n * d), 0, n - 1)
    vals = rng.standard_normal(n * d)
    return rows, cols, vals


@pytest.mark.parametrize("residue", [False, True])
def test_sell_matches_scipy(rng, residue):
    n, d, band = 3000, 9, 600
    rows, cols, vals = banded_random(rng, n, d, band)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    data = sell_pack((rows, cols, vals.astype(np.float32)), n,
                     residue=residue)
    x = rng.standard_normal(n).astype(np.float32)
    want = A @ x
    y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5


@pytest.mark.parametrize("band,window", [(800, 2048), (2500, 4096)])
def test_sell_wider_windows(rng, band, window):
    n, d = 4096, 7
    rows, cols, vals = banded_random(rng, n, d, band)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    data = sell_pack((rows, cols, vals.astype(np.float32)), n, window=window)
    x = rng.standard_normal(n).astype(np.float32)
    want = A @ x
    y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5


def test_sell_window_violation_raises(rng):
    n = 2000
    rows = np.array([0, 5])
    cols = np.array([0, 1999])          # spans far beyond one window
    vals = np.array([1.0, 2.0])
    with pytest.raises(ValueError):
        sell_pack((rows, cols, vals), n, window=1024)


def test_sell_duplicates_and_empty_rows(rng):
    # duplicate (row, col) entries sum; rows with no entries give zero
    n = 300
    rows = np.array([2, 2, 2, 150])
    cols = np.array([7, 7, 9, 160])
    vals = np.array([1.0, 2.0, 4.0, 8.0])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    data = sell_pack((rows, cols, vals.astype(np.float32)), n)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
    want = A @ x
    assert np.max(np.abs(y - want)) < 1e-5


def test_sell_pack_fill_accounting(rng):
    n, d, band = 1024, 8, 200
    rows, cols, vals = banded_random(rng, n, d, band)
    data = sell_pack((rows, cols, vals.astype(np.float32)), n)
    # duplicates are summed at pack time: nnz is the deduplicated count
    ndedup = len(set(zip(rows.tolist(), cols.tolist())))
    assert data.nnz == ndedup
    assert data.vals.shape[1:] == (8, 128)
    # every stored value appears exactly once
    assert np.isclose(float(jnp.sum(data.vals)), float(np.sum(vals)),
                      rtol=1e-4)


def test_sell_operator_in_expv(rng):
    # the container plugs into the Krylov stack end-to-end
    import exponentialutilities_jl_tpu as eu
    import scipy.linalg as sla
    n, d, band = 512, 6, 200
    rows, cols, vals = banded_random(rng, n, d, band)
    # symmetrize so the Lanczos path is exercised
    import scipy.sparse as sp
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T).tocoo()
    op = eu.SellOperator.from_coo(A.row, A.col, A.data / 10, n,
                                  dtype=np.float64, is_hermitian=True)
    b = rng.standard_normal(n)
    w = np.asarray(eu.expv(0.3, op, jnp.asarray(b), m=40))
    want = sla.expm(0.3 * np.asarray(A.todense()) / 10) @ b
    assert np.linalg.norm(w - want) / np.linalg.norm(want) < 1e-9


def test_sell_operator_rcm(rng):
    # RCM permutation makes a shuffled banded matrix window-packable
    import exponentialutilities_jl_tpu as eu
    import scipy.sparse as sp
    n, d, band = 6000, 6, 300
    rows, cols, vals = banded_random(rng, n, d, band)
    p = rng.permutation(n)               # scramble away the band
    A = sp.coo_matrix((vals, (p[rows], p[cols])), shape=(n, n))
    with pytest.raises(ValueError):
        eu.SellOperator.from_coo(A.row, A.col, A.data, n)   # no locality
    op = eu.SellOperator.from_coo(A.row, A.col, A.data, n, rcm=True,
                                  window=2048)
    x = rng.standard_normal(n).astype(np.float32)
    # operator acts in permuted space: y_perm = P A P^T (P x)
    perm = op.perm
    xp = x[perm]
    yp = np.asarray(op.matvec(jnp.asarray(xp)))
    want = (A @ x)[perm]
    assert np.max(np.abs(yp - want)) / np.max(np.abs(want)) < 1e-4


def test_sell_rowsel_mode(rng):
    n, d, band = 3000, 9, 600
    rows, cols, vals = banded_random(rng, n, d, band)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    data = sell_pack((rows, cols, vals.astype(np.float32)), n, window=2048,
                     mode="rowsel")
    x = rng.standard_normal(n).astype(np.float32)
    want = A @ x
    y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5


def scattered_random(rng, n, d, band, nfar):
    """Banded bulk plus per-row long-range couplings — the class the
    single-window packing cannot hold (RCM bandwidth >> window)."""
    rows, cols, vals = banded_random(rng, n, d, band)
    frows = rng.integers(0, n, nfar)
    fcols = rng.integers(0, n, nfar)
    return (np.concatenate([rows, frows]), np.concatenate([cols, fcols]),
            np.concatenate([vals, rng.standard_normal(nfar)]))


def test_sell_chunked_matches_scipy(rng):
    n, d, band = 3000, 7, 500
    rows, cols, vals = scattered_random(rng, n, d, band, nfar=800)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    with pytest.raises(ValueError):
        sell_pack((rows, cols, vals), n, window=1024)     # span too wide
    data = sell_pack((rows, cols, vals.astype(np.float32)), n,
                     window=1024, mode="chunked", max_chunks=4)
    assert data.mode == "chunked" and data.chunks == 4
    x = rng.standard_normal(n).astype(np.float32)
    want = A @ x
    y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5


def test_sell_chunked_too_many_slabs_raises(rng):
    n = 4000
    rows = np.arange(32)
    cols = (rows * 125) % n              # 32 far-flung columns in one block
    vals = np.ones(32)
    with pytest.raises(ValueError):
        sell_pack((rows, cols, vals), n, window=1024, mode="chunked",
                  max_chunks=2)


def test_sell_chunked_duplicates_empty_rows(rng):
    n = 2000
    rows = np.array([2, 2, 2, 150, 700])
    cols = np.array([7, 7, 1900, 160, 1500])   # forces 2+ slabs
    vals = np.array([1.0, 2.0, 4.0, 8.0, 16.0])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    data = sell_pack((rows, cols, vals.astype(np.float32)), n,
                     window=1024, mode="chunked", max_chunks=3)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
    assert np.max(np.abs(y - np.asarray(A @ x))) < 1e-5


def test_sell_chunked_operator_in_expv(rng):
    import exponentialutilities_jl_tpu as eu
    import scipy.linalg as sla
    n, d, band = 512, 5, 150
    rows, cols, vals = scattered_random(rng, n, d, band, nfar=200)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T).tocoo()
    op = eu.SellOperator.from_coo(A.row, A.col, A.data / 10, n,
                                  dtype=np.float64, is_hermitian=True,
                                  window=1024, mode="chunked",
                                  max_chunks=8)
    b = rng.standard_normal(n)
    w = np.asarray(eu.expv(0.3, op, jnp.asarray(b), m=40))
    want = sla.expm(0.3 * np.asarray(A.todense()) / 10) @ b
    assert np.linalg.norm(w - want) / np.linalg.norm(want) < 1e-9


def test_sell_save_load_roundtrip(tmp_path, rng):
    """Pack persistence: production serving packs once, loads on
    restart (packing 10M rows costs tens of host seconds)."""
    from exponentialutilities_jl_tpu.ops.sell import (
        SellData, sell_pack, sell_spmv_ref)
    n = 600
    d = 5
    rows = np.repeat(np.arange(n), d)
    cols = np.clip(rows + rng.integers(-40, 40, n * d), 0, n - 1)
    vals = rng.standard_normal(n * d).astype(np.float32)
    data = sell_pack((rows, cols, vals), n, window=1024)
    path = str(tmp_path / "pack.npz")
    data.save(path)
    back = SellData.load(path)
    assert back.mode == data.mode and back.n == data.n \
        and back.nnz == data.nnz and back.cap == data.cap
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    np.testing.assert_array_equal(np.asarray(sell_spmv_ref(back, x)),
                                  np.asarray(sell_spmv_ref(data, x)))


class TestSubroll:
    """Per-group 1024-wide subwindows (mode='subroll', round 3): half the
    roll/gather/select sequence of the full-window roll path. Auto-picked
    by sell_pack(mode=None) whenever every 128-row group's span fits an
    aligned 1024 subwindow."""

    def test_auto_selects_subroll(self, rng):
        n, d, band = 3000, 9, 600
        rows, cols, vals = banded_random(rng, n, d, band)
        data = sell_pack((rows, cols, vals.astype(np.float32)), n)
        assert data.mode == "subroll"

    def test_explicit_subroll_matches_scipy(self, rng):
        n, d, band = 3000, 9, 700
        rows, cols, vals = banded_random(rng, n, d, band)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
        data = sell_pack((rows, cols, vals.astype(np.float32)), n,
                         mode="subroll")
        x = rng.standard_normal(n).astype(np.float32)
        want = A @ x
        y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5

    def test_explicit_subroll_raises_when_wide(self, rng):
        n, d, band = 4096, 7, 2500
        rows, cols, vals = banded_random(rng, n, d, band)
        with pytest.raises(ValueError, match="subroll"):
            sell_pack((rows, cols, vals.astype(np.float32)), n,
                      window=4096, mode="subroll")

    def test_auto_falls_back_to_roll_when_wide(self, rng):
        n, d, band = 4096, 7, 2500
        rows, cols, vals = banded_random(rng, n, d, band)
        data = sell_pack((rows, cols, vals.astype(np.float32)), n,
                         window=4096)
        assert data.mode == "roll"
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
        x = rng.standard_normal(n).astype(np.float32)
        y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
        want = A @ x
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5

    def test_subroll_duplicates_and_empty_rows(self, rng):
        n = 300
        rows = np.array([2, 2, 2, 150])
        cols = np.array([5, 5, 7, 149])
        vals = np.array([1.0, 2.0, 4.0, 3.0], np.float32)
        data = sell_pack((rows, cols, vals), n, mode="subroll")
        x = np.ones(n, np.float32)
        y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
        want = np.zeros(n); want[2] = 7.0; want[150] = 3.0
        np.testing.assert_allclose(y, want, atol=1e-6)


class TestHybrid:
    """Hybrid structured+SELL decomposition (VERDICT r2 item 2b): dense
    diagonals ride the BandedOperator shift kernel; only the irregular
    tail pays the gather path."""

    def _mesh_like(self, rng, n=3000):
        # FEM/mesh-class after RCM: dense tri-diagonal couplings + a
        # sparse irregular tail within a band
        rows = [np.arange(n)] * 3
        cols = [np.arange(n),
                np.clip(np.arange(n) - 1, 0, n - 1),
                np.clip(np.arange(n) + 1, 0, n - 1)]
        vals = [np.full(n, 4.0), np.full(n, -1.0), np.full(n, -1.0)]
        ntail = 2 * n
        tr = rng.integers(0, n, ntail)
        tc = np.clip(tr + rng.integers(-300, 300, ntail), 0, n - 1)
        rows.append(tr); cols.append(tc)
        vals.append(rng.standard_normal(ntail) * 0.1)
        import scipy.sparse as sp
        return sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))

    def test_split_and_matvec(self, rng):
        import exponentialutilities_jl_tpu as eu
        A = self._mesh_like(rng)
        hy = eu.hybrid_from_scipy(A, min_fill=0.5)
        assert hy.banded is not None and hy.sell is not None
        # the dense couplings went to the banded part
        assert set(hy.banded.offsets) >= {-1, 0, 1}
        x = rng.standard_normal(3000).astype(np.float32)
        y = np.asarray(hy.matvec(jnp.asarray(x)))
        want = A @ x
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5
        # nnz accounting: banded nonzeros + sell nnz = matrix nnz
        assert hy.nnz == A.tocsr().nnz

    def test_all_banded_no_residual(self, rng):
        import exponentialutilities_jl_tpu as eu
        import scipy.sparse as sp
        n = 500
        A = sp.diags([np.full(n - 1, -1.0), np.full(n, 2.0),
                      np.full(n - 1, -1.0)], [-1, 0, 1]).tocoo()
        hy = eu.hybrid_from_scipy(A, min_fill=0.5)
        assert hy.sell is None
        x = rng.standard_normal(n).astype(np.float32)
        y = np.asarray(hy.matvec(jnp.asarray(x)))
        assert np.max(np.abs(y - (A @ x))) < 1e-5

    def test_no_structure_all_sell(self, rng):
        import exponentialutilities_jl_tpu as eu
        import scipy.sparse as sp
        n = 2000
        r = np.repeat(np.arange(n), 4)
        c = np.clip(r + rng.integers(-200, 200, 4 * n), 0, n - 1)
        v = rng.standard_normal(4 * n)
        A = sp.coo_matrix((v, (r, c)), shape=(n, n))
        hy = eu.hybrid_from_scipy(A, min_fill=0.5)
        assert hy.banded is None and hy.sell is not None
        x = rng.standard_normal(n).astype(np.float32)
        y = np.asarray(hy.matvec(jnp.asarray(x)))
        want = A @ x
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-4

    def test_hybrid_in_expv(self, rng):
        import exponentialutilities_jl_tpu as eu
        import scipy.linalg as sla
        A = self._mesh_like(rng, n=600).tocsr()
        A = (A + A.T) / 2      # Hermitian for Lanczos
        hy = eu.hybrid_from_scipy(A, min_fill=0.5, is_hermitian=True)
        b = rng.standard_normal(600)
        w = eu.expv(0.05, hy, jnp.asarray(b), m=40)
        want = sla.expm(0.05 * A.toarray()) @ b
        assert (np.linalg.norm(np.asarray(w) - want)
                / np.linalg.norm(want)) < 1e-6


def test_sell_uniform_fast_path(rng):
    # degree ≤ 8 → one tile per group → the static uniform kernel path
    n, d, band = 3000, 6, 500
    rows, cols, vals = banded_random(rng, n, d, band)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    data = sell_pack((rows, cols, vals.astype(np.float32)), n)
    assert data.mode == "subroll" and data.uniform
    x = rng.standard_normal(n).astype(np.float32)
    want = A @ x
    y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5


class TestUniformK:
    """uniform-k static-schedule repack (round 3): maxdeg > 8 matrices
    padded to exactly k tiles per 128-row group so the kernel keeps the
    fully static fast path (no group_ptr / fori_loop bookkeeping)."""

    def _varying(self, rng, n, dmax, band=500):
        deg = rng.integers(1, dmax + 1, n)
        rows = np.repeat(np.arange(n), deg)
        cols = np.clip(rows + rng.integers(-band // 2, band // 2,
                                           len(rows)), 0, n - 1)
        vals = rng.standard_normal(len(rows)).astype(np.float32)
        return rows, cols, vals

    def test_auto_repacks_and_matches_scipy(self, rng):
        n = 3000
        rows, cols, vals = self._varying(rng, n, 12)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        data = sell_pack((rows, cols, vals), n)
        assert data.mode == "subroll" and data.uk == 2
        assert data.cap == 16
        # exactly uk tiles per group, phantom tiles zero
        gp = np.asarray(data.group_ptr)
        assert np.all(np.diff(gp) == data.uk)
        x = rng.standard_normal(n).astype(np.float32)
        want = A @ x
        y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5
        yr = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
        assert np.max(np.abs(yr - want)) / np.max(np.abs(want)) < 1e-5

    def test_uniform_k_false_keeps_dynamic(self, rng):
        n = 2000
        rows, cols, vals = self._varying(rng, n, 12)
        data = sell_pack((rows, cols, vals), n, uniform_k=False)
        assert data.uk == 0
        x = rng.standard_normal(n).astype(np.float32)
        want = sp.coo_matrix((vals, (rows, cols)),
                             shape=(n, n)).tocsr() @ x
        y = np.asarray(sell_spmv_ref(data, jnp.asarray(x)))
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5

    def test_forced_uniform_k_raises_past_cap(self, rng):
        n = 512
        deg = rng.integers(1, 100, n)
        rows = np.repeat(np.arange(n), deg)
        cols = np.clip(rows + rng.integers(-200, 200, len(rows)),
                       0, n - 1)
        vals = rng.standard_normal(len(rows)).astype(np.float32)
        with pytest.raises(ValueError, match="uniform_k"):
            sell_pack((rows, cols, vals), n, uniform_k=True)
        # auto falls back to the dynamic path silently
        data = sell_pack((rows, cols, vals), n)
        assert data.uk == 0

    def test_save_load_roundtrip_uk(self, rng, tmp_path):
        n = 2000
        rows, cols, vals = self._varying(rng, n, 12)
        data = sell_pack((rows, cols, vals), n)
        assert data.uk >= 2
        p = str(tmp_path / "uk_pack")
        data.save(p)
        d2 = SellData.load(p)
        assert d2.uk == data.uk and d2.mode == data.mode
        x = rng.standard_normal(n).astype(np.float32)
        want = sp.coo_matrix((vals, (rows, cols)),
                             shape=(n, n)).tocsr() @ x
        y = np.asarray(sell_spmv_ref(d2, jnp.asarray(x)))
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5


class TestBucketed:
    """Degree-bucketed SELL (round 3, STATUS gap #1): groups sorted by
    tile-count class, one static uniform-k kernel per class, dynamic
    residual bucket for k > 8, group-granular output regather."""

    def _clustered(self, rng, n=5000, band=300):
        deg = np.full(n, 4)
        deg[n // 3:n // 2] = 20          # k = 3 class
        deg[-n // 16:] = 70              # k = 9 -> dynamic bucket
        rows = np.repeat(np.arange(n), deg)
        cols = np.clip(rows + rng.integers(-band, band, len(rows)),
                       0, n - 1)
        vals = rng.standard_normal(len(rows)).astype(np.float32)
        return rows, cols, vals

    def test_matches_scipy_all_paths(self, rng):
        from exponentialutilities_jl_tpu.ops.sell import (
            sell_pack_bucketed, sell_spmv_bucketed_ref)
        n = 5000
        rows, cols, vals = self._clustered(rng, n)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        bk = sell_pack_bucketed((rows, cols, vals), n)
        uks = [b.uk for b in bk.buckets]
        assert 1 in uks and 3 in uks and 0 in uks    # static + dynamic
        assert bk.nnz == A.nnz
        x = rng.standard_normal(n).astype(np.float32)
        want = A @ x
        y = sell_spmv_bucketed_ref(bk, jnp.asarray(x))
        err = np.max(np.abs(np.asarray(y) - want)) / np.max(np.abs(want))
        assert err < 1e-5

    def test_zero_class_padding(self, rng):
        # within a class there is ZERO padding: tiles = k * groups
        from exponentialutilities_jl_tpu.ops.sell import (
            sell_pack_bucketed)
        n = 4000
        rows, cols, vals = self._clustered(rng, n)
        bk = sell_pack_bucketed((rows, cols, vals), n)
        for b in bk.buckets:
            G = b.group_ptr.shape[0] - 1
            if b.uk:
                assert int(b.group_ptr[-1]) == b.uk * G
                assert b.cap == 8 * b.uk

    def test_operator_in_expv(self, rng):
        import exponentialutilities_jl_tpu as eu
        import scipy.linalg as sla
        n = 768
        deg = np.full(n, 4)
        deg[300:500] = 18
        rows = np.repeat(np.arange(n), deg)
        cols = np.clip(rows + rng.integers(-150, 150, len(rows)),
                       0, n - 1)
        vals = rng.standard_normal(len(rows))
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
        A = (A + A.T).tocoo()
        op = eu.SellOperator.from_coo(A.row, A.col, A.data / 20, n,
                                      dtype=np.float64, mode="bucketed",
                                      is_hermitian=True)
        from exponentialutilities_jl_tpu.ops.sell import (
            SellBucketed)
        assert isinstance(op.data, SellBucketed)
        # opnorm hint bounds the true inf-norm
        hint = float(op.opnorm_hint())
        true_inf = np.max(np.abs(A.tocsr()).sum(axis=1)) / 20
        assert hint >= true_inf - 1e-6 and hint < 2 * true_inf + 1e-6
        b = rng.standard_normal(n)
        w = np.asarray(eu.expv(0.3, op, jnp.asarray(b), m=40))
        want = sla.expm(0.3 * np.asarray(A.todense()) / 20) @ b
        assert np.linalg.norm(w - want) / np.linalg.norm(want) < 1e-9

    def test_save_load_roundtrip(self, rng, tmp_path):
        from exponentialutilities_jl_tpu.ops.sell import (
            SellBucketed, sell_pack_bucketed, sell_spmv_bucketed_ref)
        n = 3000
        rows, cols, vals = self._clustered(rng, n)
        bk = sell_pack_bucketed((rows, cols, vals), n)
        p = str(tmp_path / "bucketed_pack")
        bk.save(p)
        b2 = SellBucketed.load(p)
        assert len(b2.buckets) == len(bk.buckets) and b2.nnz == bk.nnz
        x = jnp.asarray(rng.standard_normal(n), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(sell_spmv_bucketed_ref(b2, x)),
            np.asarray(sell_spmv_bucketed_ref(bk, x)))

    def test_uniform_degree_single_bucket(self, rng):
        # uniform low degree -> exactly one static bucket, no dynamic
        from exponentialutilities_jl_tpu.ops.sell import (
            sell_pack_bucketed, sell_spmv_bucketed_ref)
        n, d, band = 3000, 6, 500
        rows, cols, vals = banded_random(rng, n, d, band)
        bk = sell_pack_bucketed((rows, cols, vals.astype(np.float32)), n)
        assert len(bk.buckets) == 1 and bk.buckets[0].uk == 1
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
        x = rng.standard_normal(n).astype(np.float32)
        y = np.asarray(sell_spmv_bucketed_ref(bk, jnp.asarray(x)))
        want = A @ x
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-5

    def test_requires_subroll_locality(self, rng):
        from exponentialutilities_jl_tpu.ops.sell import (
            sell_pack_bucketed)
        n, d, band = 4096, 7, 2500       # too wide for 1024 subwindows
        rows, cols, vals = banded_random(rng, n, d, band)
        with pytest.raises(ValueError, match="subroll"):
            sell_pack_bucketed((rows, cols, vals.astype(np.float32)), n,
                               window=4096)


class TestSegmented:
    """Lane-compacted ("segmented") SELL (VERDICT r3 #3): rows become
    ceil(deg/8)-lane segments, every group is uniform k=1 for ANY degree
    mix — the scattered-degree fix degree-SORTING cannot deliver (128
    same-class rows of a sparse class span far beyond the 1024-column
    gather window)."""

    @staticmethod
    def _scattered_mixed(rng, n, band=700):
        # the bench shape with SHUFFLED (non-clustered) degrees 6/20/40
        deg = np.full(n, 6, np.int64)
        hi = rng.permutation(n)
        deg[hi[:n // 10]] = 20
        deg[hi[n // 10:int(0.15 * n)]] = 40
        deg[hi[int(0.15 * n):int(0.15 * n) + 3]] = 0     # empty rows too
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)
        cols = np.clip(rows + rng.integers(-band // 2, band // 2,
                                           len(rows)), 0, n - 1)
        vals = rng.standard_normal(len(rows)).astype(np.float32) / 8
        return rows, cols, vals

    def test_matches_scipy_kernel_and_ref(self, rng):
        from exponentialutilities_jl_tpu.ops.sell import (
            sell_pack_seg, sell_spmv_seg_ref, sell_spmv_seg_ref)
        for n, band in ((3000, 700), (513, 64)):
            r, c, v = self._scattered_mixed(rng, n, band)
            A = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
            pk = sell_pack_seg((r, c, v), n)
            # deg-40 rows → 5-lane segments → DIRECT-sum compaction
            assert pk.base.uk == 1 and pk.base.seg == 0 and pk.lmax == 5
            x = rng.standard_normal(n).astype(np.float32)
            want = A @ x
            y = sell_spmv_seg_ref(pk, jnp.asarray(x))
            err = np.max(np.abs(np.asarray(y) - want)) / np.max(np.abs(want))
            assert err < 5e-6

    def test_long_segments_straddle_groups(self, rng):
        # rows of up to ~50 lanes, many straddling a 128-lane boundary:
        # the two-head gather (h1 + h2) must reassemble exactly
        from exponentialutilities_jl_tpu.ops.sell import (
            sell_pack_seg, sell_spmv_seg_ref)
        n = 2000
        deg = np.full(n, 4, np.int64)
        deg[::97] = 900                  # dedup brings it to ~380
        rows = np.repeat(np.arange(n), deg)
        cols = np.clip(rows + rng.integers(-200, 200, len(rows)),
                       0, n - 1)
        vals = rng.standard_normal(len(rows)).astype(np.float32) / 30
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        co = A.tocoo()
        pk = sell_pack_seg((co.row, co.col, co.data), n)
        assert pk.base.seg >= 6          # genuinely long segments
        x = rng.standard_normal(n).astype(np.float32)
        want = A @ x
        y = np.asarray(sell_spmv_seg_ref(pk, jnp.asarray(x)))
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 5e-6

    def test_span_violation_raises(self, rng):
        from exponentialutilities_jl_tpu.ops.sell import (
            sell_pack_seg)
        n = 4000
        rows = np.arange(n, dtype=np.int64)
        cols = (rows + 1500) % n          # span 1500 > 1024 window
        vals = np.ones(n, np.float32)
        with pytest.raises(ValueError, match="span"):
            sell_pack_seg((rows, cols, vals), n)

    def test_save_load_roundtrip(self, rng, tmp_path):
        from exponentialutilities_jl_tpu.ops.sell import (
            SellSeg, sell_pack_seg, sell_spmv_seg_ref)
        r, c, v = self._scattered_mixed(rng, 1500, 300)
        pk = sell_pack_seg((r, c, v), 1500)
        path = str(tmp_path / "seg.npz")
        pk.save(path)
        pk2 = SellSeg.load(path)
        x = jnp.asarray(rng.standard_normal(1500).astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(sell_spmv_seg_ref(pk, x)),
            np.asarray(sell_spmv_seg_ref(pk2, x)))

    def test_operator_mode_seg_in_expv(self, rng):
        import exponentialutilities_jl_tpu as eu
        import scipy.linalg as sla
        n = 400
        r, c, v = self._scattered_mixed(rng, n, 64)
        # symmetrize for a clean expv test
        A = sp.coo_matrix((v, (r, c)), shape=(n, n))
        A = ((A + A.T) / 2).tocoo()
        A.data = A.data.astype(np.float64) / 4
        op = eu.SellOperator.from_coo(A.row, A.col, A.data, n,
                                      mode="seg", dtype=np.float64,
                                      is_hermitian=True)
        b = rng.standard_normal(n)
        w = np.asarray(eu.expv(0.7, op, b, m=60))
        want = sla.expm(0.7 * A.toarray()) @ b
        assert np.linalg.norm(w - want) / np.linalg.norm(want) < 1e-9
        # opnorm hint is a true inf-norm bound
        hint = float(op.opnorm_hint())
        true_inf = np.max(np.abs(A.toarray()).sum(axis=1))
        assert hint >= true_inf - 1e-10
        assert hint < 2 * true_inf + 1e-10
