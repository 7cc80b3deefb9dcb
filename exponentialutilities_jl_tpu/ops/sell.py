"""SELL-window sparse packs and their SpMV.

Unstructured matrices (~10 nnz scattered per row) are packed in a
sliced-ELL, lane-major layout: rows grouped in 128s (lane l = row l of
the group); each group stores ``v = ceil(maxdeg/8)`` tiles of (8, 128),
sublane s of tile t holding slot ``8·t+s`` of every row, padded slots
carrying value 0. Column indices are stored local to an aligned
``window``-wide span of x per block of 8 groups, so the value and index
streams are contiguous (T, 8, 128) arrays of values and int32 offsets.

Pack variants (the ``mode=`` of ``SellOperator.from_coo``): the default
row-per-lane pack, ``subroll`` (one aligned 1024-column subwindow per
group), the degree-bucketed ``SellBucketed`` and the lane-compacted
``SellSeg``. Each has one SpMV, ``sell_spmv*_ref``: an XLA gather of x
at the global indices, a multiply and a segment sum.

Constraint: each 8-group block's columns must fit one aligned
``window``-wide span (default 2048). After RCM this holds for bandwidth
≲ window − 1150; wider matrices use block-ELL/banded storage. SpMV role
in the reference: outsourced to SparseArrays (src/arnoldi.jl:182).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["sell_pack", "sell_spmv_ref", "SellData",
           "SellBucketed", "sell_pack_bucketed",
           "sell_spmv_bucketed_ref",
           "SellSeg", "sell_pack_seg", "sell_spmv_seg_ref"]

_W = 1024
_LANES = 128
_SUB = 8
_GPB = 8                     # groups per block (output tile = (8, 128))


class SellData:
    """Packed SELL-window arrays (host-built, device-resident).

    vals:      (T + cap, 8, 128) values, 0 in padded slots (cap trailing
               pad tiles).
    lidx:      same shape, int32 block-window-local element indices.
    group_ptr: (G + 1,) int32 tile offsets per 128-row group.
    win_row:   (B,) int32 per-BLOCK window start (128-lane row units).
    n, nnz:    logical dimension / true nonzero count.
    win_rows:  window size in 128-lane rows (static).
    residue:   sublane ≡ window-row (mod 8) packing (static).
    cap:       max tiles per block (static).
    """

    def __init__(self, vals, lidx, group_ptr, win_row, n, nnz,
                 win_rows=_SUB * 2, mode="roll", cap=_GPB, chunks=1,
                 uniform=0, seg=0):
        self.vals = vals
        self.lidx = lidx             # (T+cap, 8, 128) int32
        self.group_ptr = group_ptr
        self.win_row = win_row       # (B,) or (B, chunks) window starts
        self.n = int(n)
        self.nnz = int(nnz)
        self.win_rows = int(win_rows)
        self.mode = str(mode)        # "roll" | "residue" | "rowsel"
                                     # | "chunked"
        self.cap = int(cap)
        self.chunks = int(chunks)    # window slabs per block (chunked)
        self.uk = int(uniform)       # >0: EVERY group has exactly uk
                                     # tiles; 0: per-group tile counts
        self.seg = int(seg)          # >0: lane-compacted pack — lanes are
                                     # ROW SEGMENTS (seg id in lidx bits
                                     # 10+); value = suffix-sum doubling
                                     # steps of the segmented lane sum

    @property
    def uniform(self):
        """Uniform-layout flag (uk >= 1: uniform-k tiles per group)."""
        return self.uk

    @property
    def residue(self):
        return self.mode == "residue"

    def tree_flatten(self):
        return ((self.vals, self.lidx, self.group_ptr, self.win_row),
                (self.n, self.nnz, self.win_rows, self.mode, self.cap,
                 self.chunks, self.uk, self.seg))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def save(self, path: str) -> None:
        """Persist the packed layout (npz). Packing 10M rows takes tens
        of seconds of host work — production serving should pack once
        and ``SellData.load`` on every restart."""
        np.savez(path, vals=np.asarray(self.vals),
                 lidx=np.asarray(self.lidx),
                 group_ptr=np.asarray(self.group_ptr),
                 win_row=np.asarray(self.win_row),
                 meta=np.asarray([self.n, self.nnz, self.win_rows,
                                  self.cap, self.chunks, self.uk,
                                  self.seg],
                                 np.int64),
                 mode=np.asarray(self.mode))

    @classmethod
    def load(cls, path: str) -> "SellData":
        import os
        if not os.path.exists(path) and not path.endswith(".npz"):
            path = path + ".npz"       # np.savez auto-appends .npz
        z = np.load(path, allow_pickle=False)
        meta = [int(v) for v in z["meta"]]
        n, nnz, win_rows, cap, chunks, uniform, seg = meta
        return cls(jnp.asarray(z["vals"]), jnp.asarray(z["lidx"]),
                   jnp.asarray(z["group_ptr"]), jnp.asarray(z["win_row"]),
                   n, nnz, win_rows=win_rows, mode=str(z["mode"]),
                   cap=cap, chunks=chunks, uniform=uniform, seg=seg)


jax.tree_util.register_pytree_node(
    SellData,
    lambda s: s.tree_flatten(),
    lambda aux, ch: SellData(ch[0], ch[1], ch[2], ch[3], aux[0], aux[1],
                             win_rows=aux[2], mode=aux[3], cap=aux[4],
                             chunks=aux[5], uniform=aux[6], seg=aux[7]),
)


def _pack_chunked(A, n: int, dtype, window: int, max_chunks: int):
    """Chunked-window packing: each 8-group block's columns are covered by
    up to ``max_chunks`` aligned ``window``-wide slabs (greedy cover);
    every TILE is chunk-pure (all its slots gather from one slab). The slab
    id rides the index high bits (li = c·8192 + local), including in
    padded slots, so a tile's slab can be read from any slot.
    """
    if window > 8192:
        raise ValueError("chunked mode needs window <= 8192 (13-bit "
                         "local indices)")
    if not 1 <= max_chunks <= 8:
        raise ValueError("max_chunks must be in 1..8 (3-bit slab ids)")
    W = window
    C = int(max_chunks)
    indptr = A.indptr.astype(np.int64)
    indices = A.indices.astype(np.int64)
    data = A.data
    nnz = A.nnz

    G = -(-n // _LANES)
    B = -(-G // _GPB)
    r_all = np.repeat(np.arange(n), np.diff(indptr))
    g_of = r_all // _LANES
    lane = r_all % _LANES

    # Greedy aligned-slab cover per block (loop is over slabs, <= C each).
    bb = indptr[np.minimum(np.arange(B + 1) * _GPB * _LANES, n)]
    span_start = np.zeros((B, C), np.int64)
    c_of = np.zeros(nnz, np.int64)
    for b in range(B):
        lo, hi = bb[b], bb[b + 1]
        if lo == hi:
            continue
        u = np.unique(indices[lo:hi])
        starts = []
        ptr = 0
        while ptr < len(u):
            if len(starts) == C:
                raise ValueError(
                    f"block {b}: columns need more than {C} "
                    f"{W}-wide slabs; raise max_chunks/window, RCM-"
                    "permute, or use block-ELL instead")
            s = (u[ptr] // _LANES) * _LANES
            starts.append(s)
            ptr = np.searchsorted(u, s + W)
        st = np.asarray(starts)
        span_start[b, :len(st)] = st
        span_start[b, len(st):] = st[-1]
        c_of[lo:hi] = np.searchsorted(st, indices[lo:hi], side="right") - 1

    # Position of each nnz within its (row, chunk) run. CSR column order
    # makes chunk ids non-decreasing within a row, so runs are contiguous.
    key = r_all * C + c_of
    if nnz:
        change = np.concatenate([[True], key[1:] != key[:-1]])
        pos = (np.arange(nnz)
               - np.maximum.accumulate(np.where(change, np.arange(nnz), 0)))
    else:
        pos = np.zeros(0, np.int64)

    # Tiles per (group, chunk): ceil(max per-row run length / 8).
    md_gc = np.zeros(G * C, np.int64)
    if nnz:
        np.maximum.at(md_gc, g_of * C + c_of, pos + 1)
    md_gc = md_gc.reshape(G, C)
    v_gc = -(-md_gc // _SUB)
    v_gc[v_gc.sum(axis=1) == 0, 0] = 1              # every group >= 1 tile
    off_gc = np.cumsum(v_gc, axis=1) - v_gc         # exclusive, within group
    v_g = v_gc.sum(axis=1)
    group_ptr = np.concatenate([[0], np.cumsum(v_g)]).astype(np.int32)
    T = int(group_ptr[-1])

    tile = group_ptr[g_of] + off_gc[g_of, c_of] + pos // _SUB
    sub = pos % _SUB

    gp_blk = group_ptr[np.minimum(np.arange(B + 1) * _GPB, G)]
    cap = max(int(np.max(np.diff(gp_blk))) if B else 1, 1)

    # Every slot of a tile (padded included) carries the tile's slab id.
    # Tiles are chunk-major within each group, so the per-tile slab id
    # sequence is repeat(c, v_gc[g, c]) in (g, c) order.
    tile_chunk = np.concatenate([
        np.repeat(np.tile(np.arange(C), G), v_gc.reshape(-1)),
        np.zeros(cap, np.int64)]).astype(np.int32)
    lidx_all = np.broadcast_to(
        (tile_chunk << 13)[:, None, None], (T + cap, _SUB, _LANES)).copy()
    vals_all = np.zeros((T + cap, _SUB, _LANES), dtype)
    li = (c_of << 13) | (indices - span_start[g_of // _GPB, c_of])
    vals_all[tile, sub, lane] = data.astype(dtype)
    lidx_all[tile, sub, lane] = li
    return SellData(jnp.asarray(vals_all), jnp.asarray(lidx_all.astype(
                        np.int32)),
                    jnp.asarray(group_ptr),
                    jnp.asarray((span_start // _LANES).astype(np.int32)),
                    n, int(nnz), win_rows=W // _LANES, mode="chunked",
                    cap=cap, chunks=C)


def _subroll_transform(lidx_all, group_ptr, g_of, indices, wsb_group,
                       wr: int):
    """Rebase indices onto per-GROUP 1024-wide 128-aligned subwindows.

    Each group then reads x only inside its own aligned (8, 128)
    subwindow. Returns the per-group window starts (128-lane
    row units, absolute), or None when some group's span does not fit
    1024 after alignment (caller falls back to plain roll)."""
    G = len(group_ptr) - 1
    cmin = np.full(G, np.iinfo(np.int64).max)
    cmax = np.full(G, -1, np.int64)
    np.minimum.at(cmin, g_of, indices)
    np.maximum.at(cmax, g_of, indices)
    empty = cmax < 0
    cmin[empty] = wsb_group[empty] if len(wsb_group) else 0
    cmax[empty] = cmin[empty]
    gwin = np.clip(cmin // _LANES, wsb_group // _LANES,
                   wsb_group // _LANES + wr - _SUB)
    if np.any(cmax >= (gwin + _SUB) * _LANES):
        return None
    # Rebase every slot to its group window (real indices are in range
    # by the check above, so the clip only catches value-0 PAD slots,
    # keeping promise_in_bounds honest).
    T = lidx_all.shape[0]
    tile_base = np.zeros(T, np.int64)
    counts = np.diff(group_ptr).astype(np.int64)
    tile_base[:group_ptr[G]] = np.repeat(
        gwin * _LANES - wsb_group, counts)
    lidx_all[:] = np.clip(lidx_all - tile_base[:, None, None], 0, _W - 1)
    return gwin.astype(np.int32)


_UK_MAX = 8          # uniform-k static unroll cap (8 gather seqs/group)
_SEG_DIRECT_MAX = 8  # seg pack: max segment length for DIRECT-sum compaction
_UK_PAD = 2.0        # auto repack only if k·G <= _UK_PAD · T (pad traffic)


def _maybe_uniform_k(va, lia, gp, mode: str, uniform_k):
    """Repack to a STATIC uniform-k schedule when profitable.

    Padding every 128-row group to exactly k = max tiles/group gives every
    group the same tile count (the d<=8 "uniform" layout generalized),
    trading zero-padded value/index traffic for per-group offsets. Auto
    policy (``uniform_k=None``): repack when
    k <= _UK_MAX and the padded tile count k·G <= _UK_PAD·T.

    Returns (va, lia, gp, cap_or_None, uk); uk=0 keeps the dynamic path,
    uk>=1 means every group holds exactly uk tiles (group g's tiles at
    [g·uk, (g+1)·uk); trailing phantom groups up to the block boundary
    are all-zero).
    """
    gp64 = np.asarray(gp, np.int64)
    G = len(gp64) - 1
    v = np.diff(gp64)
    T = int(gp64[-1])
    k = int(v.max()) if G else 1
    if k == 1 and T == G:
        return va, lia, gp, None, 1
    if mode != "subroll" or uniform_k is False:
        return va, lia, gp, None, 0
    if uniform_k and k > _UK_MAX:
        raise ValueError(
            f"uniform_k: max tiles/group {k} exceeds the static unroll "
            f"cap {_UK_MAX} — use the dynamic path (uniform_k=False)")
    if not (uniform_k or (uniform_k is None and k <= _UK_MAX
                          and k * G <= _UK_PAD * T)):
        return va, lia, gp, None, 0
    B = -(-G // _GPB)
    T2 = B * _GPB * k
    va2 = np.zeros((T2,) + va.shape[1:], va.dtype)
    li2 = np.zeros((T2,) + lia.shape[1:], np.asarray(lia).dtype)
    src = np.arange(T)
    tg = np.repeat(np.arange(G), v)
    dest = tg * k + (src - gp64[:-1][tg])
    va2[dest] = np.asarray(va)[src]
    li2[dest] = np.asarray(lia)[src]
    gp2 = (np.arange(G + 1, dtype=np.int64) * k).astype(np.int32)
    return va2, li2, gp2, _GPB * k, k


def sell_pack(rows_cols_vals, n: int, dtype=np.float32,
              window: int = 2048, residue: bool = False,
              mode: str | None = None, max_chunks: int = 4,
              uniform_k: bool | None = None) -> SellData:
    """Pack COO (rows, cols, vals) into SELL-window form (module doc).

    ``mode=None`` auto-selects: "subroll" (per-group 1024-wide
    subwindows — half the gather work of "roll") when every 128-row
    group's column span fits an aligned 1024 subwindow, else "roll".

    ``uniform_k``: uniform repack policy for subroll packings whose max
    tiles/group k exceeds 1 — pad every group to exactly k tiles.
    None (default) auto-repacks when k <= 8 and padding k·G <= 2·T;
    True forces (k <= 8 required); False keeps the dynamic path.

    Raises ValueError if any 8-group block's columns exceed its aligned
    ``window`` — RCM-permute first (the packer does not reorder), widen
    the window, or fall back to another container. Duplicate (row, col)
    entries are summed.
    """
    if window % _W:
        raise ValueError("window must be a multiple of 1024")
    auto = mode is None and not residue
    if mode is None:
        mode = "residue" if residue else "subroll"
    want_subroll = mode == "subroll"
    if want_subroll:
        mode = "roll"
    residue = mode == "residue"
    rows, cols, vals = rows_cols_vals
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=dtype)

    import scipy.sparse as sp
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A.sort_indices()
    nnz = A.nnz
    if mode == "chunked":
        return _pack_chunked(A, n, dtype, window, max_chunks)
    if mode == "rowsel":
        from ..native import sell_rowsel_pack_csr
        packed = sell_rowsel_pack_csr(A, window=window)
        if packed is None:
            raise RuntimeError(
                "rowsel packing requires the native library "
                "(exponentialutilities_jl_tpu/native)")
        va, lia, gp, wr, cap = packed
        return SellData(jnp.asarray(va.astype(dtype)), jnp.asarray(lia),
                        jnp.asarray(gp), jnp.asarray(wr), n, int(nnz),
                        win_rows=window // _LANES, mode="rowsel", cap=cap)
    if not residue:
        # Native C++ single-pass packer when available.
        try:
            from ..native import sell_pack_csr
            packed = sell_pack_csr(A, window=window)
        except ImportError:
            packed = None
        if packed is not None:
            va, lia, gp, wrow, cap = packed
            out_mode = "roll"
            if want_subroll or auto:
                ip = A.indptr.astype(np.int64)
                g_all = (np.repeat(np.arange(n), np.diff(ip))
                         // _LANES)
                Gn = len(gp) - 1
                wsb_group = (np.asarray(wrow, np.int64)[
                    np.minimum(np.arange(Gn) // _GPB, len(wrow) - 1)]
                    * _LANES)
                lia = np.ascontiguousarray(lia)
                gwin = _subroll_transform(
                    lia, np.asarray(gp, np.int64), g_all,
                    A.indices.astype(np.int64), wsb_group,
                    window // _LANES)
                if gwin is not None:
                    out_mode = "subroll"
                    wrow = gwin          # (G,) per-group window starts
                elif want_subroll and not auto:
                    raise ValueError(
                        "subroll: some 128-row group's column span "
                        "exceeds an aligned 1024 subwindow — use "
                        "mode='roll' or RCM-permute")
            va, lia, gp, ncap, uk = _maybe_uniform_k(
                va, lia, gp, out_mode, uniform_k)
            if ncap is not None:
                cap = ncap
            return SellData(jnp.asarray(va.astype(dtype)),
                            jnp.asarray(lia), jnp.asarray(gp),
                            jnp.asarray(wrow), n, int(nnz),
                            win_rows=window // _LANES, mode=out_mode,
                            cap=cap, uniform=uk)
    indptr = A.indptr.astype(np.int64)
    indices = A.indices.astype(np.int64)
    data = A.data

    G = -(-n // _LANES)
    B = -(-G // _GPB)
    n_pad = G * _LANES
    counts = np.zeros(n_pad, np.int64)
    counts[:n] = np.diff(indptr)

    # Per-BLOCK window from per-block column extrema.
    bb = indptr[np.minimum(np.arange(B) * _GPB * _LANES, n)]
    nonempty = np.diff(np.concatenate([bb, [nnz]])) > 0
    cmin = np.zeros(B, np.int64)
    cmax = np.zeros(B, np.int64)
    ne = np.flatnonzero(nonempty)
    if len(ne):
        cmin[ne] = np.minimum.reduceat(indices, bb[ne])
        cmax[ne] = np.maximum.reduceat(indices, bb[ne])
    wsb = (cmin // _LANES) * _LANES
    bad = cmax >= wsb + window
    if np.any(bad):
        blk = int(np.argmax(bad))
        raise ValueError(
            f"block {blk}: column span [{cmin[blk]}, {cmax[blk]}] exceeds "
            f"the {window}-wide window; RCM-permute, widen the window, or "
            "use block-ELL/banded instead")

    r_all = np.repeat(np.arange(n), np.diff(indptr))
    g_of = r_all // _LANES
    lane = r_all % _LANES
    li = indices - wsb[g_of // _GPB]

    if residue:
        q = li >> 7
        key = r_all * _SUB + (q & 7)
        order2 = np.argsort(key, kind="stable")
        inv = np.empty_like(order2)
        inv[order2] = np.arange(len(order2))
        ks = key[order2]
        if len(ks):
            change = np.concatenate([[True], ks[1:] != ks[:-1]])
            startpos = np.maximum.accumulate(
                np.where(change, np.arange(len(ks)), 0))
            depth = (np.arange(len(ks)) - startpos)[inv]
            vmax_g = np.zeros(G, np.int64)
            np.maximum.at(vmax_g, g_of, depth + 1)
            v = np.maximum(1, vmax_g)
        else:
            depth = r_all  # empty
            v = np.ones(G, np.int64)
        group_ptr = np.concatenate([[0], np.cumsum(v)]).astype(np.int32)
        tile = group_ptr[g_of] + depth
        sub = (q & 7)
    else:
        maxdeg = counts.reshape(G, _LANES).max(axis=1)
        v = np.maximum(1, -(-maxdeg // _SUB)).astype(np.int64)
        group_ptr = np.concatenate([[0], np.cumsum(v)]).astype(np.int32)
        i_in_row = np.arange(nnz) - indptr[r_all]
        tile = group_ptr[g_of] + i_in_row // _SUB
        sub = i_in_row % _SUB

    T = int(group_ptr[-1])
    # chunk capacity: max tiles in any 8-group block (+ trailing pad)
    gp_blk = group_ptr[np.minimum(np.arange(B + 1) * _GPB, G)]
    cap = int(np.max(np.diff(gp_blk))) if B else 1
    cap = max(cap, 1)

    vals_all = np.zeros((T + cap, _SUB, _LANES), dtype)
    lidx_all = np.zeros((T + cap, _SUB, _LANES), np.int32)
    vals_all[tile, sub, lane] = data.astype(dtype)
    lidx_all[tile, sub, lane] = li
    out_mode = "residue" if residue else "roll"
    wrow_out = (wsb // _LANES).astype(np.int32)
    if not residue and (want_subroll or auto):
        wsb_group = wsb[np.minimum(np.arange(G) // _GPB, B - 1)]
        gwin = _subroll_transform(lidx_all, group_ptr.astype(np.int64),
                                  g_of, indices, wsb_group,
                                  window // _LANES)
        if gwin is not None:
            out_mode = "subroll"
            wrow_out = gwin              # (G,) per-group window starts
        elif want_subroll and not auto:
            raise ValueError(
                "subroll: some 128-row group's column span exceeds an "
                "aligned 1024 subwindow — use mode='roll' or RCM-permute")
    vals_all, lidx_all, group_ptr, ncap, uk = _maybe_uniform_k(
        vals_all, lidx_all, group_ptr, out_mode, uniform_k)
    if ncap is not None:
        cap = ncap
    return SellData(jnp.asarray(vals_all), jnp.asarray(lidx_all),
                    jnp.asarray(group_ptr),
                    jnp.asarray(wrow_out),
                    n, int(nnz), win_rows=window // _LANES,
                    mode=out_mode, cap=cap, uniform=uk)


def _ref_group_rows(data: SellData, x_pad):
    """Pure-XLA per-group row results (G, 128) given the FULL padded x.
    Shared by ``sell_spmv_ref`` and the bucketed reference path (whose
    per-bucket SellData index into the full vector)."""
    G = data.group_ptr.shape[0] - 1
    T = data.vals.shape[0]
    tile_group = jnp.searchsorted(data.group_ptr[1:], jnp.arange(T),
                                  side="right")
    tile_group = jnp.minimum(tile_group, G - 1)      # trailing pad tiles
    if data.mode == "chunked":
        # per-slot slab id rides bits 13+; win_row is (B, chunks).
        wr2 = data.win_row.reshape(-1, data.chunks)
        blk = jnp.minimum(tile_group // _GPB, wr2.shape[0] - 1)
        ws = wr2[blk[:, None, None], data.lidx >> 13] * _LANES
        gidx = (data.lidx & 0x1FFF) + ws
    elif data.mode == "subroll":
        # win_row is per-GROUP: indices are group-subwindow-local
        ws = data.win_row[tile_group] * _LANES
        gidx = data.lidx + ws[:, None, None]
    else:
        ws = data.win_row[jnp.minimum(tile_group // _GPB,
                                      data.win_row.shape[0] - 1)] * _LANES
        # lidx is the block-window-local element index in BOTH packings
        # (residue only constrains WHICH sublane a slot uses).
        gidx = data.lidx + ws[:, None, None]
    gx = x_pad[gidx]
    contrib = jnp.sum(data.vals * gx, axis=1)
    return jax.ops.segment_sum(contrib, tile_group, num_segments=G)


@jax.jit
def sell_spmv_ref(data: SellData, x):
    """y = A @ x for a SELL-window pack: gather x at the global indices,
    multiply, and segment-sum per 128-row group."""
    n = data.n
    G = data.group_ptr.shape[0] - 1
    x_pad = jnp.pad(x, (0, G * _LANES - n + data.win_rows * _LANES))
    y = _ref_group_rows(data, x_pad)
    return y.reshape(-1)[:n]


class SellBucketed:
    """Degree-bucketed SELL-window pack (round 3, STATUS gap #1).

    Mixed-degree matrices waste the single uniform-k layout: padding
    EVERY 128-row group to k = max tiles/group costs k·G tile traffic,
    so ``_maybe_uniform_k`` bails past 2× padding. In subroll mode each
    128-row group carries its OWN window start, so groups are freely
    reorderable: this container sorts groups by their tile count k into
    one class per k ≤ 8 (ZERO padding within a class), routes k > 8
    groups to one residual bucket, and reassembles y with a single
    group-granular gather.

    buckets:   per-class SellData, each over its own rows but indexing
               the FULL x (win_row stays absolute).
    group_src: (G,) int32 — concat-output row block (128-row group)
               holding original group g (inverse of the class sort).

    Reference context: the SpMV is THE device operation of the Krylov
    stack (reference src/arnoldi.jl:182); SELL-C-σ-style degree sorting
    is the standard fix for mixed-degree ELL storage — here it sorts
    GROUPS (not rows), which preserves every per-group subwindow.
    """

    def __init__(self, buckets, group_src, n, nnz, win_rows=_SUB * 2):
        self.buckets = tuple(buckets)
        self.group_src = group_src
        self.n = int(n)
        self.nnz = int(nnz)
        self.win_rows = int(win_rows)

    @property
    def vals_dtype(self):
        return self.buckets[0].vals.dtype

    def tree_flatten(self):
        return ((self.buckets, self.group_src),
                (self.n, self.nnz, self.win_rows))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)

    def save(self, path: str) -> None:
        """Persist all buckets + the group permutation in one npz."""
        arrs = {"group_src": np.asarray(self.group_src),
                "meta": np.asarray([self.n, self.nnz, self.win_rows,
                                    len(self.buckets)], np.int64)}
        for i, b in enumerate(self.buckets):
            arrs[f"b{i}_vals"] = np.asarray(b.vals)
            arrs[f"b{i}_lidx"] = np.asarray(b.lidx)
            arrs[f"b{i}_group_ptr"] = np.asarray(b.group_ptr)
            arrs[f"b{i}_win_row"] = np.asarray(b.win_row)
            arrs[f"b{i}_meta"] = np.asarray(
                [b.n, b.nnz, b.win_rows, b.cap, b.chunks, b.uk],
                np.int64)
        np.savez(path, **arrs)

    @classmethod
    def load(cls, path: str) -> "SellBucketed":
        import os
        if not os.path.exists(path) and not path.endswith(".npz"):
            path = path + ".npz"
        z = np.load(path, allow_pickle=False)
        n, nnz, win_rows, nb = [int(v) for v in z["meta"]]
        buckets = []
        for i in range(nb):
            bn, bnnz, bwr, cap, chunks, uk = [
                int(v) for v in z[f"b{i}_meta"]]
            buckets.append(SellData(
                jnp.asarray(z[f"b{i}_vals"]), jnp.asarray(z[f"b{i}_lidx"]),
                jnp.asarray(z[f"b{i}_group_ptr"]),
                jnp.asarray(z[f"b{i}_win_row"]), bn, bnnz,
                win_rows=bwr, mode="subroll", cap=cap,
                chunks=chunks, uniform=uk))
        return cls(buckets, jnp.asarray(z["group_src"]), n, nnz,
                   win_rows=win_rows)


jax.tree_util.register_pytree_node(
    SellBucketed,
    lambda s: s.tree_flatten(),
    lambda aux, ch: SellBucketed(ch[0], ch[1], *aux),
)


def bucket_sell(base: SellData, kmax: int = _UK_MAX) -> SellBucketed:
    """Split a dynamic subroll SellData into per-degree-class uniform-k
    buckets (class docstring). Host-side; call once at pack time."""
    if base.mode != "subroll":
        raise ValueError(
            "bucketed packing requires subroll mode (per-group windows); "
            f"this matrix packed as '{base.mode}' — RCM-permute for "
            "locality or use roll/chunked/block-ELL instead")
    gp = np.asarray(base.group_ptr, np.int64)
    vals = np.asarray(base.vals)
    lidx = np.asarray(base.lidx)
    wrow = np.asarray(base.win_row).reshape(-1)
    G = len(gp) - 1
    v = np.diff(gp)
    pos = np.zeros(G, np.int64)
    buckets = []
    off = 0
    for k in (int(kk) for kk in np.unique(v) if kk <= kmax):
        gs = np.flatnonzero(v == k)
        Gc = len(gs)
        Bc = -(-Gc // _GPB)
        cap = _GPB * k
        tiles = (gp[gs][:, None] + np.arange(k)).reshape(-1)
        va = np.zeros((Gc * k + cap,) + vals.shape[1:], vals.dtype)
        li = np.zeros((Gc * k + cap,) + lidx.shape[1:], lidx.dtype)
        va[:Gc * k] = vals[tiles]
        li[:Gc * k] = lidx[tiles]
        gpc = (np.arange(Gc + 1, dtype=np.int64) * k).astype(np.int32)
        buckets.append(SellData(
            jnp.asarray(va), jnp.asarray(li), jnp.asarray(gpc),
            jnp.asarray(wrow[gs]), Gc * _LANES,
            int(np.count_nonzero(va)), win_rows=base.win_rows,
            mode="subroll", cap=cap, uniform=k))
        pos[gs] = off + np.arange(Gc)
        off += Bc * _GPB
    dyn = np.flatnonzero(v > kmax)
    if len(dyn):
        vd = v[dyn]
        Gd = len(dyn)
        Bd = -(-Gd // _GPB)
        gpd = np.concatenate([[0], np.cumsum(vd)])
        Td = int(gpd[-1])
        src = (np.repeat(gp[dyn], vd)
               + (np.arange(Td) - np.repeat(gpd[:-1], vd)))
        gp_blk = gpd[np.minimum(np.arange(Bd + 1) * _GPB, Gd)]
        cap = max(int(np.max(np.diff(gp_blk))), 1)
        va = np.zeros((Td + cap,) + vals.shape[1:], vals.dtype)
        li = np.zeros((Td + cap,) + lidx.shape[1:], lidx.dtype)
        va[:Td] = vals[src]
        li[:Td] = lidx[src]
        buckets.append(SellData(
            jnp.asarray(va), jnp.asarray(li),
            jnp.asarray(gpd.astype(np.int32)), jnp.asarray(wrow[dyn]),
            Gd * _LANES, int(np.count_nonzero(va)),
            win_rows=base.win_rows, mode="subroll", cap=cap, uniform=0))
        pos[dyn] = off + np.arange(Gd)
    return SellBucketed(buckets, jnp.asarray(pos.astype(np.int32)),
                        base.n, base.nnz, win_rows=base.win_rows)


def sell_pack_bucketed(rows_cols_vals, n: int, dtype=np.float32,
                       window: int = 2048,
                       kmax: int = _UK_MAX) -> SellBucketed:
    """Pack COO into the degree-bucketed SELL form (``SellBucketed``).
    Requires subroll locality (every 128-row group's column span inside
    an aligned 1024 subwindow — RCM-permute first if needed)."""
    base = sell_pack(rows_cols_vals, n, dtype=dtype, window=window,
                     mode="subroll", uniform_k=False)
    return bucket_sell(base, kmax=kmax)


@jax.jit
def sell_spmv_bucketed_ref(data: SellBucketed, x):
    """y = A @ x for the bucketed pack (XLA gather + segment sum)."""
    n = data.n
    G = data.group_src.shape[0]
    x_pad = jnp.pad(x, (0, G * _LANES - n + data.win_rows * _LANES))
    outs = []
    for b in data.buckets:
        Gc = b.group_ptr.shape[0] - 1
        Bc = -(-Gc // _GPB)
        rows = _ref_group_rows(b, x_pad)
        outs.append(jnp.pad(rows, ((0, Bc * _GPB - Gc), (0, 0))))
    ys = jnp.concatenate(outs, axis=0)
    return ys[data.group_src].reshape(-1)[:n]


# ---------------------------------------------------------------------------
# Lane-compacted ("segmented") SELL — SCATTERED-degree matrices.
#
# Degree bucketing (SellBucketed) needs the degree classes to be
# CLUSTERED in the row order: with scattered high-degree rows every
# 128-row group contains one, all groups land in the top class, and the
# per-slot padding returns. A degree-sorting row permutation cannot fix
# it either: 128 same-class rows of a 5%-density class span ~2500 rows of
# a banded matrix, far outside the pack's 1024-column subwindow.
#
# This pack dissolves the row<->lane identity instead: a row of degree d
# occupies ceil(d/8) ADJACENT LANES ("row segment") of one (8, 128)
# tile, so EVERY group is exactly one tile (zero slot padding beyond the
# <=7 tail slots of each row) for ANY degree mix, up to 1024 nnz/row.
# Groups are plain 128-lane slices of the lane sequence (rows may
# straddle a group boundary), each with its own aligned x-subwindow.
# Per-row totals are reassembled from the lane sums: DIRECT mode
# (segments <= 8 lanes, i.e. degree <= 64) sums each row's consecutive
# lane sums; longer segments use a segmented suffix sum by doubling and
# pick up one or two head lanes.
# ---------------------------------------------------------------------------


class SellSeg:
    """Lane-compacted SELL pack (see banner above).

    base:  SellData (mode="subroll", uk=1, seg=doubling steps) whose
           lanes are row segments.
    h1/h2: (n,) int32 flat lane-sum positions of each row's head lane
           and its straddle-continuation head (h2 = h1's group-boundary
           continuation, or h1 itself when unused — the flag lives in
           ``cidx``); used by the pure-XLA reference path.
    cws:   (nblk,) int32 compaction window starts (128-element rows of
           the lane-sum array) per 1024-output block.
    cidx:  (nblk, 8, 128) int32 packed compaction indices:
           rel1 | rel2 << 13 | straddle << 26 (window-relative).
    cwr:   static compaction window size in 128-element rows.
    """

    def __init__(self, base: SellData, h1, h2, cws, cidx, cwr: int,
                 lmax: int = 0):
        self.base = base
        self.h1 = h1
        self.h2 = h2
        self.cws = cws
        self.cidx = cidx
        self.cwr = int(cwr)
        self.lmax = int(lmax)    # >0: DIRECT compaction (sum lmax
                                 # consecutive lane sums per row);
                                 # 0: two-head mode (doubling pack)

    @property
    def n(self):
        return self.base.n

    @property
    def nnz(self):
        return self.base.nnz

    def tree_flatten(self):
        return ((self.base, self.h1, self.h2, self.cws, self.cidx),
                (self.cwr, self.lmax))

    def save(self, path: str) -> None:
        import os
        self.base.save(path)
        p = path if os.path.exists(path) else (
            path if path.endswith(".npz") else path + ".npz")
        with np.load(p, allow_pickle=False) as z:
            arrs = dict(z)
        arrs["h1"] = np.asarray(self.h1)
        arrs["h2"] = np.asarray(self.h2)
        arrs["cws"] = np.asarray(self.cws)
        arrs["cidx"] = np.asarray(self.cidx)
        arrs["cmeta"] = np.asarray([self.cwr, self.lmax], np.int64)
        np.savez(p, **arrs)

    @classmethod
    def load(cls, path: str) -> "SellSeg":
        import os
        p = path if os.path.exists(path) else (
            path if path.endswith(".npz") else path + ".npz")
        base = SellData.load(p)
        with np.load(p, allow_pickle=False) as z:
            h1, h2 = jnp.asarray(z["h1"]), jnp.asarray(z["h2"])
            cws, cidx = jnp.asarray(z["cws"]), jnp.asarray(z["cidx"])
            cm = [int(v) for v in z["cmeta"]]
            cwr = cm[0]
            lmax = cm[1] if len(cm) > 1 else 0
        return cls(base, h1, h2, cws, cidx, cwr, lmax)


jax.tree_util.register_pytree_node(
    SellSeg,
    lambda s: s.tree_flatten(),
    lambda aux, ch: SellSeg(*ch, *aux),
)


def sell_pack_seg(rows_cols_vals, n: int, dtype=np.float32) -> SellSeg:
    """Pack COO into the lane-compacted SELL form (class banner).

    Host-side, fully vectorized numpy. Raises when a 128-lane group's
    column span exceeds the 1024 gather window (bandwidth ≳ 900 after
    RCM → use roll/chunked/banded containers) or a row has > 1024 nnz.
    """
    import scipy.sparse as sp

    rows, cols, vals = rows_cols_vals
    A = sp.coo_matrix((np.asarray(vals, dtype),
                       (np.asarray(rows), np.asarray(cols))),
                      shape=(n, n)).tocsr()
    A.sort_indices()
    deg = np.diff(A.indptr).astype(np.int64)
    if deg.max(initial=0) > _W:
        raise ValueError(
            f"seg pack: max row degree {int(deg.max())} exceeds {_W} "
            "(a row segment must fit one 128-lane group twice over)")
    k = np.maximum(1, -(-deg // _SUB))          # lanes per row
    lane_start = np.concatenate([[0], np.cumsum(k)])
    L = int(lane_start[-1])
    G = -(-L // _LANES) + 1          # +1: guaranteed all-pad dummy group
    B = -(-G // _GPB)
    T = B * _GPB                      # uniform k=1: tiles == groups

    nnz = int(A.nnz)
    off = np.arange(nnz, dtype=np.int64) - np.repeat(A.indptr[:-1].astype(
        np.int64), deg)
    lane = np.repeat(lane_start[:-1], deg) + off // _SUB
    sub = (off % _SUB).astype(np.int64)
    g_of = lane // _LANES
    l_of = lane % _LANES

    cmin = np.full(G, np.iinfo(np.int64).max)
    cmax = np.full(G, -1, np.int64)
    idx64 = A.indices.astype(np.int64)
    np.minimum.at(cmin, g_of, idx64)
    np.maximum.at(cmax, g_of, idx64)
    emp = cmax < 0
    cmin[emp] = 0
    cmax[emp] = 0
    ws = cmin // _LANES
    if np.any(cmax >= ws * _LANES + _W):
        raise ValueError(
            "seg pack: a 128-lane group's column span exceeds the 1024 "
            "gather window — RCM-permute first, or use the roll/chunked "
            "modes / banded containers for bandwidth over ~900")

    max_seg = int(np.max(np.minimum(k, _LANES))) if n else 1
    if max_seg <= _SEG_DIRECT_MAX:
        # DIRECT mode: raw lane sums (seg = 0), then each row's ≤ Lmax
        # consecutive lane sums are added. Rows may straddle ANY
        # boundary — lanes are globally contiguous.
        steps = 0
        bits2d = None
    else:
        # DOUBLING mode (segments up to 128 lanes): segmented suffix-sum;
        # head positions compacted afterwards.
        # seg id = the row's first lane within this group (monotone +
        # unique per group); pad lanes take their own lane index.
        gl = np.arange(G * _LANES, dtype=np.int64) % _LANES
        first_lane = np.repeat(lane_start[:-1], k)          # (L,)
        grp_start = (np.arange(L, dtype=np.int64) // _LANES) * _LANES
        seg_full = gl.copy()
        seg_full[:L] = np.maximum(first_lane, grp_start) % _LANES
        ms = min(max_seg, _LANES)
        steps = 0
        while (1 << steps) < ms:
            steps += 1
        # per-step same-segment masks (lidx bit 17+st):
        # ok[l] = (l + 2^st < 128) & (seg[l] == seg[l + 2^st])
        seg2d = seg_full.reshape(G, _LANES)
        bits = np.zeros((G, _LANES), np.int64)
        for st in range(steps):
            sh = 1 << st
            ok = np.zeros((G, _LANES), bool)
            ok[:, :_LANES - sh] = seg2d[:, :_LANES - sh] == seg2d[:, sh:]
            bits |= ok.astype(np.int64) << (17 + st)
        bits2d = (seg2d << 10) | bits

    li_all = np.zeros((T, _SUB, _LANES), np.int32)
    if bits2d is not None:
        li_all[:G] = np.broadcast_to(
            bits2d[:, None, :], (G, _SUB, _LANES)).astype(np.int32)
    va = np.zeros((T, _SUB, _LANES), dtype)
    widx = (idx64 - ws[g_of] * _LANES).astype(np.int32)
    li_all[g_of, sub, l_of] |= widx
    va[g_of, sub, l_of] = A.data

    # head positions: lane-sum flat index == global lane index
    h1 = lane_start[:-1]
    last_lane = lane_start[1:] - 1
    straddle = (h1 // _LANES) != (last_lane // _LANES)
    h2 = np.where(straddle, (h1 // _LANES + 1) * _LANES, h1)

    # --- compaction plan: PER-SUBLANE lane-sum windows + packed
    # (lane, row-delta) indices (banner). 128 consecutive outputs span
    # ~128·avg_seg lane-sum positions, so each sublane needs only
    # D = ceil(span/128)+1 window rows — D lane-gathers + selects per
    # candidate instead of a full-window roll pass.
    nblk = max(1, -(-n // (_SUB * _LANES)))
    npad = nblk * _SUB * _LANES
    h1p = np.full(npad, h1[-1] if n else 0, np.int64)
    h1p[:n] = h1
    sg = np.arange(npad) // _LANES          # global sublane index
    lo = np.full(nblk * _SUB, np.iinfo(np.int64).max)
    np.minimum.at(lo, sg, h1p)
    cws = lo // _LANES
    rel1 = h1p - cws[sg] * _LANES
    if steps == 0:
        # DIRECT mode: rel0 | segment length (lanes) in bits 10..13;
        # the window must also cover each row's LAST lane
        lmax = max_seg
        lenp = np.ones(npad, np.int64)
        lenp[:n] = k
        rel_last = rel1 + lenp - 1
        D = int(rel_last.max()) // _LANES + 1
        cidx = (rel1 | (lenp << 10)) \
            .reshape(nblk, _SUB, _LANES).astype(np.int32)
    else:
        # DOUBLING mode: head + straddle-continuation head + flag
        lmax = 0
        h2p = h1p.copy()
        h2p[:n] = h2
        flagp = np.zeros(npad, bool)
        flagp[:n] = straddle
        rel2 = h2p - cws[sg] * _LANES
        D = int(max(rel1.max(), rel2.max())) // _LANES + 1
        cidx = (rel1 | (rel2 << 10) | (flagp.astype(np.int64) << 20)) \
            .reshape(nblk, _SUB, _LANES).astype(np.int32)
    if D > 8:
        raise ValueError(
            f"seg pack: 128 consecutive rows span {D * _LANES} lane-sum "
            "positions — average degree too high for the compaction "
            "window; use the bucketed/dynamic modes")
    cwr = D

    # each compaction window covers lane-sum rows [cws, cws + cwr): grow
    # the pack with empty trailing groups so the lane sums cover every
    # window
    B = max(B, -(-int(cws.max() + cwr) // _GPB))
    T2 = B * _GPB
    if T2 > T:
        va = np.concatenate(
            [va, np.zeros((T2 - T,) + va.shape[1:], va.dtype)])
        li_all = np.concatenate(
            [li_all, np.zeros((T2 - T,) + li_all.shape[1:],
                              li_all.dtype)])
    G = T2                            # empty phantom groups included

    wrow = np.zeros(B * _GPB, np.int32)
    wrow[:len(ws)] = ws.astype(np.int32)
    gp = (np.arange(G + 1, dtype=np.int64)).astype(np.int32)
    base = SellData(jnp.asarray(va), jnp.asarray(li_all),
                    jnp.asarray(gp), jnp.asarray(wrow), n, nnz,
                    win_rows=_SUB * 2, mode="subroll", cap=_GPB,
                    uniform=1, seg=steps)
    return SellSeg(base, jnp.asarray(h1.astype(np.int32)),
                   jnp.asarray(h2.astype(np.int32)),
                   jnp.asarray(cws.astype(np.int32)), jnp.asarray(cidx),
                   cwr, lmax)


@jax.jit
def sell_spmv_seg_ref(data: SellSeg, x):
    """Pure-XLA reference path (any platform): per-lane slot sums, a
    lane-axis segmented suffix-sum, then the same two-head gather."""
    base = data.base
    G = base.group_ptr.shape[0] - 1
    x_pad = jnp.pad(x, (0, G * _LANES - base.n + base.win_rows * _LANES))
    T = base.vals.shape[0]
    ws = jnp.concatenate([base.win_row.reshape(-1)[:G],
                          jnp.zeros((T - G,), jnp.int32)])
    gidx = (base.lidx & (_W - 1)) + (ws * _LANES)[:, None, None]
    lanesum = jnp.sum(base.vals * x_pad[gidx], axis=1)       # (T, 128)
    flat0 = lanesum.reshape(-1)
    if data.lmax:
        # DIRECT mode: sum each row's consecutive lane sums
        ln = data.cidx.reshape(-1)[:base.n] >> 10
        y = flat0[data.h1]
        for j in range(1, data.lmax):
            y = y + jnp.where(j < ln, flat0[jnp.minimum(
                data.h1 + j, flat0.shape[0] - 1)], 0)
        return y
    segid = (base.lidx[:, 0, :] >> 10) & (_LANES - 1)
    lane = jnp.arange(_LANES)[None, :]
    for st in range(base.seg):
        sh = 1 << st
        ok = (lane + sh < _LANES) & (segid == jnp.roll(segid, -sh, 1))
        lanesum = lanesum + jnp.where(ok, jnp.roll(lanesum, -sh, 1), 0)
    flat = lanesum.reshape(-1)
    straddle = (data.cidx.reshape(-1)[:base.n] >> 20) > 0
    return flat[data.h1] + jnp.where(straddle, flat[data.h2], 0)
