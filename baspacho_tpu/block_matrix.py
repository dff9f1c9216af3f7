"""Coalesced block-matrix layout: the factor's storage skeleton.

Vocabulary (same as the reference CoalescedBlockMatrix.h:23-37):
  * span  — an original parameter block (after reordering)
  * lump  — a supernode: a run of consecutive spans merged into one column
  * chain — one (span-rows x lump-cols) block within a column
  * board — a run of chains of one column falling in the same row-lump

Numeric data is a single flat vector: each lump-column's chains are stored
contiguously as one row-major (total-rows x lump-size) matrix. This makes a
whole column (or any row range of it) a contiguous 2-D slice — ideal for
XLA: per-lump panels are `data[off : off + rows*cols].reshape(rows, cols)`
with static offsets, and bucketed gathers of many chains become single
`take` ops.

All index arrays are host NumPy int64, built once per symbolic plan
(counterpart of /root/reference/baspacho/baspacho/CoalescedBlockMatrix.cpp).
"""

from __future__ import annotations

from typing import Union

import numpy as np

from .utils import cum_sum_vec, is_strictly_increasing

INVALID = -1


class CoalescedBlockMatrixSkel:
    """Factor skeleton.

    Storage layout: each lump-column is a panel
        [ diag block  (col_stride x col_stride) ]
        [ below block (padded_below x col_stride) ]
    at flat offset `panel_base[l]`, where col_stride >= lump width and
    padded_below >= actual below rows. With `pad_fn=None` the padding is
    zero (col_stride == width, padded_below == below rows) and the layout
    matches the reference's packed scheme (CoalescedBlockMatrix.cpp).
    With a pad function (used by the planned backend), panels are
    padded to bucket shapes so that groups of same-shape columns are
    contiguous, letting batched kernels address them with plain reshapes
    instead of gathers. Padding regions must hold zeros for factor
    correctness (Solver zeroes them defensively).
    """

    def __init__(self, span_start, lump_to_span, col_ptr, row_ind,
                 pad_fn=None):
        span_start = np.asarray(span_start, dtype=np.int64)
        lump_to_span = np.asarray(lump_to_span, dtype=np.int64)
        col_ptr = np.asarray(col_ptr, dtype=np.int64)
        row_ind = np.asarray(row_ind, dtype=np.int64)
        assert len(span_start) >= len(lump_to_span) >= 1
        assert span_start.size - 1 == lump_to_span[-1]
        assert len(col_ptr) == len(lump_to_span)
        assert is_strictly_increasing(span_start)
        assert is_strictly_increasing(lump_to_span)

        num_spans = len(span_start) - 1
        num_lumps = len(lump_to_span) - 1
        tot_size = int(span_start[-1])
        self.span_start = span_start
        self.lump_to_span = lump_to_span

        from . import native
        nat = native.try_skel_build(span_start, lump_to_span, col_ptr,
                                    row_ind)
        if nat is not None:
            self._init_from_native(nat, col_ptr, row_ind, pad_fn)
            return

        span_to_lump = np.empty(num_spans + 1, dtype=np.int64)
        span_counts = lump_to_span[1:] - lump_to_span[:-1]
        span_to_lump[:num_spans] = np.repeat(
            np.arange(num_lumps, dtype=np.int64), span_counts)
        span_to_lump[num_spans] = num_lumps
        self.span_to_lump = span_to_lump
        lump_start = np.empty(num_lumps + 1, dtype=np.int64)
        lump_start[:num_lumps] = span_start[lump_to_span[:num_lumps]]
        lump_start[num_lumps] = tot_size
        self.lump_start = lump_start
        span_offset_in_lump = np.zeros(num_spans + 1, dtype=np.int64)
        span_offset_in_lump[:num_spans] = (
            span_start[:num_spans] - lump_start[span_to_lump[:num_spans]])
        self.span_offset_in_lump = span_offset_in_lump

        span_size = span_start[1:] - span_start[:-1]
        lump_size = lump_start[1:] - lump_start[:-1]

        # validate (vectorized): rows strictly increase within each column
        # and each column starts with its full diagonal block
        col_len = col_ptr[1:] - col_ptr[:-1]
        if len(row_ind) > 1:
            inc = np.diff(row_ind) > 0
            boundary = np.zeros(len(row_ind) - 1, dtype=bool)
            b = col_ptr[1:-1] - 1
            boundary[b[(b >= 0) & (b < len(boundary))]] = True
            assert np.all(inc | boundary)
        assert np.all(col_len >= span_counts)
        assert np.all(row_ind[col_ptr[:-1]] == lump_to_span[:-1])
        assert np.all(row_ind[col_ptr[:-1] + span_counts - 1] ==
                      lump_to_span[1:] - 1)

        # chains (column-ordered)
        self.chain_col_ptr = col_ptr.copy()
        self.chain_row_span = row_ind.copy()
        chain_col = np.repeat(np.arange(num_lumps, dtype=np.int64),
                              col_ptr[1:] - col_ptr[:-1])
        # rows of the column consumed after each chain (reset per column)
        rows_cum = np.cumsum(span_size[row_ind])
        ex_cum = rows_cum - span_size[row_ind]  # exclusive cumsum
        col_base = np.repeat(ex_cum[col_ptr[:-1]] if len(row_ind)
                             else np.empty(0, np.int64),
                             col_ptr[1:] - col_ptr[:-1])
        self.chain_rows_till_end = rows_cum - col_base

        # per-column rows & padded panel geometry
        total_rows = np.zeros(num_lumps, dtype=np.int64)
        nonempty = col_ptr[1:] > col_ptr[:-1]
        total_rows[nonempty] = self.chain_rows_till_end[
            col_ptr[1:][nonempty] - 1]
        below_rows = total_rows - lump_size
        if pad_fn is None:
            col_stride = lump_size.copy()
            padded_below = below_rows.copy()
        else:
            padded_below, col_stride = pad_fn(below_rows, lump_size)
            padded_below = np.asarray(padded_below, dtype=np.int64)
            col_stride = np.asarray(col_stride, dtype=np.int64)
            assert np.all(col_stride >= lump_size)
            assert np.all(padded_below >= below_rows)
        self.col_stride = col_stride
        self.padded_below = padded_below
        self.below_rows = below_rows
        panel_len = (col_stride + padded_below) * col_stride
        panel_base = np.zeros(num_lumps + 1, dtype=np.int64)
        np.cumsum(panel_len, out=panel_base[1:])
        self.panel_base = panel_base

        # chain data offsets inside padded panels: a chain starting at
        # logical column row r sits at panel_base + r' * col_stride where
        # r' = r for diagonal chains and col_stride + (r - width) below
        row_start = self.chain_rows_till_end - span_size[row_ind]
        is_diag = row_start < lump_size[chain_col]
        prow = np.where(is_diag, row_start,
                        col_stride[chain_col] + row_start -
                        lump_size[chain_col])
        chain_data = np.empty(len(row_ind) + 1, dtype=np.int64)
        chain_data[:-1] = panel_base[chain_col] + \
            prow * col_stride[chain_col]
        chain_data[-1] = panel_base[-1]
        self.chain_data = chain_data

        # boards: runs of chains with the same row-lump, per column, with a
        # terminating sentinel per column (vectorized: every column is
        # nonempty — diagonal chains are mandatory — so the k-th run start
        # globally lands at flat board position k + its column index, each
        # earlier column contributing exactly one sentinel)
        rl_all = span_to_lump[row_ind]
        is_start = np.zeros(len(row_ind), dtype=bool)
        if len(row_ind):
            is_start[col_ptr[:-1]] = True
            is_start[1:] |= rl_all[1:] != rl_all[:-1]
        starts = np.nonzero(is_start)[0]
        start_col = chain_col[starts]
        nboards = len(starts) + num_lumps  # + one sentinel per column
        board_row_lump = np.full(nboards, INVALID, dtype=np.int64)
        board_chain_col_ord = np.empty(nboards, dtype=np.int64)
        pos = np.arange(len(starts)) + start_col
        board_row_lump[pos] = rl_all[starts]
        board_chain_col_ord[pos] = starts - col_ptr[start_col]
        starts_per_col = np.bincount(start_col, minlength=num_lumps)
        board_col_ptr = cum_sum_vec(starts_per_col + 1)
        board_chain_col_ord[board_col_ptr[1:] - 1] = col_len
        self.board_col_ptr = board_col_ptr
        self.board_row_lump = board_row_lump
        self.board_chain_col_ord = board_chain_col_ord

        # row-ordered boards: for each row-lump, the (col-lump, ord-in-col)
        # of every board in that row, sorted by column
        colof = np.repeat(np.arange(num_lumps, dtype=np.int64),
                          np.diff(board_col_ptr))
        within = np.arange(nboards) - board_col_ptr[colof]
        sel = board_row_lump != INVALID
        b_rows = board_row_lump[sel]
        b_cols = colof[sel]
        b_ords = within[sel]
        order_ = np.argsort(b_rows, kind="stable")
        self.board_row_ptr = cum_sum_vec(np.bincount(b_rows, minlength=num_lumps))
        self.board_col_lump = b_cols[order_]
        self.board_col_ord = b_ords[order_]

    def _init_from_native(self, nat, col_ptr, row_ind, pad_fn):
        """Finish construction from the C++ phase-1 arrays
        (native/symbolic.cpp bs_skel_build): apply the padding policy,
        compute panel geometry, and fetch chain offsets (phase 2)."""
        from . import native
        self.span_to_lump = nat["span_to_lump"]
        self.lump_start = nat["lump_start"]
        self.span_offset_in_lump = nat["span_offset_in_lump"]
        self.chain_col_ptr = col_ptr.copy()
        self.chain_row_span = row_ind.copy()
        self.chain_rows_till_end = nat["chain_rows_till_end"]
        self.board_col_ptr = nat["board_col_ptr"]
        self.board_row_lump = nat["board_row_lump"]
        self.board_chain_col_ord = nat["board_chain_col_ord"]
        self.board_row_ptr = nat["board_row_ptr"]
        self.board_col_lump = nat["board_col_lump"]
        self.board_col_ord = nat["board_col_ord"]

        lump_size = self.lump_start[1:] - self.lump_start[:-1]
        below_rows = nat["below_rows"]
        if pad_fn is None:
            col_stride = lump_size.copy()
            padded_below = below_rows.copy()
        else:
            padded_below, col_stride = pad_fn(below_rows, lump_size)
            padded_below = np.asarray(padded_below, dtype=np.int64)
            col_stride = np.asarray(col_stride, dtype=np.int64)
            assert np.all(col_stride >= lump_size)
            assert np.all(padded_below >= below_rows)
        self.col_stride = col_stride
        self.padded_below = padded_below
        self.below_rows = below_rows
        panel_len = (col_stride + padded_below) * col_stride
        panel_base = np.zeros(len(lump_size) + 1, dtype=np.int64)
        np.cumsum(panel_len, out=panel_base[1:])
        self.panel_base = panel_base
        self.chain_data = native.try_skel_chain_data(
            self.span_start, self.lump_start, col_ptr, row_ind,
            self.chain_rows_till_end, col_stride, panel_base)
        assert self.chain_data is not None

    # ------------------------------------------------------------------
    @property
    def num_spans(self) -> int:
        return len(self.span_start) - 1

    @property
    def num_lumps(self) -> int:
        return len(self.lump_start) - 1

    @property
    def order(self) -> int:
        return int(self.span_start[-1])

    @property
    def data_size(self) -> int:
        return int(self.chain_data[-1])

    def span_vector_offset(self, span: int) -> int:
        return int(self.span_start[span])

    def span_matrix_offset(self, span: int) -> int:
        lump = int(self.span_to_lump[span])
        assert self.span_offset_in_lump[span] == 0
        return int(self.chain_data[self.chain_col_ptr[lump]])

    # ------------------------------------------------------------------
    def densify(self, data, fill_upper_half: bool = False,
                start_span_index: int = 0) -> np.ndarray:
        """Expand flat factor data to a dense (numpy) matrix; lower half
        filled, optionally mirrored. `start_span_index` (on a lump boundary)
        selects the bottom-right corner."""
        data = np.asarray(data)
        assert data.shape == (self.data_size,)
        assert self.span_offset_in_lump[start_span_index] == 0
        start_lump = int(self.span_to_lump[start_span_index])
        offset = int(self.span_start[start_span_index])
        tot = self.order - offset
        dense = np.zeros((tot, tot), dtype=data.dtype)
        for a in range(start_lump, self.num_lumps):
            l_begin = int(self.lump_start[a])
            l_size = int(self.lump_start[a + 1]) - l_begin
            stride = int(self.col_stride[a])
            for i in range(int(self.chain_col_ptr[a]),
                           int(self.chain_col_ptr[a + 1])):
                p = int(self.chain_row_span[i])
                p_start = int(self.span_start[p])
                p_size = int(self.span_start[p + 1]) - p_start
                ptr = int(self.chain_data[i])
                idx = ptr + np.arange(p_size)[:, None] * stride + \
                    np.arange(l_size)[None, :]
                dense[p_start - offset:p_start - offset + p_size,
                      l_begin - offset:l_begin - offset + l_size] = data[idx]
        if fill_upper_half:
            iu = np.triu_indices(tot, k=1)
            dense[iu] = dense.T[iu]
        return dense

    def damp(self, data, alpha: float, beta: float):
        """diag *= (1 + alpha); diag += beta. Works on numpy arrays
        (in-place-style, returns new array for jnp compatibility)."""
        idx = self.damp_indices()
        if hasattr(data, "at"):  # jax array
            return data.at[idx].mul(1.0 + alpha).at[idx].add(beta)
        out = np.array(data)
        out[idx] = out[idx] * (1.0 + alpha) + beta
        return out

    def damp_indices(self) -> np.ndarray:
        """Flat-data indices of all diagonal elements of the matrix."""
        nl = self.num_lumps
        size = self.lump_start[1:] - self.lump_start[:-1]
        tot = int(size.sum())
        lump_of = np.repeat(np.arange(nl, dtype=np.int64), size)
        within = np.arange(tot, dtype=np.int64) - \
            np.repeat(self.lump_start[:-1], size)
        return self.panel_base[lump_of] + \
            within * (self.col_stride[lump_of] + 1)

    def data_coords(self) -> tuple:
        """Per-flat-data-slot matrix coordinates (row, col) of the LOWER
        half entries; slots that are padding or upper-triangle parts of
        diagonal blocks map to the sentinel (order, order). Feeds the
        differentiable-solve VJP (Solver.make_differentiable_solve)."""
        n = self.order
        ri = np.full(self.data_size, n, dtype=np.int64)
        ci = np.full(self.data_size, n, dtype=np.int64)
        span_size = self.span_start[1:] - self.span_start[:-1]
        lump_size = self.lump_start[1:] - self.lump_start[:-1]
        for l in range(self.num_lumps):
            w = int(lump_size[l])
            st = int(self.col_stride[l])
            c0 = int(self.lump_start[l])
            for cix in range(int(self.chain_col_ptr[l]),
                             int(self.chain_col_ptr[l + 1])):
                s = int(self.chain_row_span[cix])
                nr = int(span_size[s])
                r0 = int(self.span_start[s])
                off = int(self.chain_data[cix])
                rr = r0 + np.arange(nr)[:, None]
                cc = c0 + np.arange(w)[None, :]
                keep = rr >= cc  # lower half only
                slots = off + np.arange(nr)[:, None] * st + np.arange(w)
                ri[slots[keep]] = np.broadcast_to(rr, slots.shape)[keep]
                ci[slots[keep]] = np.broadcast_to(cc, slots.shape)[keep]
        return ri, ci

    def padding_mask(self) -> np.ndarray:
        """0/1 mask over flat data: 1 at real positions, 0 at padding.
        All-ones when the layout is unpadded. Vectorized as run
        boundaries + cumsum: every real row of every panel is one
        contiguous run of `width` elements."""
        lump_size = self.lump_start[1:] - self.lump_start[:-1]
        nl = self.num_lumps

        def row_starts(row0, nrows):
            tot = int(nrows.sum())
            lump_of = np.repeat(np.arange(nl, dtype=np.int64), nrows)
            csum = np.concatenate([[0], np.cumsum(nrows)[:-1]])
            within = np.arange(tot, dtype=np.int64) - \
                np.repeat(csum, nrows)
            return self.panel_base[lump_of] + \
                (row0[lump_of] + within) * self.col_stride[lump_of], lump_of

        z = np.zeros(nl, dtype=np.int64)
        s1, l1 = row_starts(z, lump_size)                    # diag rows
        s2, l2 = row_starts(self.col_stride, self.below_rows)  # below rows
        starts = np.concatenate([s1, s2])
        widths = np.concatenate([lump_size[l1], lump_size[l2]])
        delta = np.zeros(self.data_size + 1, dtype=np.int32)
        np.add.at(delta, starts, 1)
        np.add.at(delta, starts + widths, -1)
        return (np.cumsum(delta[:-1]) > 0).astype(np.int8)
