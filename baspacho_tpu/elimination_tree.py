"""Elimination tree analysis: sparse-elim-range detection + supernode merge.

Host-side planner with behavior parity with the reference EliminationTree
(/root/reference/baspacho/baspacho/EliminationTree.{h,cpp}):

1. Build the elimination tree of the (reordered) block pattern, with
   per-node row statistics and linear cost accumulators.
2. Detect "sparse elimination ranges": large sets of same-height small
   nodes that are eliminated in one massively-parallel step (here: one
   batched op over all nodes of the range) while skipping node-merge
   fill. Heuristic constants match the reference (max node size 12, min 50
   nodes, skip when >1/3 of candidates merge easily).
3. Greedy child->parent supernode merging on the remaining tree, accepting
   a merge when the computation model predicts the merged node's potrf +
   trsm + syge + assembly time beats the two separate nodes'. The default
   model makes merges more aggressive than a CPU model (launch overhead
   dominates small ops, and uniform large panels feed the matmul units).

Everything here is NumPy/Python on host, run once per sparsity pattern.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence

import numpy as np

from .computation_model import ComputationModel, model_default
from .sparse_structure import SparseStructure
from .utils import cum_sum_vec

MAX_SPARSE_ELIM_NODE_SIZE = 12
MIN_NUM_SPARSE_ELIM_NODES = 50

# Cap on merged supernode width. Wide supernodes are handled by the
# planned backend's blocked in-graph factorization (256-panel
# potrf/trsm/syrk loop), so the cap is generous — it only bounds the
# worst-case O(w^2) panel memory of a single column.
MAX_SUPERNODE_SIZE = 4096


class EliminationTree:
    def __init__(self, param_size: Sequence[int], ss: SparseStructure,
                 comp_model: Optional[ComputationModel] = None):
        self.param_size = np.asarray(param_size, dtype=np.int64)
        self.ss = ss
        self.comp_model = comp_model or model_default
        assert len(self.param_size) == ss.order

    # ------------------------------------------------------------------
    def build_tree(self) -> None:
        """Elimination tree + per-column/row statistics.

        Vectorized formulation: compute the full symbolic fill once (C++
        fast path when built), then read everything off the filled CSC —
        the etree parent is each column's first off-diagonal row, and all
        the syge/asmbl linear cost accumulators are per-column suffix
        cumsums evaluated with array ops.
        """
        ord_ = self.ss.order
        cm = self.comp_model
        psize = self.param_size

        filled = self.ss.add_full_elimination_fill()
        csc = filled.transpose()  # per column: rows >= col, sorted
        tptr, rows = csc.ptrs, csc.inds
        col_len = tptr[1:] - tptr[:-1]
        col_of = np.repeat(np.arange(ord_, dtype=np.int64), col_len)

        parent = np.full(ord_, -1, dtype=np.int64)
        has_below = col_len > 1
        parent[has_below] = rows[tptr[:-1][has_below] + 1]

        psz_r = psize[rows]
        incl = np.cumsum(psz_r)
        col_end_incl = incl[tptr[1:] - 1]
        skipped_rows = col_end_incl[col_of] - incl  # suffix sums per column
        pos_in_col = np.arange(len(rows)) - tptr[:-1][col_of]
        skipped_blocks = (col_len[col_of] - 1) - pos_in_col

        self.parent = parent
        self.node_size = psize.copy()
        self.node_rows = col_end_incl - psz_r[tptr[:-1]] - \
            (incl[tptr[:-1]] - psz_r[tptr[:-1]])
        self.node_row_blocks = col_len - 1

        # per-row stats ([col, r_blocks, rows, r_blocks_down, rows_down]
        # sorted by col) feed only the merge loop: the native path builds
        # them in C++ from the filled CSC; the Python fallback builds them
        # lazily via _build_per_row_stats()
        self._csc_ptrs = tptr
        self._csc_rows = rows
        self._entry_stats = (col_of, psz_r, skipped_blocks, skipped_rows)
        self.per_row_stats = None
        self._compute_cost_accumulators()

    def _compute_cost_accumulators(self) -> None:
        """Linear-in-width cost accumulators per column under the current
        computation model (vectorized syge_lin_est/asmbl_lin_est over all
        filled entries + per-column sums). Model-dependent but cheap —
        `remerge` recomputes them without redoing the symbolic fill."""
        cm = self.comp_model
        col_of, psz_r, skipped_blocks, skipped_rows = self._entry_stats
        sp, ap = cm.syge_params, cm.asmbl_params
        m = skipped_rows + psz_r
        u, v = m + psz_r, m * psz_r
        syge0 = sp[0] + u * sp[1] + v * sp[2]
        syge1 = sp[3] + u * sp[4] + v * sp[5]
        br = skipped_blocks + 1
        asmbl0 = ap[0] + br * ap[1]
        asmbl1 = ap[2] + br * ap[3]
        nseg = self.ss.order
        self.syge_costs = np.stack([
            np.bincount(col_of, weights=syge0, minlength=nseg),
            np.bincount(col_of, weights=syge1, minlength=nseg)], axis=1)
        self.asmbl_costs = np.stack([
            np.bincount(col_of, weights=asmbl0, minlength=nseg),
            np.bincount(col_of, weights=asmbl1, minlength=nseg)], axis=1)

    def _build_per_row_stats(self) -> None:
        if self.per_row_stats is not None:
            return
        rows = self._csc_rows
        col_of, psz_r, skipped_blocks, skipped_rows = self._entry_stats
        order = np.argsort(rows, kind="stable")
        per_row_stats: List[List[list]] = [[] for _ in range(self.ss.order)]
        for e in order:
            per_row_stats[rows[e]].append(
                [int(col_of[e]), 1, int(psz_r[e]),
                 int(skipped_blocks[e]), int(skipped_rows[e])])
        self.per_row_stats = per_row_stats

    # ------------------------------------------------------------------
    def compute_node_heights(self, no_cross_points: Sequence[int]) -> None:
        ord_ = self.ss.order
        self.forbid_merge = np.zeros(ord_, dtype=bool)
        height = np.zeros(ord_, dtype=np.int64)
        # (height, size, node), sorted within each no-cross segment
        unmerged: List[tuple] = [None] * ord_
        bounds = [0, *list(no_cross_points), ord_]
        for ri in range(len(bounds) - 1):
            r0, r1 = bounds[ri], bounds[ri + 1]
            for k in range(r0, r1):
                unmerged[k] = (int(height[k]), int(self.node_size[k]), k)
                par = int(self.parent[k])
                if par == -1:
                    continue
                if par >= r1:
                    self.forbid_merge[k] = True
                height[par] = max(height[par], height[k] + 1)
            unmerged[r0:r1] = sorted(unmerged[r0:r1])
        self.unmerged_height_node = unmerged

    # ------------------------------------------------------------------
    def compute_sparse_elim_ranges(self, no_cross_points: Sequence[int]) -> None:
        ord_ = self.ss.order
        ranges = [0]
        bounds = [0, *list(no_cross_points), ord_]
        stop = False
        for ri in range(len(bounds) - 1):
            if stop:
                break
            r0, r1 = bounds[ri], bounds[ri + 1]
            k0 = r0
            while k0 < r1:
                k1 = k0
                merge_height = self.unmerged_height_node[k0][0]
                num_easy_merge = 0
                while (k1 < r1 and
                       self.unmerged_height_node[k1][0] == merge_height and
                       self.unmerged_height_node[k1][1] <= MAX_SPARSE_ELIM_NODE_SIZE):
                    node = self.unmerged_height_node[k1][2]
                    p = int(self.parent[node])
                    if p >= 0:
                        fill_after = self.node_rows[node] / (
                            self.node_rows[p] + self.node_size[p])
                        if fill_after > 0.8:
                            num_easy_merge += 1
                    k1 += 1
                if (k1 - k0) < MIN_NUM_SPARSE_ELIM_NODES or \
                        (k1 - k0) < num_easy_merge * 3:
                    stop = True
                    break
                for k in range(k0, k1):
                    self.forbid_merge[self.unmerged_height_node[k][2]] = True
                ranges.append(k1)
                k0 = k1
        if len(ranges) == 1:
            ranges.pop()
        self.sparse_elim_ranges = ranges

    # ------------------------------------------------------------------
    def compute_merges(self) -> None:
        ord_ = self.ss.order
        cm = self.comp_model

        from . import native
        res = native.try_compute_merges(
            self._csc_ptrs, self._csc_rows, self.param_size, self.parent,
            self.node_size, self.node_rows, self.node_row_blocks,
            self.forbid_merge, self.syge_costs, self.asmbl_costs, cm,
            MAX_SUPERNODE_SIZE)
        if res is not None:
            (self.merge_with, self.num_merged_nodes, self.num_merges,
             self.syge_costs, self.asmbl_costs) = res
            return

        self._build_per_row_stats()
        self.num_merged_nodes = np.ones(ord_, dtype=np.int64)
        self.merge_with = np.full(ord_, -1, dtype=np.int64)
        self.num_merges = 0
        node_rows, node_size = self.node_rows, self.node_size
        node_row_blocks = self.node_row_blocks

        # scalar-inlined cost models (hot loop: ~1e6 evaluations)
        sp0, sp1, sp2, sp3, sp4, sp5 = (float(x) for x in cm.syge_params)
        ap0, ap1, ap2, ap3 = (float(x) for x in cm.asmbl_params)
        pp0, pp1, pp2, pp3 = (float(x) for x in cm.potrf_params)
        tp0, tp1, tp2, tp3, tp4, tp5 = (float(x) for x in cm.trsm_params)

        def syge_lin(m, n):
            u, v = m + n, m * n
            return (sp0 + u * sp1 + v * sp2, sp3 + u * sp4 + v * sp5)

        def asmbl_lin(br):
            return (ap0 + br * ap1, ap2 + br * ap3)

        def potrf(n):
            return pp0 + n * (pp1 + n * (pp2 + n * pp3))

        def trsm(n, k):
            return tp0 + n * (tp1 + n * tp2) + k * (tp3 + n * (tp4 + n * tp5))

        def pick_score(k, p):
            return node_rows[k] / (node_rows[p] + node_size[p])

        # cost accumulators as scalar pairs
        syge_costs = [(float(a), float(b)) for a, b in self.syge_costs]
        asmbl_costs = [(float(a), float(b)) for a, b in self.asmbl_costs]

        heap = []
        for k in range(ord_ - 1, -1, -1):
            if self.forbid_merge[k]:
                continue
            p = int(self.parent[k])
            if p == -1:
                continue
            heap.append((-pick_score(k, p), -k, -p))
        heapq.heapify(heap)

        per_row_stats = self.per_row_stats
        merge_with = self.merge_with
        num_merged = self.num_merged_nodes

        while heap:
            ns, nk, np_ = heapq.heappop(heap)
            k, p = -nk, -np_
            old_p = p
            while merge_with[p] != -1:
                p = int(merge_with[p])
            if old_p != p:  # stale: parent got merged, re-score
                heapq.heappush(heap, (-pick_score(k, p), -k, -p))
                continue

            sk, rk = float(node_size[k]), float(node_rows[k])
            sp_, rp = float(node_size[p]), float(node_rows[p])
            sm = sp_ + sk
            if sm > MAX_SUPERNODE_SIZE:
                continue
            sgk, sgp = syge_costs[k], syge_costs[p]
            ask, asp = asmbl_costs[k], asmbl_costs[p]
            t_k = (potrf(sk) + trsm(sk, rk) + sgk[0] + sgk[1] * sk +
                   ask[0] + ask[1] * num_merged[k])
            t_p = (potrf(sp_) + trsm(sp_, rp) + sgp[0] + sgp[1] * sp_ +
                   asp[0] + asp[1] * num_merged[p])
            t_m = (potrf(sm) + trsm(sm, rp) + sgp[0] + sgp[1] * sm +
                   asp[0] +
                   asp[1] * (num_merged[k] + num_merged[p]))
            if not (t_m < t_k + t_p):
                continue

            prev_size_p = int(node_size[p])
            prev_merged_p = int(num_merged[p])
            merge_with[k] = p
            node_size[p] += node_size[k]
            num_merged[p] += num_merged[k]
            self.num_merges += 1

            # merge row-stat lists of k and p; where both appear in the same
            # column, the two row-blocks become one taller block — update
            # that column's syge/asmbl accumulated costs incrementally
            k_rd, p_rd = per_row_stats[k], per_row_stats[p]
            merged = []
            ik = ip = 0
            nk_, np2 = len(k_rd), len(p_rd)
            while ik < nk_ or ip < np2:
                if ip >= np2 or (ik < nk_ and k_rd[ik][0] < p_rd[ip][0]):
                    if k_rd[ik][0] != k:
                        merged.append(k_rd[ik])
                    ik += 1
                elif ik >= nk_ or k_rd[ik][0] > p_rd[ip][0]:
                    if p_rd[ip][0] != p:
                        merged.append(p_rd[ip])
                    ip += 1
                else:
                    c, kb, kr, kbd, krd = k_rd[ik]
                    _, pb, pr, pbd, prd = p_rd[ip]
                    s0, s1 = syge_costs[c]
                    a0, a1 = asmbl_costs[c]
                    d = syge_lin(krd + kr, kr)
                    s0 -= d[0]; s1 -= d[1]
                    d = asmbl_lin(kbd + kb)
                    a0 -= d[0]; a1 -= d[1]
                    d = syge_lin(prd + pr, pr)
                    s0 -= d[0]; s1 -= d[1]
                    d = asmbl_lin(pbd + pb)
                    a0 -= d[0]; a1 -= d[1]
                    d = syge_lin(prd + kr + pr, kr + pr)
                    s0 += d[0]; s1 += d[1]
                    d = asmbl_lin(pbd + kb + pb)
                    a0 += d[0]; a1 += d[1]
                    syge_costs[c] = (s0, s1)
                    asmbl_costs[c] = (a0, a1)
                    merged.append([c, kb + pb, kr + pr, pbd, prd])
                    ik += 1
                    ip += 1
            s0, s1 = syge_costs[p]
            a0, a1 = asmbl_costs[p]
            d = syge_lin(float(node_rows[p]) + prev_size_p, prev_size_p)
            s0 -= d[0]; s1 -= d[1]
            d = asmbl_lin(float(node_row_blocks[p]) + prev_merged_p)
            a0 -= d[0]; a1 -= d[1]
            d = syge_lin(float(node_rows[p] + node_size[p]),
                         float(node_size[p]))
            s0 += d[0]; s1 += d[1]
            d = asmbl_lin(float(node_row_blocks[p] + num_merged[p]))
            a0 += d[0]; a1 += d[1]
            syge_costs[p] = (s0, s1)
            asmbl_costs[p] = (a0, a1)
            merged.append([p, int(num_merged[p]), int(node_size[p]),
                           int(node_row_blocks[p]), int(node_rows[p])])
            per_row_stats[p] = merged
        self.syge_costs = np.array(syge_costs)
        self.asmbl_costs = np.array(asmbl_costs)

    # ------------------------------------------------------------------
    def collapse_merge_pointers(self) -> None:
        mw = self.merge_with
        for k in range(len(mw) - 1, -1, -1):
            p = mw[k]
            if p != -1 and mw[p] != -1:
                mw[k] = mw[p]

    # ------------------------------------------------------------------
    def process_tree(self, detect_sparse_elim_ranges: bool,
                     no_cross_points: Sequence[int] = (),
                     find_only_elims: bool = False) -> None:
        ord_ = self.ss.order
        self.compute_node_heights(no_cross_points)
        if detect_sparse_elim_ranges:
            self.compute_sparse_elim_ranges(no_cross_points)
        else:
            self.sparse_elim_ranges = []
        if find_only_elims:
            self.merge_with = np.full(ord_, -1, dtype=np.int64)
            self.num_merged_nodes = np.ones(ord_, dtype=np.int64)
            self.num_merges = 0
        else:
            self.compute_merges()
            self.collapse_merge_pointers()

        num_lumps = ord_ - self.num_merges
        lump_sizes = np.zeros(num_lumps, dtype=np.int64)
        lump_span_counts = np.zeros(num_lumps, dtype=np.int64)
        root_to_lump = np.full(ord_, -1, dtype=np.int64)
        lump_index = 0
        for i in range(ord_):
            k = self.unmerged_height_node[i][2]
            if self.merge_with[k] != -1:
                continue
            root_to_lump[k] = lump_index
            lump_sizes[lump_index] = self.node_size[k]
            lump_span_counts[lump_index] = self.num_merged_nodes[k]
            lump_index += 1
        assert lump_index == num_lumps
        self.lump_start = cum_sum_vec(lump_sizes)
        lump_to_span = cum_sum_vec(lump_span_counts)

        # span position: nodes of a lump are laid out in node-index order
        perm_inverse = np.empty(ord_, dtype=np.int64)
        cursor = lump_to_span[:-1].copy()
        for i in range(ord_):
            p = self.merge_with[i]
            li = root_to_lump[i if p == -1 else p]
            perm_inverse[i] = cursor[li]
            cursor[li] += 1
        self.perm_inverse = perm_inverse
        self.lump_to_span = lump_to_span

    # ------------------------------------------------------------------
    # merge-state snapshot/restore + remerge: lets create_solver evaluate
    # alternative merge candidates (different model constants) WITHOUT
    # re-running build_tree's symbolic fill — the expensive part of the
    # analysis is computed once and shared.
    _MERGE_STATE_ATTRS = (
        "merge_with", "num_merged_nodes", "num_merges", "lump_start",
        "lump_to_span", "perm_inverse", "sparse_elim_ranges", "node_size",
        "syge_costs", "asmbl_costs", "comp_model", "col_start", "row_param")

    def capture_merge_state(self) -> dict:
        out = {}
        for a in self._MERGE_STATE_ATTRS:
            v = getattr(self, a, None)
            out[a] = v.copy() if isinstance(v, np.ndarray) else v
        return out

    def restore_merge_state(self, state: dict) -> None:
        for a, v in state.items():
            setattr(self, a, v)

    def remerge(self, comp_model: ComputationModel,
                detect_sparse_elim_ranges: bool,
                no_cross_points: Sequence[int] = (),
                find_only_elims: bool = False) -> None:
        """Re-run the merge phase (process_tree) under a different
        computation model, reusing the already-computed symbolic fill and
        tree. Resets everything the merge loop mutates."""
        self.comp_model = comp_model or self.comp_model
        self.node_size = self.param_size.copy()
        self.per_row_stats = None
        self._compute_cost_accumulators()
        self.process_tree(detect_sparse_elim_ranges, no_cross_points,
                          find_only_elims)

    # ------------------------------------------------------------------
    def compute_aggregate_struct(self, fill_only_for_elims: bool = False) -> None:
        ord_ = self.ss.order
        num_lumps = len(self.lump_start) - 1
        tperm = self.ss.symmetric_permutation(self.perm_inverse,
                                              lower_half=True,
                                              sort_indices=False)
        if fill_only_for_elims:
            for e in range(len(self.sparse_elim_ranges) - 1):
                tperm = tperm.add_independent_elimination_fill(
                    self.sparse_elim_ranges[e], self.sparse_elim_ranges[e + 1])
        else:
            tperm = tperm.add_full_elimination_fill()
        tperm = tperm.transpose()  # columns: rows >= col per block-column

        # merge columns of each lump: union of row ids, deduped and sorted
        col_counts = np.zeros(num_lumps, dtype=np.int64)
        row_param_parts = []
        for a in range(num_lumps):
            s0, s1 = self.lump_to_span[a], self.lump_to_span[a + 1]
            rows = np.unique(tperm.inds[tperm.ptrs[s0]:tperm.ptrs[s1]])
            col_counts[a] = len(rows)
            row_param_parts.append(rows)
        self.col_start = cum_sum_vec(col_counts)
        self.row_param = (np.concatenate(row_param_parts)
                          if row_param_parts else np.empty(0, dtype=np.int64))

    # ------------------------------------------------------------------
    def compute_span_start(self) -> np.ndarray:
        out = np.zeros(len(self.param_size), dtype=np.int64)
        out[self.perm_inverse] = self.param_size
        return cum_sum_vec(out)
