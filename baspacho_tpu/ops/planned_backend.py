"""Planned backend: level-scheduled, bucketed, batched numeric ops.

The XLA counterpart of the reference's fast backends (MatOpsFast.cpp /
MatOpsCuda.cu), redesigned for XLA instead of translated:

  * The elimination tree is level-scheduled: every lump (supernode) gets a
    level = 1 + max(level of its updating columns); all lumps in a level
    are independent. The reference exploits this only for leaf levels
    ("sparse elimination ranges", EliminationTree.cpp:136); here it is
    generalized to the whole tree, so the factorization becomes
    #levels sequential steps of fully-batched work.
  * Within a level, lumps are bucketed by power-of-two-padded panel shape;
    each bucket runs ONE batched op: gather panels -> batched cholesky ->
    batched triangular solve -> scatter back. Right-looking updates
    compute each column's outer product once as a single batched
    (B, R, R) matmul; the per-level products are then
    assembled into later columns by a handful of per-block-shape
    gather/scatter-add passes (deterministic — replaces CUDA atomics, and
    subsumes the reference's flattened block-pair sparse-elim kernel
    MatOpsCuda.cu:309 as the level-0 case).
  * All indices are affine expressions of small per-bucket host constants
    (offset/rows/cols arrays), computed inside the jitted graph — no
    index tensors are materialized on the host and no host<->device
    traffic happens at numeric time (fixes the reference's per-lump
    prepareAssemble memcpy FIXME, MatOpsCuda.cu:474).

Data convention: ops work on the flat data vector extended by two slots:
[data..., trash, zero] — masked writes land in `trash`, masked reads come
from `zero`. Wrappers pad/strip.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .plan import NumericPlan


def pad_dim(x: int, floor: int = 1) -> int:
    """Bucket-shape padding: next power of two (with a floor) up to 512,
    then next multiple of 512. Coarse pow2 padding keeps bucket count low
    for the long tail of small shapes — which keeps the XLA graph small —
    while the 512-multiple regime caps the waste on large panels (pow2
    would pad a 2754-wide supernode to 4096: +77% area, +2.5x cholesky
    flops; 512-multiples cap the linear overhead at <19%). Floors (8 for
    panel rows, 4 for block dims) collapse tiny shapes into single
    buckets."""
    if x <= floor:
        return floor
    if x <= 512:
        return int(2 ** int(np.ceil(np.log2(x))))
    return ((x + 511) // 512) * 512


PAD_ROWS = 8    # floor for below-diag panel rows
PAD_COLS = 4    # floor for lump widths / pair block dims


def storage_pad(below_rows, widths):
    """Padded panel shape policy shared by the skeleton storage layout and
    the planned backend's buckets: power-of-two with floors; columns with
    no below rows get no row padding."""
    below_rows = np.asarray(below_rows, dtype=np.int64)
    prp = np.where(below_rows == 0, 0, _pad_pow2(below_rows, PAD_ROWS))
    return prp, _pad_pow2(np.asarray(widths, dtype=np.int64), PAD_COLS)


def _i32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int32)


def _pad_pow2(x: np.ndarray, floor: int) -> np.ndarray:
    """Vectorized pad_dim (pow2 up to 512, then 512-multiples)."""
    x = np.maximum(np.asarray(x, dtype=np.int64), floor)
    p2 = np.int64(1) << np.ceil(np.log2(x)).astype(np.int64)
    return np.where(x <= 512, p2, (x + 511) // 512 * 512)


def _ceil_pow2(x: int) -> int:
    """Scalar pad_dim (pow2 up to 512, then 512-multiples)."""
    if x <= 1:
        return 1
    if x <= 512:
        return int(2 ** int(np.ceil(np.log2(x))))
    return (x + 511) // 512 * 512


@dataclass
class LumpBucket:
    """Same-padded-shape supernode panels factored as one batched op.

    Each panel is [(cp x cp) padded diag | (rp x cp) padded below] at
    flat offset `off`. With the level-shape-reordered padded storage
    layout, a bucket's panels are adjacent in memory (`contiguous`) and
    the whole (B, cp+rp, cp) tensor is one reshape of a contiguous slice
    — no gather; otherwise an affine masked gather is used."""
    rp: int              # padded below rows
    cp: int              # padded lump width (= panel row stride)
    off: np.ndarray      # (B,) panel flat-data offsets
    rows: np.ndarray     # (B,) actual below rows
    cols: np.ndarray     # (B,) actual lump widths
    vec_off: np.ndarray  # (B,) RHS offsets
    below_idx: np.ndarray = None  # (B, rp) RHS rows of below rows (solve)
    contiguous: bool = False
    prod_base: int = 0   # offset of this bucket's outer products in the
    #                      level's concatenated flat product buffer
    members: list = None  # lump ids in bucket order


@dataclass
class PairBucket:
    """Run-coalesced update blocks of one level with the same padded
    (rsp x csp) shape. Each entry subtracts a (rs x cs) block of the level
    product buffer into a contiguous-rows region of a target panel via an
    elementwise block scatter-add; rows are maximal runs of consecutive
    spans (adjacent chains in the target column, hence contiguous memory
    in the padded layout)."""
    rsp: int                # padded run rows
    src_base: np.ndarray    # (P,) flat offset of block in product buffer
    src_stride: np.ndarray  # (P,) product row stride (rp of origin bucket)
    rs: np.ndarray          # (P,) actual rows
    cs: np.ndarray          # (P,) actual cols
    c0: np.ndarray          # (P,) column offset inside the target panel
    tgt_row_start: np.ndarray  # (P,) flat offset of the block's first row
    #                            at column 0 of the target panel
    tgt_stride: np.ndarray = None  # (P,) per-pair target panel stride
    csp: int = 0            # padded run cols
    exact: bool = False     # group with rsp == rs, csp == cs for every
    #                         pair: no padding, no mask, no clip


class PlannedBackend:
    # matmul precision of the level-update accumulation GEMMs (the
    # U = sum x x^T syrk); set by Solver from Settings.update_precision.
    update_precision: str = "highest"

    def _upd_prec(self):
        """lax.Precision for the update syrk, or None to inherit the
        ambient default_matmul_precision context."""
        p = self.update_precision
        return None if p is None else jax.lax.Precision(p)

    def __init__(self, plan: NumericPlan):
        self.plan = plan
        self.num_levels = int(plan.lump_levels.max()) + 1 \
            if len(plan.lump_levels) else 0
        self._sched_cache: Dict[Tuple[int, int], list] = {}
        self._solve_cache: Dict[Tuple[int, int], list] = {}
        # global chain lookup: key (lump_of_chain, row_span) is globally
        # ascending in chain storage order -> one searchsorted resolves any
        # (target lump, span) to its chain index
        sk = plan.skel
        chain_lump = np.repeat(
            np.arange(sk.num_lumps, dtype=np.int64),
            sk.chain_col_ptr[1:] - sk.chain_col_ptr[:-1])
        self._chain_keys = chain_lump * sk.num_spans + sk.chain_row_span

    # ------------------------------------------------------------------
    # schedule construction (host, cached per lump range)
    # ------------------------------------------------------------------
    def _by_level(self, start: int, end: int) -> List[np.ndarray]:
        """Lump ids of [start, end) grouped by schedule level (ascending),
        preserving id order within a level."""
        if end <= start:
            return []
        lv = np.asarray(self.plan.lump_levels[start:end])
        ids = np.arange(start, end, dtype=np.int64)
        order = np.argsort(lv, kind="stable")
        lv_s, ids_s = lv[order], ids[order]
        brk = (np.nonzero(np.diff(lv_s))[0] + 1).tolist()
        bounds = [0, *brk, len(ids_s)]
        return [ids_s[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def _factor_schedule(self, start: int, end: int):
        key = (start, end)
        sched = self._sched_cache.get(key)
        if sched is None:
            sched = [self._build_level(lds, with_below_idx=True)
                     for lds in self._by_level(start, end)]
            self._sched_cache[key] = sched
        return sched

    # dense-update heuristics: a level whose columns scatter into many
    # small fragments is cheaper as chunked dense GEMMs into a compact
    # update matrix U + contiguous slice subtractions
    DENSE_MIN_ORIGINS = 1
    DENSE_MAX_ORDER = 16384   # max compact region (touched rows) of U

    # cost-model constants for the dense-vs-pairs decision: f32 highest-
    # precision matmul throughput, per-XLA-op launch overhead, HBM
    # read+write bandwidth; scatter cost is modeled per addressed row (see
    # ROW_NS below). Carried over unmeasured on the current GPU target
    # from an earlier accelerator's timings; they select plans, so
    # refitting them is a measured performance change.
    MATMUL_FLOPS = 2.0e13
    OP_US = 2e-6
    HBM_BPS = 8.0e11

    def _build_level(self, lds, with_below_idx=False):
        """Bucket the level's lumps (`lds` is an array of lump ids);
        assign product-buffer offsets to buckets with below rows;
        enumerate assembly block pairs (or mark the level for the dense
        compact-U update path). The two assembly mechanisms are costed
        against each other per level."""
        import time as _time
        plan = self.plan
        lds = np.asarray(lds, dtype=np.int64)
        below_all = plan.lump_total_rows[lds] - plan.lump_sizes[lds]
        _t0 = _time.perf_counter()
        lump_buckets = self._bucket_lumps(lds, with_below_idx)
        _t1 = _time.perf_counter()
        n_origins = int(np.count_nonzero(below_all > 0))
        dense_info = None
        if n_origins >= self.DENSE_MIN_ORIGINS:
            dense_info = self._build_dense_update(lds, lump_buckets)
        _t2 = _time.perf_counter()
        if os.environ.get("BASPACHO_PLAN_DEBUG") and _t2 - _t0 > 0.5:
            print(f"[plan-host] level({len(lds)}): bucket {_t1-_t0:.2f}s "
                  f"dense-plan {_t2-_t1:.2f}s", flush=True)

        prod_total = 0
        origin_pos: Dict[int, Tuple[int, int]] = {}
        for lb in lump_buckets:
            if lb.rp == 0:
                continue
            lb.prod_base = prod_total
            for bi, l in enumerate(lb.members.tolist()):
                origin_pos[l] = (prod_total + bi * lb.rp * lb.rp, lb.rp)
            prod_total += len(lb.off) * lb.rp * lb.rp

        debug = os.environ.get("BASPACHO_PLAN_DEBUG")
        force = os.environ.get("BASPACHO_FORCE_ASSEMBLY")  # dense|pairs

        if dense_info is not None and force != "pairs":
            # cheap LOWER bound on the pair path (scatter cost is per
            # addressed ROW — assume optimistically wide 32-col blocks —
            # plus element traffic and the product buffer at HBM
            # bandwidth). When dense beats even that, skip enumerating
            # pairs entirely (at BAL scale that enumeration costs minutes
            # of host time and would be discarded).
            elems_lb = float((below_all * (below_all + 1) // 2).sum())
            lower = (elems_lb / 32) * self.ROW_NS + \
                (elems_lb + prod_total) * 8 / self.HBM_BPS
            # massive fragmented levels: enumerating pairs just to price
            # them costs minutes of host time (527k-landmark BAL measured
            # ~100 s in _build_pairs alone); when a dense plan exists for
            # such a level, take it without pricing the alternative
            if len(lds) > 20000:
                lower = float("inf")
            if dense_info["cost"] < lower or force == "dense":
                if debug:
                    print(f"[plan] level({len(lds)} lumps): DENSE "
                          f"cost={dense_info['cost']*1e3:.3f}ms "
                          f"pairs_lower={lower*1e3:.3f}ms "
                          f"R={dense_info['R']}", flush=True)
                out_pb = self._build_outlier_meta(dense_info, lump_buckets)
                return lump_buckets, out_pb, 0, dense_info

        pair_buckets = self._build_pairs(lds, origin_pos)
        if dense_info is not None and force != "pairs":
            pairs_elems = sum(
                len(pb.rs) * pb.rsp * pb.csp for pb in pair_buckets)
            pairs_rows = sum(
                len(pb.rs) * pb.rsp for pb in pair_buckets)
            prod_flops = sum(len(lb.off) * lb.rp * lb.rp * lb.cp
                             for lb in lump_buckets)
            pairs_cost = pairs_rows * self.ROW_NS + \
                (pairs_elems + prod_total) * 8 / self.HBM_BPS + \
                prod_flops / self.MATMUL_FLOPS + \
                len(pair_buckets) * self.OP_US
            if debug:
                print(f"[plan] level({len(lds)} lumps): "
                      f"dense={dense_info['cost']*1e3:.3f}ms "
                      f"pairs={pairs_cost*1e3:.3f}ms "
                      f"R={dense_info['R']} -> "
                      f"{'DENSE' if dense_info['cost'] < pairs_cost else 'PAIRS'}",
                      flush=True)
            if dense_info["cost"] < pairs_cost:
                # wide-spread "outlier" origins bypass the dense compact
                # space; their updates run as block-pair scatters
                out_pb = self._build_outlier_meta(dense_info, lump_buckets)
                return lump_buckets, out_pb, 0, dense_info
        elif debug:
            pairs_elems = sum(
                len(pb.rs) * pb.rsp * pb.csp for pb in pair_buckets)
            print(f"[plan] level({len(lds)} lumps): PAIRS "
                  f"(dense={'n/a' if dense_info is None else 'forced off'}) "
                  f"elems={pairs_elems}", flush=True)
        return lump_buckets, pair_buckets, prod_total, None

    OUTLIER_SPREAD = 512   # floor for the adaptive per-level outlier cap
    CHUNK_STEP_US = 10e-6   # modeled lax.scan chunk-step overhead
    OH_GEN_NS = 0.1e-9      # modeled one-hot generation cost per element
    #                         (fused compare+convert feeding the matmul)
    ROW_NS = 60e-9          # modeled scatter cost per ADDRESSED ROW
    #                         (scatter throughput modeled as per-index-row
    #                         bound, not per-element; wide rows approach
    #                         HBM bandwidth)
    W_MAX_ELEMS = 32 << 20  # cap on materialized W (R x K) for the
    #                         scatter-built dense mode (128 MB f32)

    def _pick_chunk_width(self, minmax, lb, R):
        """Adaptive chunk width for the dense-update accumulation.

        The chunk GEMM costs ~2*subp^2*nb*cp flops where subp is the
        chunk's compact-row extent: with row locality subp is ~constant,
        so bigger chunks amortize scan-step overhead; without locality
        subp saturates at R and SMALL chunks win quadratically (a 50k x
        random-fill Schur set measured 12x faster at nb=8 vs nb=512).
        Sweep power-of-two widths and minimize the modeled cost —
        vectorized over chunks via reduceat on per-member extents."""
        mn_m, mx_m = minmax
        B = len(mn_m)
        cp, rp = lb.cp, lb.rp
        best, best_per = None, max(1, self.CHUNK_W // cp)
        per = 4
        while per <= max(4, self.CHUNK_W // cp):
            b0s = np.arange(0, B, per)
            mn_c = np.minimum.reduceat(mn_m, b0s)
            mx_c = np.maximum.reduceat(mx_m, b0s)
            valid = mx_c >= 0
            ext = np.maximum(mx_c - mn_c + 1, self.SUB_FLOOR)
            subp = np.minimum(_pad_pow2(np.maximum(ext, 1), 1), R)
            subp = subp[valid].astype(np.float64)
            nv = int(valid.sum())
            flops = float((2 * subp * subp * per * cp +
                           2 * per * rp * subp * cp).sum())
            oh = float((per * rp * subp).sum())
            cost = nv * self.CHUNK_STEP_US + flops / self.MATMUL_FLOPS + \
                oh * self.OH_GEN_NS
            if best is None or cost < best:
                best, best_per = cost, per
            per *= 2
        return best_per

    def _build_outlier_meta(self, dense, lump_buckets):
        """Plan the scatter path for dense-level outlier origins: a
        dedicated flat product buffer (in outlier order) feeds the usual
        block-pair machinery; `out_groups` records how to fetch each
        outlier's solved below panel from its bucket's batch, and
        `out_bidx` its RHS row positions (for the solve)."""
        outliers = dense["outliers"]
        dense["out_groups"] = []
        if not outliers:
            return []
        plan = self.plan
        order = plan.skel.order
        ptr, flat = plan.below_row_ptr, plan.below_rows_flat
        origin_pos = {}
        total = 0
        by_bucket: Dict[int, list] = {}
        for bi, i, l in outliers:
            rp = lump_buckets[bi].rp
            origin_pos[l] = (total, rp)
            total += rp * rp
            by_bucket.setdefault(bi, []).append(i)
        for bi in sorted(by_bucket):
            idxs = by_bucket[bi]
            rp = lump_buckets[bi].rp
            bidx = np.full((len(idxs), rp), order, dtype=np.int32)
            for j, i in enumerate(idxs):
                m = int(lump_buckets[bi].members[i])
                n = int(ptr[m + 1] - ptr[m])
                bidx[j, :n] = flat[ptr[m]:ptr[m + 1]]
            dense["out_groups"].append((bi, _i32(np.array(idxs)), bidx))
        lds = np.array([l for _, _, l in outliers], dtype=np.int64)
        return self._build_pairs(lds, origin_pos)

    CHUNK_W = 2048       # max W width per accumulation chunk
    UNROLL_SLICES = 192  # up to this many slices are unrolled XLA ops
    #                      (static offsets, no masks); beyond, same-padded-
    #                      shape groups run under lax.scan (~1us/slice)
    MAX_SLICES = 200_000  # absolute graph-sanity cap on scanned slices
    SUB_FLOOR = 256      # min padded chunk sub-region (matmul-friendly)
    SCAN_SLICE_US = 1e-6  # modeled per-slice lax.scan iteration overhead

    def _build_dense_update(self, lds, lump_buckets):
        """Plan the dense update: the level's update matrix
        U = sum_o below_o below_o^T is accumulated in a COMPACT row space
        (the concatenation of the level's touched spans) over chunks of
        origin columns. Each chunk touches only a sub-interval [lo, lo+sub)
        of the compact space (tight when the ordering has locality, e.g.
        BAL landmarks sorted by camera): its contribution is computed as

            y_b = OneHot_b^T x_b          (rows placed by a matmul)
            U[lo:lo+sub, lo:lo+sub] += sum_b y_b y_b^T   (one GEMM)

        — cross-panel terms vanish because different panels occupy
        disjoint columns of the implicit W. Using one-hot matmuls instead
        of scatters keeps everything in dense matmuls (the cost model
        prices scatters per addressed row, see ROW_NS). Chunks of
        equal shape run under one lax.scan, so the XLA graph stays small
        at any chunk count (527k-landmark BAL => ~1000 chunks).

        U holds exactly the level's block-pair updates; targets receive it
        via contiguous chain-run slice subtractions at compact coords.
        This is the batched-matmul form of the reference's flattened
        block-pair sparse elimination (MatOpsCuda.cu:309)."""
        sk = self.plan.skel
        span_size = sk.span_start[1:] - sk.span_start[:-1]

        # per-bucket below-span expansions (vectorized: per-element host
        # loops over 500k+ members cost minutes at BAL scale)
        per_bucket = {}  # bi -> (sp, sz, rows_m, ptr_m)
        for bi, lb in enumerate(lump_buckets):
            if lb.rp == 0:
                continue
            lidx = np.asarray(lb.members, dtype=np.int64)
            nd = sk.lump_to_span[lidx + 1] - sk.lump_to_span[lidx]
            c0 = sk.chain_col_ptr[lidx] + nd
            c1 = sk.chain_col_ptr[lidx + 1]
            nch = c1 - c0
            tot = int(nch.sum())
            if tot == 0:
                per_bucket[bi] = None
                continue
            ex = np.concatenate([[0], np.cumsum(nch)[:-1]])
            ch = np.repeat(c0 - ex, nch) + np.arange(tot, dtype=np.int64)
            sp = sk.chain_row_span[ch]
            sz = span_size[sp]
            member_of = np.repeat(np.arange(len(lidx)), nch)
            rows_m = np.bincount(member_of, weights=sz,
                                 minlength=len(lidx)).astype(np.int64)
            ptr_m = np.concatenate([[0], np.cumsum(rows_m)])
            per_bucket[bi] = (sp, sz, rows_m, ptr_m)

        sp_all = [v[0] for v in per_bucket.values() if v is not None]
        if not sp_all:
            return None
        tspans = np.unique(np.concatenate(sp_all))
        R0 = int(span_size[tspans].sum())
        if R0 > self.DENSE_MAX_ORDER:
            return None
        # close small gaps between touched spans: an included-but-untouched
        # span costs U area (2*R*gap elements of zero/traffic) but merges
        # two target chain runs into one slice (~SCAN_SLICE_US + padded
        # window traffic saved). Cap from equating the two costs.
        gap_cap = min(512, int(1.3e5 / max(R0, 1)))
        if gap_cap > 0 and len(tspans) > 1:
            csum = np.concatenate([[0], np.cumsum(span_size)])
            gsz = csum[tspans[1:]] - csum[tspans[:-1] + 1]
            sel = (tspans[1:] - tspans[:-1] > 1) & (gsz <= gap_cap)
            if np.any(sel):
                a = tspans[:-1][sel] + 1
                b = tspans[1:][sel]
                n_f = b - a
                exf = np.concatenate([[0], np.cumsum(n_f)[:-1]])
                fill = np.repeat(a - exf, n_f) + \
                    np.arange(int(n_f.sum()), dtype=np.int64)
                tspans = np.unique(np.concatenate([tspans, fill]))
        tsizes = span_size[tspans]
        R = int(tsizes.sum())
        if R > self.DENSE_MAX_ORDER:
            return None
        # compact start of each touched span; untouched spans map to R
        # (one trash row appended to U's row space during the W build)
        compact_start = np.full(sk.num_spans + 1, R, dtype=np.int64)
        compact_start[tspans] = np.concatenate([[0], np.cumsum(tsizes)[:-1]])
        is_touched = np.zeros(sk.num_spans + 1, dtype=bool)
        is_touched[tspans] = True

        # per-bucket compact below-row indices (B, rp); pad rows -> R.
        # Origins whose touched rows SPREAD far wider than typical are
        # routed to the block-pair scatter path instead (rows masked to
        # the sentinel here): a few wide-coupling origins — BA loop
        # closures are the canonical case — would otherwise blow every
        # chunk's compact sub-interval up to the whole space and make the
        # one-hot placement quadratically expensive. The cap adapts to
        # the level (median spread), so levels that are uniformly wide
        # (e.g. random-fill Schur sets) stay fully dense.
        cr_b = {}
        spread_b = {}
        all_spreads = []
        for bi, pb_ in per_bucket.items():
            if pb_ is None:
                continue
            sp, sz, rows_m, ptr_m = pb_
            tot_r = int(ptr_m[-1])
            exr = np.concatenate([[0], np.cumsum(sz)[:-1]])
            cr = np.repeat(compact_start[sp] - exr, sz) + \
                np.arange(tot_r, dtype=np.int64)
            cr_b[bi] = cr
            ne = rows_m > 0
            spread = np.zeros(len(rows_m), dtype=np.int64)
            if np.any(ne):
                st = ptr_m[:-1][ne]
                spread[ne] = np.maximum.reduceat(cr, st) - \
                    np.minimum.reduceat(cr, st)
            spread_b[bi] = spread
            all_spreads.append(spread[ne])
        med = float(np.median(np.concatenate(all_spreads))) \
            if all_spreads else 0.0
        out_cap = max(2 * self.SUB_FLOOR, 4 * _ceil_pow2(max(int(med), 1)))

        # dense sub-strategy: when W (R x K, K = total padded origin
        # columns) fits, MATERIALIZE it with one panel scatter per bucket
        # and compute U = W W^T as a single GEMM — panel scatters address
        # whole cp-wide rows (~HBM speed), the GEMM is a plain matmul, and
        # the solve's below updates collapse to two matvecs against W. The
        # chunked one-hot accumulation remains for levels whose W would
        # not fit (e.g. 527k-landmark BAL level 0).
        Kp = sum(len(lump_buckets[bi].off) * lump_buckets[bi].cp
                 for bi, pb_ in per_bucket.items() if pb_ is not None)
        force_dm = os.environ.get("BASPACHO_FORCE_DENSE_MODE")
        w_mode = (R + 1) * Kp <= self.W_MAX_ELEMS and \
            force_dm not in ("oh", "sg", "row")
        if w_mode:
            out_cap = 1 << 62  # whole R is materialized: no outliers
        row_maps = []
        outliers = []  # (bucket index, position in bucket, lump id)
        minmax_b = {}
        for bi, lb in enumerate(lump_buckets):
            if lb.rp == 0 or per_bucket.get(bi) is None:
                row_maps.append(None)
                continue
            sp, sz, rows_m, ptr_m = per_bucket[bi]
            B = len(lb.off)
            is_out = spread_b[bi] > out_cap
            rows_c = np.full((B, lb.rp), R, dtype=np.int64)
            keep = ~is_out
            tot_r = int(ptr_m[-1])
            keep_row = np.repeat(keep, rows_m)
            ii = np.repeat(np.arange(B), rows_m)[keep_row]
            jj = (np.arange(tot_r, dtype=np.int64) -
                  np.repeat(ptr_m[:-1], rows_m))[keep_row]
            rows_c[ii, jj] = cr_b[bi][keep_row]
            row_maps.append(_i32(rows_c))
            for i in np.nonzero(is_out)[0]:
                outliers.append((bi, int(i), int(lb.members[int(i)])))
            # per-member compact-row extents (outliers masked) feed the
            # adaptive chunk-width choice below
            mn_m = np.full(B, R, dtype=np.int64)
            mx_m = np.full(B, -1, dtype=np.int64)
            ne = rows_m > 0
            if np.any(ne):
                st_ = ptr_m[:-1][ne]
                mn_m[ne] = np.minimum.reduceat(cr_b[bi], st_)
                mx_m[ne] = np.maximum.reduceat(cr_b[bi], st_)
            mn_m[is_out] = R
            mx_m[is_out] = -1
            minmax_b[bi] = (mn_m, mx_m)

        # chunk groups: per bucket, consecutive member runs with total
        # width <= CHUNK_W; each chunk's compact sub-interval [lo, lo+subp)
        # padded to pow2 (>= SUB_FLOOR), capped at R; chunks grouped by
        # (bucket, nb, subp) so each group runs as one lax.scan. Chunks
        # whose one-hot tensor (nb*rp*subp) would be too large are split.
        OH_CAP = 64 << 20  # max one-hot elements per chunk
        groups: Dict[Tuple[int, int, int], list] = {}
        pad_b = {}
        col_base: Dict[int, int] = {}
        total_flops = 0
        total_oh = 0
        n_chunks = 0
        w_rows = 0
        if w_mode:
            kcur = 0
            for bi, lb in enumerate(lump_buckets):
                if lb.rp == 0 or per_bucket.get(bi) is None:
                    continue
                col_base[bi] = kcur
                kcur += len(lb.off) * lb.cp
                w_rows += len(lb.off) * lb.rp
            if not col_base:
                return None
            total_flops = 2 * R * R * kcur
            mode_cost = w_rows * self.ROW_NS + \
                (R + 1) * kcur * 8 / self.HBM_BPS
        else:
            for bi, lb in enumerate(lump_buckets):
                if lb.rp == 0 or per_bucket.get(bi) is None:
                    continue
                B = len(lb.off)
                per = self._pick_chunk_width(minmax_b[bi], lb, R)
                rc = row_maps[bi]

                def sub_of(b0, b1):
                    real = rc[b0:b1][rc[b0:b1] < R]
                    if not len(real):
                        return None, None
                    lo, hi = int(real.min()), int(real.max()) + 1
                    subp = min(_ceil_pow2(max(hi - lo, self.SUB_FLOOR)), R)
                    if subp >= R:
                        return 0, R
                    return max(0, min(lo, R - subp)), subp

                work = [(b0, min(b0 + per, B)) for b0 in range(0, B, per)]
                while work:
                    b0, b1 = work.pop()
                    lo, subp = sub_of(b0, b1)
                    if lo is None:
                        continue
                    nb = b1 - b0
                    if nb > 1 and nb * lb.rp * subp > OH_CAP:
                        mid = (b0 + b1) // 2
                        work += [(b0, mid), (mid, b1)]
                        continue
                    groups.setdefault((bi, nb, subp), []).append((b0, lo))
                    pad_b[bi] = max(pad_b.get(bi, B), b0 + nb)
                    total_flops += 2 * subp * subp * nb * lb.cp + \
                        2 * nb * lb.rp * subp * lb.cp
                    total_oh += nb * lb.rp * subp
                    n_chunks += 1
            if not groups:
                return None
            mode_cost = n_chunks * self.CHUNK_STEP_US + \
                total_oh * self.OH_GEN_NS

        # per target lump: row runs x column runs over touched spans only
        touched_lumps = np.unique(sk.span_to_lump[tspans]).tolist()
        slices = []  # (panel_off, rows, stride, c0, wc, gr0, gc0) compact

        def runs(spans, keep):
            i = 0
            while i < len(spans):
                if not keep[i]:
                    i += 1
                    continue
                j = i
                while j + 1 < len(spans) and keep[j + 1] and \
                        spans[j + 1] == spans[j] + 1:
                    j += 1
                yield i, j
                i = j + 1

        for t in touched_lumps:
            tcs, tce = int(sk.chain_col_ptr[t]), int(sk.chain_col_ptr[t + 1])
            spans = sk.chain_row_span[tcs:tce]
            keep = is_touched[spans]
            st = int(sk.col_stride[t])
            s0, s1 = int(sk.lump_to_span[t]), int(sk.lump_to_span[t + 1])
            nd_t = s1 - s0  # chains [0, nd_t) form the diag block; the
            # padded layout has a storage gap at this boundary (below
            # panel starts at panel_base + st*st), so row runs must split
            # there — same rule as _build_pairs
            own = np.arange(s0, s1)
            own_keep = is_touched[own]
            col_runs = []
            for ci, cj in runs(own, own_keep):
                col_runs.append((
                    int(sk.span_start[own[ci]] - sk.lump_start[t]),  # c0
                    int(sk.span_start[own[cj] + 1] -
                        sk.span_start[own[ci]]),                      # wc
                    int(compact_start[own[ci]])))                     # gc0
            for ri, rj in runs(spans, keep):
                segs = ([(ri, rj)] if rj < nd_t or ri >= nd_t
                        else [(ri, nd_t - 1), (nd_t, rj)])
                for pi, pj in segs:
                    # split further at compact discontinuities (spans
                    # consecutive by id are compact-consecutive iff both
                    # touched, which keep guarantees — so none here)
                    rs = int(np.sum(span_size[spans[pi:pj + 1]]))
                    gr0 = int(compact_start[spans[pi]])
                    off = int(sk.chain_data[tcs + pi])
                    for c0, wc, gc0 in col_runs:
                        slices.append((off, rs, st, c0, wc, gr0, gc0))
            if len(slices) > self.MAX_SLICES:
                return None  # too fragmented: block-pair path wins

        # RHS-vector slices (for the solve's dense below updates): runs of
        # consecutive touched spans are contiguous both in the compact row
        # space and in the RHS vector
        vec_slices = []
        i = 0
        while i < len(tspans):
            j = i
            while j + 1 < len(tspans) and tspans[j + 1] == tspans[j] + 1:
                j += 1
            vec_slices.append((int(sk.span_start[tspans[i]]),
                               int(sk.span_start[tspans[j] + 1] -
                                   sk.span_start[tspans[i]]),
                               int(compact_start[tspans[i]])))
            i = j + 1

        # span-granular accumulation variant: when every touched span has
        # one uniform size, one-hot placement can address SPANS instead of
        # rows (oh volume / s3^2) and full-space chunks accumulate only a
        # lower block-triangle of U (see _plan_sg). Costed against the
        # row-granular form; the row-granular descriptors are kept in the
        # plan regardless (solve + sharded factor still use them).
        update_cost = total_flops / self.MATMUL_FLOPS + mode_cost
        sg = None
        if not w_mode and force_dm != "row":
            sg = self._plan_sg(tsizes, R, per_bucket, cr_b, spread_b,
                               out_cap, minmax_b, lump_buckets)
            if sg is not None and (sg["cost"] < update_cost or
                                   force_dm == "sg"):
                update_cost = sg["cost"]
            else:
                sg = None

        slice_elems = sum(rs * wc for _, rs, _, _, wc, _, _ in slices)
        mode_fields = {"mode": "w" if w_mode else "oh",
                       "Kp": kcur if w_mode else 0,
                       "col_base": col_base, "sg": sg}
        if len(slices) <= self.UNROLL_SLICES:
            cost = update_cost + \
                len(slices) * 3 * self.OP_US + \
                (R * R + slice_elems) * 4 / 8e11  # U zero/traffic at HBM bw
            return {"R": R, "groups": groups, "row_maps": row_maps,
                    "pad_b": pad_b, "slices": slices, "slice_scans": [],
                    "u_pads": (0, 0, 0), "vec_slices": vec_slices,
                    "outliers": outliers, "cost": cost, **mode_fields}

        # too many slices to unroll: group by padded (row, stride) shape
        # and run each group as one lax.scan of masked window updates.
        # U gets margins so every dynamic window read stays in bounds:
        # rows [0, R + pr), cols [Lc + gc0 - c0, ... + st) with Lc = max
        # stride (reads use a full-stride window anchored at gc0 - c0 so
        # the target's c0 column offset needs no in-window dynamic slice).
        sgroups: Dict[Tuple[int, int], list] = {}
        pad_elems = 0
        for off, rs, st, c0, wc, gr0, gc0 in slices:
            rsp = _ceil_pow2(rs)
            sgroups.setdefault((rsp, st), []).append(
                (off, c0, gr0, gc0 - c0, rs, wc))
            pad_elems += rsp * st
        slice_scans = []
        pr = lc = 0
        for (rsp, st), items in sorted(sgroups.items()):
            items.sort()
            slice_scans.append((rsp, st, _i32(np.array(items))))
            pr = max(pr, rsp)
            lc = max(lc, st)
        cost = update_cost + \
            len(slices) * self.SCAN_SLICE_US + \
            len(slice_scans) * self.OP_US + \
            (R * R + 2 * pad_elems) * 4 / 8e11
        return {"R": R, "groups": groups, "row_maps": row_maps,
                "pad_b": pad_b, "slices": [], "slice_scans": slice_scans,
                "u_pads": (pr, lc, lc), "vec_slices": vec_slices,
                "outliers": outliers, "cost": cost, **mode_fields}

    OH_CAP_ELEMS = 64 << 20  # max one-hot elements per chunk (both modes)

    def _plan_sg(self, tsizes, R, per_bucket, cr_b, spread_b, out_cap,
                 minmax_b, lump_buckets):
        """Span-granular variant of the chunked one-hot U accumulation.

        When every touched span has ONE uniform size s3 (all-3 Schur sets,
        all-9 BA camera bottoms), the one-hot placement can address SPANS
        instead of rows: the oh tensor shrinks by ~s3^2 (rows/s3 on the
        source side, positions/s3 on the target side) and the placement
        einsum moves s3*cp-wide blocks per matmul column instead of cp-wide
        rows. When additionally every chunk covers the whole compact space
        (random-fill Schur sets: no locality, spread ~ R), the U
        accumulation runs only on a lower block-triangle of T row-blocks
        (mirrored once after the scan), cutting the accumulation GEMM to
        (T+1)/2T of the full square. On the reference's schursize=50000
        config this replaces a row-granular accumulation with ~2.4 TFLOP
        of near-pure syrk. Returns None when the level is
        not span-uniform."""
        s3 = int(tsizes[0]) if len(tsizes) else 0
        if s3 < 2 or np.any(tsizes != s3) or R % s3:
            return None
        S = R // s3
        maps = {}
        for bi, lb in enumerate(lump_buckets):
            pb_ = per_bucket.get(bi)
            if lb.rp == 0 or pb_ is None:
                continue
            sp, sz, rows_m, ptr_m = pb_
            if np.any(sz != s3):
                return None  # a below span outside the uniform size
            B = len(lb.off)
            ns3p = -(-lb.rp // s3)
            ns_m = rows_m // s3
            keep = spread_b[bi] <= out_cap
            # member boundaries in cr_b fall on s3 multiples (every span
            # contributes exactly s3 consecutive compact rows), so the
            # first row of each span is cr_b[::s3]
            spans_c = cr_b[bi][::s3] // s3
            km = np.repeat(keep, ns_m)
            ii = np.repeat(np.arange(B), ns_m)[km]
            jj = (np.arange(int(ns_m.sum()), dtype=np.int64) -
                  np.repeat(np.cumsum(ns_m) - ns_m, ns_m))[km]
            sc = np.full((B, ns3p), S, dtype=np.int32)
            sc[ii, jj] = spans_c[km]
            maps[bi] = sc
        if not maps:
            return None

        # a level whose typical origin already spreads over most of the
        # compact space has no locality to exploit: force EVERY chunk to
        # the full window (uniform ssub = S) so the accumulation qualifies
        # for triangular blocking — a stray narrow tail chunk must not
        # disqualify the whole level
        sp_all = [spread_b[bi][spread_b[bi] > 0] for bi in maps]
        sp_all = np.concatenate(sp_all) if sp_all else np.zeros(1)
        full_level = len(sp_all) > 0 and float(np.median(sp_all)) >= 0.5 * R

        sfloor = max(1, self.SUB_FLOOR // s3)
        groups: Dict[Tuple[int, int, int], list] = {}
        pad_b: Dict[int, int] = {}
        n_chunks = 0
        flops_u = 0.0   # U-accumulation GEMM flops (pre-triangular)
        flops_y = 0.0   # placement einsum flops (width padded to 128)
        oh_elems = 0.0
        y_elems = 0.0
        u_rmw = 0.0     # per-chunk U window read+write bytes
        all_full = True
        for bi, lb in enumerate(lump_buckets):
            if maps.get(bi) is None:
                continue
            mn_m, mx_m = minmax_b[bi]
            smn = np.where(mn_m >= R, S, mn_m // s3)
            smx = mx_m // s3  # -1 stays negative for masked members
            B = len(lb.off)
            ns3p = maps[bi].shape[1]
            cp = lb.cp
            lane = max(s3 * cp, 128)  # modeled min width of the y einsum
            best, best_per = None, 4
            per = 4
            while per <= max(4, 4 * self.CHUNK_W // cp):
                b0s = np.arange(0, B, per)
                mn_c = np.minimum.reduceat(smn, b0s)
                mx_c = np.maximum.reduceat(smx, b0s)
                valid = mx_c >= 0
                ext = np.maximum(mx_c - mn_c + 1, sfloor)
                ssub = np.minimum(_pad_pow2(np.maximum(ext, 1), 1), S)
                ssub = ssub[valid].astype(np.float64)
                if full_level:
                    ssub = np.full_like(ssub, S)
                nv = int(valid.sum())
                fl = float((2.0 * (ssub * s3) ** 2 * per * cp).sum())
                fy = float((2.0 * per * ns3p * ssub * lane).sum())
                oh = float((per * ns3p * ssub).sum())
                ye = float((per * ssub * s3 * cp).sum())
                rmw = float(((ssub * s3) ** 2).sum()) * 8
                cost = nv * self.CHUNK_STEP_US + \
                    (fl + fy) / self.MATMUL_FLOPS + \
                    ((oh + 2 * ye) * 4 + rmw) / self.HBM_BPS
                if best is None or cost < best:
                    best, best_per = cost, per
                per *= 2
            work = [(b0, min(b0 + best_per, B))
                    for b0 in range(0, B, best_per)]
            while work:
                b0, b1 = work.pop()
                v = smx[b0:b1]
                sel = v >= 0
                if not np.any(sel):
                    continue
                mnc = int(smn[b0:b1][sel].min())
                mxc = int(v[sel].max())
                ssub = min(_ceil_pow2(max(mxc - mnc + 1, sfloor)), S)
                slo = 0 if ssub >= S else max(0, min(mnc, S - ssub))
                if full_level or ssub >= S:
                    ssub, slo = S, 0
                nb = b1 - b0
                if nb > 1 and nb * ns3p * ssub > self.OH_CAP_ELEMS:
                    mid = (b0 + b1) // 2
                    work += [(b0, mid), (mid, b1)]
                    continue
                if ssub < S:
                    all_full = False
                groups.setdefault((bi, nb, ssub), []).append((b0, slo))
                pad_b[bi] = max(pad_b.get(bi, B), b0 + nb)
                n_chunks += 1
                flops_u += 2.0 * (ssub * s3) ** 2 * nb * cp
                flops_y += 2.0 * nb * ns3p * ssub * lane
                oh_elems += nb * ns3p * ssub
                y_elems += nb * ssub * s3 * cp
                u_rmw += (ssub * s3) ** 2 * 8
        if not groups:
            return None
        tri = None
        if all_full and n_chunks >= 2:
            T = 4 if R >= 2048 else (2 if R >= 1024 else 1)
            if T > 1:
                Sb = -(-S // T)
                bnd = [(k * Sb, min((k + 1) * Sb, S)) for k in range(T)
                       if k * Sb < S]
                tri = [(a * s3, b * s3) for a, b in bnd]
                frac = (len(bnd) + 1) / (2.0 * len(bnd))
                flops_u *= frac
                u_rmw *= frac
        cost = n_chunks * self.CHUNK_STEP_US + \
            (flops_u + flops_y) / self.MATMUL_FLOPS + \
            ((oh_elems + 2 * y_elems) * 4 + u_rmw) / self.HBM_BPS
        return {"s3": s3, "S": S, "maps": maps, "groups": groups,
                "pad_b": pad_b, "tri": tri, "cost": cost}

    # Memory bound on one bucket's materialized 3-D panel tensor
    # (B, cp+rp, cp): oversized shape groups are split into contiguous
    # sub-buckets below this cap — downstream planning (dense/sg/pairs/
    # sharded) iterates buckets generically, so the split is transparent
    # everywhere. Override: BASPACHO_PANEL_BYTES_CAP.
    PANEL_BYTES_CAP = 2 << 30

    def _panel_cap(self) -> int:
        env = os.environ.get("BASPACHO_PANEL_BYTES_CAP")
        return int(env) if env else self.PANEL_BYTES_CAP

    @staticmethod
    def _panel_bytes(rp: int, cp: int, dtype=np.float64) -> int:
        """Dense bytes of ONE (cp+rp, cp) panel. Plans are built before
        the data's dtype is known and one plan serves float32 factors and
        float64 refinement residuals alike, so callers charge float64."""
        return (rp + cp) * cp * np.dtype(dtype).itemsize

    def _bucket_lumps(self, lds, with_below_idx: bool) -> List[LumpBucket]:
        """Group the lump ids by padded panel shape (fully vectorized —
        at BAL scale a level holds 500k+ lumps); oversized shape groups
        split into sub-buckets under the panel-bytes cap."""
        plan = self.plan
        order = plan.skel.order
        lds = np.asarray(lds, dtype=np.int64)
        prp_a = plan.lump_prp[lds]
        cp_a = plan.lump_strides[lds]
        co_a = plan.lump_col_offset[lds]
        sort_idx = np.lexsort((co_a, cp_a, prp_a))
        g_all = lds[sort_idx]
        prp_s, cp_s, co_s = prp_a[sort_idx], cp_a[sort_idx], co_a[sort_idx]
        brk = (np.nonzero((prp_s[1:] != prp_s[:-1]) |
                          (cp_s[1:] != cp_s[:-1]))[0] + 1).tolist()
        bounds = [0, *brk, len(g_all)]
        cap = self._panel_cap()
        sub_bounds = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            max_b = max(1, cap //
                        self._panel_bytes(int(prp_s[a]), int(cp_s[a])))
            for s in range(a, b, max_b):
                sub_bounds.append((s, min(s + max_b, b)))
        ptr = plan.below_row_ptr
        flat = plan.below_rows_flat
        out = []
        for a, b in sub_bounds:
            g = g_all[a:b]
            rp, cp = int(prp_s[a]), int(cp_s[a])
            bidx = None
            if with_below_idx:
                bidx = np.full((len(g), max(rp, 1)), order, dtype=np.int32)
                cnt = ptr[g + 1] - ptr[g]
                tot = int(cnt.sum())
                if tot:
                    ii = np.repeat(np.arange(len(g)), cnt)
                    ex = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                    jj = np.arange(tot, dtype=np.int64) - np.repeat(ex, cnt)
                    src = np.repeat(ptr[g] - ex, cnt) + \
                        np.arange(tot, dtype=np.int64)
                    bidx[ii, jj] = flat[src]
            offs = co_s[a:b]
            panel = (rp + cp) * cp
            contiguous = bool(np.all(np.diff(offs) == panel))
            lb = LumpBucket(
                rp=rp, cp=cp, off=_i32(offs),
                rows=_i32(plan.lump_total_rows[g] - plan.lump_sizes[g]),
                cols=_i32(plan.lump_sizes[g]),
                vec_off=_i32(plan.lump_vec_offset[g]),
                below_idx=bidx, contiguous=contiguous)
            lb.members = g
            out.append(lb)
        return out

    def _build_pairs(self, lds, origin_pos) -> List[PairBucket]:
        """Run-coalesced lower block pairs of all level columns.

        Below-diagonal spans of each origin column are grouped into
        maximal runs of consecutive span ids; column-side runs are split
        at target-lump boundaries, row-side runs additionally at the
        target's diag/below panel boundary (the padded layout has a gap
        there). Every (row_run >= col_run) pair is one rectangle — the
        run-diagonal rectangle includes upper span pairs, which is safe:
        they land in the never-read upper half of the target's diagonal
        block (the reference likewise subtracts whole square blocks on
        diagonal pairs, MatOpsRef.cpp:163-171). Vectorized with a global
        sorted (lump, span) chain-key lookup."""
        sk = self.plan.skel
        span_size = sk.span_start[1:] - sk.span_start[:-1]
        col_stride = sk.col_stride
        ck = self._chain_keys
        S = sk.num_spans

        parts = []  # per column: (src, sstride, rs, cs, c0, trs) arrays
        for o in np.asarray(lds, dtype=np.int64):
            o = int(o)
            if o not in origin_pos:
                continue
            base, rp = origin_pos[o]
            cs_, ce_ = int(sk.chain_col_ptr[o]), int(sk.chain_col_ptr[o + 1])
            nd = int(sk.lump_to_span[o + 1] - sk.lump_to_span[o])
            spans = sk.chain_row_span[cs_ + nd:ce_]
            nb = len(spans)
            if nb == 0:
                continue
            sizes = span_size[spans]
            row_offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            tlump = sk.span_to_lump[spans]
            # column runs: consecutive spans, same target lump
            brk_col = np.nonzero((spans[1:] != spans[:-1] + 1) |
                                 (tlump[1:] != tlump[:-1]))[0] + 1
            cbounds = np.concatenate([[0], brk_col, [nb]])
            # row runs: consecutive spans, split at each target's
            # diag/below boundary — computed per column run below
            brk_row = np.nonzero(spans[1:] != spans[:-1] + 1)[0] + 1
            rbounds_all = np.concatenate([[0], brk_row, [nb]])

            for cb in range(len(cbounds) - 1):
                j0, j1 = int(cbounds[cb]), int(cbounds[cb + 1])
                t = int(tlump[j0])
                stride = int(col_stride[t])
                t_end_span = int(sk.lump_to_span[t + 1])
                c0 = int(sk.span_offset_in_lump[spans[j0]])
                ccols = int(row_offs[j1 - 1] + sizes[j1 - 1] - row_offs[j0])
                # row runs start at this column run (i >= j ordering)
                ri = j0
                while ri < nb:
                    # find end of this row run
                    nxt = rbounds_all[np.searchsorted(rbounds_all, ri,
                                                      side="right")]
                    re = int(nxt)
                    # split at the target's diag/below boundary
                    if spans[ri] < t_end_span:
                        # run starts inside target lump's own spans
                        inside = np.searchsorted(spans[ri:re], t_end_span)
                        re_eff = ri + int(inside)
                    else:
                        re_eff = re
                    if re_eff == ri:
                        re_eff = re  # entire run below the boundary
                    seg_end = re_eff
                    # locate first span's chain in target column
                    s0 = int(spans[ri])
                    pos = int(np.searchsorted(ck, t * S + s0))
                    assert sk.chain_row_span[pos] == s0, \
                        "missing fill chain in target column"
                    rrows = int(row_offs[seg_end - 1] + sizes[seg_end - 1] -
                                row_offs[ri])
                    parts.append((
                        base + int(row_offs[ri]) * rp + int(row_offs[j0]),
                        rp, rrows, ccols, c0,
                        int(sk.chain_data[pos]),
                        stride))
                    ri = seg_end
        if not parts:
            return []
        arr = np.array(parts, dtype=np.int64).T
        src, sstride, rs, cls, c0, trs, stride = arr
        out = []

        # element path: exact-shape groups (the win is scattering ZERO
        # padded elements and skipping the mask/clip).
        # Shapes covering few pairs are folded into pow2-padded catch-all
        # groups to bound the XLA op count.
        esel = np.arange(len(rs))
        if len(esel):
            MAX_ELEMS = 16_000_000  # cap materialized update tensor size
            MAX_EXACT_GROUPS = 24
            shape_key = rs[esel] * 100000 + cls[esel]
            uniq, counts = np.unique(shape_key, return_counts=True)
            # largest shapes by pair count get exact groups
            exact = set(uniq[np.argsort(-counts)][:MAX_EXACT_GROUPS]
                        .tolist()) if len(uniq) > MAX_EXACT_GROUPS \
                else set(uniq.tolist())
            is_exact = np.isin(shape_key, list(exact))

            def emit(group, g_rsp, g_csp, exact_shape):
                per = max(1, MAX_ELEMS // (g_rsp * g_csp))
                for s0 in range(0, len(group), per):
                    g = group[s0:s0 + per]
                    pb = PairBucket(
                        rsp=g_rsp,
                        src_base=_i32(src[g]),
                        src_stride=_i32(sstride[g]),
                        rs=_i32(rs[g]), cs=_i32(cls[g]),
                        c0=_i32(c0[g]), tgt_row_start=_i32(trs[g]),
                        tgt_stride=_i32(stride[g]))
                    pb.csp = g_csp
                    pb.exact = exact_shape
                    out.append(pb)

            for key in sorted(exact):
                g = esel[shape_key == key]
                emit(g, int(rs[g[0]]), int(cls[g[0]]), True)
            rest = esel[~is_exact]
            if len(rest):
                # leftovers group by PER-SHAPE pow2 padding (<= 4x waste
                # each). A single max-padded catch-all was measured to
                # inflate flat1000's level-0 scatter volume 150x (pairs
                # up to 543 rows padded to 1024x1024 windows).
                rsp_e = _pad_pow2(rs[rest], PAD_COLS)
                csp_e = _pad_pow2(cls[rest], PAD_COLS)
                pkey = rsp_e * 100000 + csp_e
                for key in np.unique(pkey):
                    group = rest[pkey == key]
                    emit(group, int(key) // 100000, int(key) % 100000,
                         False)
        return out

    def _solve_schedule(self, start: int, end: int) -> List[List[LumpBucket]]:
        key = (start, end)
        sched = self._solve_cache.get(key)
        if sched is None:
            # the factor schedule's lump buckets are built with the same
            # (with_below_idx=True) layout — reuse them: re-bucketing
            # 500k+ lumps costs ~a minute of host time at BAL scale
            fs = self._sched_cache.get(key)
            if fs is not None:
                sched = [lev[0] for lev in fs]
            else:
                sched = [self._bucket_lumps(lds, with_below_idx=True)
                         for lds in self._by_level(start, end)]
            self._solve_cache[key] = sched
        return sched

    def _fuse_same_cp(self, buckets: List[LumpBucket]) -> List[LumpBucket]:
        """Solve-only bucket fusion: buckets sharing a column width cp can
        be read as one batched (B, cp+rp_max, cp) tensor — rows past a
        lump's actual panel read the NEXT panel's memory and are masked to
        zero at read time via `row_cnt` (the per-lump actual below-row
        count). The mask is load-bearing: without it the L pass scatters
        garbage into the RHS's sacrificial sentinel row, and the Lt pass
        of the SAME program then multiplies that dirty sentinel by the
        garbage rows back into real solution rows (the L/Lt passes share
        one vv in make_solve). Solve cost is modeled as per-XLA-op overhead
        dominated, so fewer, fatter ops win despite the padding."""
        order = self.plan.skel.order
        by_cp: Dict[int, list] = {}
        for lb in buckets:
            by_cp.setdefault(lb.cp, []).append(lb)
        out = []
        cap = self._panel_cap()
        for cp, group_all in sorted(by_cp.items()):
            # greedy partition so each fused bucket's panel tensor stays
            # under the footprint cap (same limit as _bucket_lumps). The
            # fused tensor reads EVERY member at the group's max rp, so a
            # group costs its total B times the panel bytes at that rp.
            groups, cur, cur_b, cur_rp = [], [], 0, 0
            for lb in group_all:
                b, rp = cur_b + len(lb.off), max(cur_rp, lb.rp)
                if cur and b * self._panel_bytes(rp, cp) > cap:
                    groups.append(cur)
                    cur, b, rp = [], len(lb.off), lb.rp
                cur.append(lb)
                cur_b, cur_rp = b, rp
            if cur:
                groups.append(cur)
            for group in groups:
                self._fuse_group(group, cp, order, out)
        return out

    def _fuse_group(self, group, cp, order, out):
        if len(group) == 1:
            out.append(group[0])
            return
        rp = max(lb.rp for lb in group)
        B = sum(len(lb.off) for lb in group)
        bidx = np.full((B, max(rp, 1)), order, dtype=np.int32)
        rcnt = np.zeros(B, dtype=np.int32)
        i = 0
        for lb in group:
            n = len(lb.off)
            if lb.rp > 0:
                bidx[i:i + n, :lb.rp] = lb.below_idx
            rcnt[i:i + n] = lb.rp
            i += n
        fused = LumpBucket(
            rp=rp, cp=cp,
            off=np.concatenate([lb.off for lb in group]),
            rows=np.concatenate([lb.rows for lb in group]),
            cols=np.concatenate([lb.cols for lb in group]),
            vec_off=np.concatenate([lb.vec_off for lb in group]),
            below_idx=bidx, contiguous=False)
        if any(lb.rp != rp for lb in group):
            fused.row_cnt = rcnt  # overread rows must be masked
        fused.members = np.concatenate(
            [np.asarray(lb.members) for lb in group])
        out.append(fused)

    SOLVE_BLOCK = 512  # diag-block size for the wide-panel inverse chain

    def _big_panel_solve(self, L, x, transpose):
        """Solve L x = b (or L^T x = b) for wide panels (cp > SOLVE_BLOCK)
        as a chain of matmuls against batch-inverted diagonal blocks: one
        batched triangular_solve against I computes all block inverses,
        then each 512-step is two matmuls —
        replacing a long chain of nrhs=1 triangular solves. Only reached
        when the stored inverse is not used (see PERF.md for its time
        against plain triangular_solve on an H100)."""
        B, cp = L.shape[0], L.shape[1]
        bs = self.SOLVE_BLOCK
        nb = (cp + bs - 1) // bs
        assert cp % bs == 0, "padded widths are pow2 >= SOLVE_BLOCK"
        blocks = jnp.stack([L[:, k * bs:(k + 1) * bs, k * bs:(k + 1) * bs]
                            for k in range(nb)], axis=1)
        eye = jnp.eye(bs, dtype=L.dtype)[None, None]
        binv = jax.lax.linalg.triangular_solve(
            blocks.reshape(B * nb, bs, bs),
            jnp.broadcast_to(eye, (B, nb, bs, bs)).reshape(B * nb, bs, bs),
            left_side=True, lower=True).reshape(B, nb, bs, bs)
        if not transpose:
            for k in range(nb):
                xk = jnp.einsum("bij,bjn->bin", binv[:, k],
                                x[:, k * bs:(k + 1) * bs],
                                preferred_element_type=x.dtype)
                x = x.at[:, k * bs:(k + 1) * bs].set(xk)
                if k + 1 < nb:
                    x = x.at[:, (k + 1) * bs:].add(-jnp.einsum(
                        "brj,bjn->brn", L[:, (k + 1) * bs:,
                                          k * bs:(k + 1) * bs], xk,
                        preferred_element_type=x.dtype))
        else:
            for k in range(nb - 1, -1, -1):
                xk = jnp.einsum("bji,bjn->bin", binv[:, k],
                                x[:, k * bs:(k + 1) * bs],
                                preferred_element_type=x.dtype)
                x = x.at[:, k * bs:(k + 1) * bs].set(xk)
                if k > 0:
                    x = x.at[:, :k * bs].add(-jnp.einsum(
                        "bjr,bjn->brn", L[:, k * bs:(k + 1) * bs, :k * bs],
                        xk, preferred_element_type=x.dtype))
        return x

    # ------------------------------------------------------------------
    # jit-graph building blocks
    # ------------------------------------------------------------------
    def _read_panels(self, ext, lb: LumpBucket):
        """(B, cp+rp, cp) panel tensor. Contiguous buckets are one
        reshape of a slice; otherwise one whole-panel gather WINDOW per
        lump (panels are contiguous in the padded storage, so this moves
        whole panels rather than gathering element by element)."""
        B = len(lb.off)
        h = lb.cp + lb.rp
        if lb.contiguous:
            flat = jax.lax.dynamic_slice_in_dim(
                ext, int(lb.off[0]), B * h * lb.cp)
            return flat.reshape(B, h, lb.cp)
        gnums = jax.lax.GatherDimensionNumbers(
            offset_dims=(1,), collapsed_slice_dims=(),
            start_index_map=(0,))
        flat = jax.lax.gather(ext, jnp.asarray(lb.off)[:, None], gnums,
                              slice_sizes=(h * lb.cp,))
        return flat.reshape(B, h, lb.cp)

    def _write_panels(self, ext, lb: LumpBucket, panels):
        B = len(lb.off)
        h = lb.cp + lb.rp
        if lb.contiguous:
            return jax.lax.dynamic_update_slice_in_dim(
                ext, panels.reshape(-1), int(lb.off[0]), axis=0)
        dnums = jax.lax.ScatterDimensionNumbers(
            update_window_dims=(1,), inserted_window_dims=(),
            scatter_dims_to_operand_dims=(0,))
        return jax.lax.scatter(ext, jnp.asarray(lb.off)[:, None],
                               panels.reshape(B, h * lb.cp), dnums,
                               indices_are_sorted=True,
                               unique_indices=True)

    @staticmethod
    def _pad_eye(cols, cp, dtype):
        i_ = jax.lax.broadcasted_iota(jnp.int32, (1, cp, cp), 1)
        j_ = jax.lax.broadcasted_iota(jnp.int32, (1, cp, cp), 2)
        return ((i_ == j_) &
                (i_ >= jnp.asarray(cols)[:, None, None])).astype(dtype)

    UNROLL_CP = 8  # widths up to this use the unrolled scalar-vector path

    def _unrolled_chol(self, A):
        """Unrolled Cholesky for tiny panel widths as fused (B,) vector
        ops. On an H100 this beats batched cholesky + triangular_solve at
        the Schur-level shapes: B=527,480 (4, 4)-panels with 64 below
        rows factor in 0.96 ms vs 2.64 ms, and whole grid / meri factors
        are 8% / 25% faster (see PERF.md)."""
        n = A.shape[1]
        L = [[None] * n for _ in range(n)]
        zero = jnp.zeros_like(A[:, 0, 0])
        for j in range(n):
            v = A[:, j, j]
            for k in range(j):
                v = v - L[j][k] * L[j][k]
            d = jnp.sqrt(v)
            L[j][j] = d
            inv_d = 1.0 / d
            for i in range(j + 1, n):
                s = A[:, i, j]
                for k in range(j):
                    s = s - L[i][k] * L[j][k]
                L[i][j] = s * inv_d
        rows = [jnp.stack([L[i][j] if j <= i else zero
                           for j in range(n)], axis=-1) for i in range(n)]
        return jnp.stack(rows, axis=1)

    def _unrolled_lower_inv(self, L):
        """Closed-form inverse of batched tiny lower-triangular L: turns
        every subsequent triangular solve into a batched matmul."""
        n = L.shape[1]
        zero = jnp.zeros_like(L[:, 0, 0])
        M = [[None] * n for _ in range(n)]
        for j in range(n):
            M[j][j] = 1.0 / L[:, j, j]
            for i in range(j + 1, n):
                s = L[:, i, j] * M[j][j]
                for k in range(j + 1, i):
                    s = s + L[:, i, k] * M[k][j]
                M[i][j] = -s / L[:, i, i]
        rows = [jnp.stack([M[i][j] if j <= i else zero
                           for j in range(n)], axis=-1) for i in range(n)]
        return jnp.stack(rows, axis=1)

    def _lower_inv(self, L, cp, dtype):
        """Batched lower-triangular inverse for any panel width (L must
        carry unit diagonal on padded columns, i.e. include pad_eye)."""
        if cp <= self.UNROLL_CP:
            return self._unrolled_lower_inv(L)
        B = L.shape[0]
        eye = jnp.broadcast_to(jnp.eye(cp, dtype=dtype)[None], (B, cp, cp))
        return jax.lax.linalg.triangular_solve(L, eye, left_side=True,
                                               lower=True)

    def _factor_panels(self, diag_in, below_in, cp, dtype):
        """potrf + trsm on batched (B, cp, cp) diagonals with optional
        (B, rp, cp) below panels; returns (L, x_or_None, Linv). Tiny
        widths use the unrolled form; every other width is one batched
        cholesky (cuSOLVER on the GPU) — on an H100 that beat a 256-wide
        blocked loop on the flat1000 / grid / flat_schur_full factors and
        compiles in ~1 s instead of ~16 s at cp >= 2048 (see PERF.md).

        Linv (the explicit inverse of L) serves two roles: the below trsm
        becomes a batched matmul, and the factor stores it in the diag
        block's otherwise-unused strict upper triangle so the solve needs
        ONE matmul per bucket instead of a triangular solve."""
        if cp <= self.UNROLL_CP:
            L = self._unrolled_chol(diag_in)
        else:
            L = jax.lax.linalg.cholesky(diag_in, symmetrize_input=False)
        Linv = self._lower_inv(L, cp, dtype)
        x = None
        if below_in is not None:
            # x L^T = below  =>  x = below L^-T
            x = jnp.einsum("brk,bjk->brj", below_in, Linv,
                           preferred_element_type=dtype)
        return L, x, Linv

    def _factor_bucket(self, ext, lb: LumpBucket, want_below=False):
        """Batched potrf + trsm of one bucket; returns (ext, flat_prod) or
        (ext, below_x) when want_below (dense update path)."""
        # fusion fence: without it XLA's fusion pass goes quadratic on
        # chained scatter->gather rounds whenever the root data vector is
        # a computed value (e.g. after the padding-mask multiply) instead
        # of a parameter — compile of a 5k-lump Schur level drops from
        # minutes to seconds, with no runtime change (nothing profitable
        # fuses across a panel write -> next bucket's panel read anyway)
        ext = jax.lax.optimization_barrier(ext)
        panels = self._read_panels(ext, lb)
        pad_eye = self._pad_eye(lb.cols, lb.cp, ext.dtype)
        diag_in = panels[:, :lb.cp] + pad_eye
        below_in = panels[:, lb.cp:] if lb.rp > 0 else None
        L, x, Linv = self._factor_panels(diag_in, below_in, lb.cp,
                                         ext.dtype)
        diag_store = self._embed_inv(L, Linv, pad_eye)
        prod = None
        if x is not None:
            new_panels = jnp.concatenate([diag_store, x], axis=1)
            if not want_below:
                prod = jnp.einsum(
                    "brk,bsk->brs", x, x,
                    preferred_element_type=ext.dtype).reshape(-1)
        else:
            new_panels = diag_store
        ext = self._write_panels(ext, lb, new_panels)
        return ext, (x if want_below else prod)

    @staticmethod
    def _embed_inv(L, Linv, pad_eye):
        """Stored diag block: L on/below the diagonal (minus the padding
        identity so padded slots stay zero), Linv^T strictly above it.
        The strict upper of a diagonal block is dead storage in the
        coalesced layout (densify/tests only read the lower half), so the
        factor ships its own inverse for free."""
        cp = L.shape[1]
        i_ = jax.lax.broadcasted_iota(jnp.int32, (1, cp, cp), 1)
        j_ = jax.lax.broadcasted_iota(jnp.int32, (1, cp, cp), 2)
        lower = jnp.where(i_ >= j_, L - pad_eye, 0.0)
        upper = jnp.where(i_ < j_, jnp.swapaxes(Linv, 1, 2), 0.0)
        return lower + upper

    def _apply_pairs(self, ext, flat, pair_buckets, aux):
        """Subtract all run blocks from the product buffer into the factor
        via elementwise block scatter-adds over the (rs x cs) rectangles
        with per-pair target strides. Exact-shape groups carry no padding:
        no mask, no clip, no trash redirection. Descriptor arrays arrive
        via `aux` (runtime operands)."""
        for pb in pair_buckets:
            (sb_, ss_, rs_, cs_, c0_, tr_,
             ts_) = aux[pb.aux_slot:pb.aux_slot + 7]
            csp = pb.csp
            r = jax.lax.broadcasted_iota(jnp.int32, (1, pb.rsp, csp), 1)
            c = jax.lax.broadcasted_iota(jnp.int32, (1, pb.rsp, csp), 2)
            src = sb_[:, None, None] + r * ss_[:, None, None] + c
            tgt = tr_[:, None, None] + c0_[:, None, None] + \
                r * ts_[:, None, None] + c
            if pb.exact:  # every (r, c) lane is real: no mask needed
                ext = ext.at[tgt].add(-flat[src])
            else:
                vals = flat[jnp.clip(src, 0, flat.shape[0] - 1)]
                mask = (r < rs_[:, None, None]) & \
                    (c < cs_[:, None, None])
                trash = ext.shape[0] - 2
                ext = ext.at[jnp.where(mask, tgt, trash)].add(-vals)
        return ext

    @staticmethod
    def _register_aux(pair_buckets, aux):
        """Assign aux slots for pair-bucket descriptor arrays."""
        for pb in pair_buckets:
            pb.aux_slot = len(aux)
            ts = pb.tgt_stride if pb.tgt_stride is not None \
                else np.zeros(1, np.int32)
            aux.extend([pb.src_base, pb.src_stride, pb.rs, pb.cs,
                        pb.c0, pb.tgt_row_start, ts])

    # ------------------------------------------------------------------
    # public builders (same interface as UnrolledBackend)
    # ------------------------------------------------------------------
    def _register_factor_level(self, level, aux_np) -> int:
        """Register one factor level's aux arrays (pair-bucket descriptors
        plus dense-path slot tables); returns the scan-window margin the
        level needs at the end of the data vector."""
        lump_buckets, pair_buckets, _, dense = level
        max_win = 2
        self._register_aux(pair_buckets, aux_np)
        if dense is not None:
            dense["slots"] = {}
            for bi, rm in enumerate(dense["row_maps"]):
                if rm is None:
                    continue
                dense["slots"][bi] = len(aux_np)
                aux_np.append(rm)
            dense["gslots"] = {}
            for key, items in dense["groups"].items():
                dense["gslots"][key] = len(aux_np)
                aux_np.append(_i32(np.array(items)))  # (nc, 2): b0, lo
            dense["sslots"] = []
            for rsp, st, desc in dense["slice_scans"]:
                dense["sslots"].append((rsp, st, len(aux_np)))
                aux_np.append(desc)  # (S, 6) per-slice descriptors
                max_win = max(max_win, rsp * st)
            sg = dense.get("sg")
            if sg is not None:
                sg["slots"] = {}
                for bi, m in sg["maps"].items():
                    sg["slots"][bi] = len(aux_np)
                    aux_np.append(m)
                sg["gslots"] = {}
                for key, items in sg["groups"].items():
                    sg["gslots"][key] = len(aux_np)
                    aux_np.append(_i32(np.array(items)))  # (nc, 2): b0, slo
        return max_win

    def _run_factor_level(self, ext, level, aux):
        """Execute one complete factor level inside a jit trace (shared by
        make_factor and the per-op profiler, so profiling replays levels
        with the exact numeric semantics — including the dense compact-U
        path)."""
        lump_buckets, pair_buckets, ptot, dense = level
        if dense is not None:
            ext = self._run_dense_level(ext, lump_buckets, pair_buckets,
                                        dense, aux)
            return ext
        prods = []
        for lb in lump_buckets:
            ext, prod = self._factor_bucket(ext, lb)
            if prod is not None:
                prods.append(prod)
        if prods:
            flat = jnp.concatenate(prods) if len(prods) > 1 else prods[0]
            ext = self._apply_pairs(ext, flat, pair_buckets, aux)
        return ext

    def make_factor(self, start_lump: int, end_lump: int):
        sched = self._factor_schedule(start_lump, end_lump)
        sk = self.plan.skel
        dsize = sk.data_size
        mask = sk.padding_mask()
        need_mask = bool(np.any(mask == 0))
        aux_np = []
        mask_slot = None
        if need_mask:
            mask_slot = len(aux_np)
            aux_np.append(mask)
        max_win = 2
        for level in sched:
            max_win = max(max_win, self._register_factor_level(level,
                                                               aux_np))

        def factor(data, aux):
            if need_mask:  # padding must hold zeros (see block_matrix.py)
                data = data * aux[mask_slot].astype(data.dtype)
            # tail padding also absorbs window-scatter overruns (padded
            # run rows) so XLA's index clamping never shifts a window
            ext = jnp.concatenate([data, jnp.zeros(max_win, data.dtype)])
            for level in sched:
                ext = self._run_factor_level(ext, level, aux)
            return ext[:dsize]

        return factor, aux_np

    def _build_w(self, dtype, dense, lump_buckets, panels, aux,
                 slots=None):
        """Materialize W (R x Kp): scatter each bucket's (B, rows, cp)
        panels to their compact row positions; bucket bi's columns start
        at col_base[bi]. Row maps carry the R sentinel on padding rows —
        those land in W's sacrificial last row. Returns W[:R]."""
        R, Kp = dense["R"], dense["Kp"]
        if slots is None:
            slots = dense["slots"]
        W = jnp.zeros((R + 1) * Kp, dtype)
        for bi, base in dense["col_base"].items():
            if bi not in panels:
                continue
            x = panels[bi]
            lb = lump_buckets[bi]
            rc = aux[slots[bi]]  # (B, rp) int32, R = sentinel
            colb = jnp.asarray(base +
                               np.arange(len(lb.off), dtype=np.int32) *
                               lb.cp)
            ci = jax.lax.broadcasted_iota(jnp.int32, (1, 1, lb.cp), 2)
            idx = rc[:, :, None] * Kp + colb[:, None, None] + ci
            W = W.at[idx].set(x, indices_are_sorted=False,
                              unique_indices=True)
        return W.reshape(R + 1, Kp)[:R]

    def _apply_dense_slices(self, ext, dense, U, ulc, aux):
        """Subtract the compact update U into target panels: unrolled
        contiguous chain-run slices, then scanned same-shape groups."""
        for off, rows, st, c0, wc, gr0, gc0 in dense["slices"]:
            region = jax.lax.dynamic_slice_in_dim(
                ext, off, rows * st).reshape(rows, st)
            region = region.at[:, c0:c0 + wc].add(
                -U[gr0:gr0 + rows, ulc + gc0:ulc + gc0 + wc])
            ext = jax.lax.dynamic_update_slice_in_dim(
                ext, region.reshape(-1), off, axis=0)
        # fragmented targets: same-padded-shape slice groups under
        # lax.scan — masked full-stride window RMWs
        for rsp, st, slot in dense["sslots"]:
            desc = aux[slot]

            def slice_step(ext, d, rsp=rsp, st=st, U=U, ulc=ulc):
                off, c0, gr0, gc0c, rows, wc = (
                    d[0], d[1], d[2], d[3], d[4], d[5])
                region = jax.lax.dynamic_slice_in_dim(
                    ext, off, rsp * st).reshape(rsp, st)
                usub = jax.lax.dynamic_slice(
                    U, (gr0, ulc + gc0c), (rsp, st))
                ri = jax.lax.broadcasted_iota(jnp.int32, (rsp, st), 0)
                ci = jax.lax.broadcasted_iota(jnp.int32, (rsp, st), 1)
                m = (ri < rows) & (ci >= c0) & (ci < c0 + wc)
                region = region - jnp.where(m, usub, 0.0)
                return jax.lax.dynamic_update_slice_in_dim(
                    ext, region.reshape(-1), off, axis=0), None

            ext, _ = jax.lax.scan(slice_step, ext, desc)
        return ext

    def _run_dense_level(self, ext, lump_buckets, pair_buckets, dense,
                         aux):
        """Factor each bucket and IMMEDIATELY fold its update contribution
        into the compact accumulator (flat W in w-mode, U otherwise) so at
        most one bucket's solved below panels are live at a time — at BAL
        scale a level's below tensors need not all coexist in device
        memory. Then subtract U into targets
        via contiguous chain-run slices (see _build_dense_update)."""
        R = dense["R"]
        # margins let scanned slice reads use full-stride
        # windows anchored at gc0 - c0 without going OOB
        upr, ulc, urc = dense["u_pads"]
        mode_w = dense.get("mode") == "w"
        sgp = dense.get("sg")
        if mode_w:
            acc = jnp.zeros((R + 1) * dense["Kp"], ext.dtype)  # flat W
        else:
            acc = jnp.zeros((R + upr, ulc + R + urc), ext.dtype)  # U
        out_by_bi: Dict[int, list] = {}
        for bi, idxs, _bidx in dense["out_groups"]:
            out_by_bi.setdefault(bi, []).append(idxs)
        out_prods = []  # out_groups is sorted by bi: order preserved
        for bi, lb in enumerate(lump_buckets):
            ext, x = self._factor_bucket(ext, lb, want_below=True)
            if x is None:
                continue
            if mode_w:
                acc = self._scatter_w_bucket(acc, dense, bi, lb, x, aux)
            elif sgp is not None:
                acc = self._accum_sg_bucket(acc, ulc, dense, lb, bi, x,
                                            aux)
            else:
                acc = self._accum_oh_bucket(acc, ulc, dense, lb, bi, x,
                                            aux, R)
            for idxs in out_by_bi.get(bi, ()):  # outlier origins
                xo = x[jnp.asarray(idxs)]
                out_prods.append(jnp.einsum(
                    "brk,bsk->brs", xo, xo,
                    preferred_element_type=ext.dtype).reshape(-1))
        if mode_w:
            # U = W W^T as a single GEMM
            Wm = acc.reshape(R + 1, dense["Kp"])[:R]
            U_core = jnp.einsum("rk,sk->rs", Wm, Wm,
                                preferred_element_type=ext.dtype,
                                precision=self._upd_prec())
            if (upr, ulc, urc) == (0, 0, 0):
                U = U_core
            else:
                U = jnp.zeros((R + upr, ulc + R + urc), ext.dtype)
                U = jax.lax.dynamic_update_slice(U, U_core, (0, ulc))
        else:
            U = acc
            if sgp is not None and sgp["tri"] is not None:
                # mirror the accumulated lower block-triangle once
                tri = sgp["tri"]
                for ai, (a0, a1) in enumerate(tri):
                    for (c0, c1) in tri[:ai]:
                        U = U.at[c0:c1, ulc + a0:ulc + a1].set(
                            U[a0:a1, ulc + c0:ulc + c1].T)
        ext = self._apply_dense_slices(ext, dense, U, ulc, aux)
        if pair_buckets:  # outlier origins: block-pair path
            flat = jnp.concatenate(out_prods) if len(out_prods) > 1 \
                else out_prods[0]
            ext = self._apply_pairs(ext, flat, pair_buckets, aux)
        return ext

    def _scatter_w_bucket(self, W, dense, bi, lb, x, aux):
        """Scatter one bucket's (B, rp, cp) solved below panels into the
        flat W accumulator at their compact row positions (row map
        sentinel rows land in W's sacrificial last row)."""
        base = dense["col_base"][bi]
        Kp = dense["Kp"]
        rc = aux[dense["slots"][bi]]  # (B, rp) int32, R = sentinel
        colb = jnp.asarray(base + np.arange(len(lb.off), dtype=np.int32) *
                           lb.cp)
        ci = jax.lax.broadcasted_iota(jnp.int32, (1, 1, lb.cp), 2)
        idx = rc[:, :, None] * Kp + colb[:, None, None] + ci
        return W.at[idx].set(x, indices_are_sorted=False,
                             unique_indices=True)

    def _accum_oh_bucket(self, U, ulc, dense, lb, bi, x, aux, R):
        """One bucket's chunk-scanned one-hot U accumulation (oh mode)."""
        for (bj, nb, subp), items in dense["groups"].items():
            if bj != bi:
                continue
            rows_c = aux[dense["slots"][bi]]
            padB = dense["pad_b"][bi]
            xb = x
            if padB > xb.shape[0]:
                padn = padB - xb.shape[0]
                xb = jnp.concatenate(
                    [xb, jnp.zeros((padn,) + xb.shape[1:], xb.dtype)])
                rows_c = jnp.concatenate(
                    [rows_c,
                     jnp.full((padn, rows_c.shape[1]), R, jnp.int32)])
            # 2-D scan operand: see _accum_sg_bucket
            rp_, cp_ = xb.shape[1], xb.shape[2]
            x2 = xb.reshape(xb.shape[0], rp_ * cp_)
            b0lo = aux[dense["gslots"][(bi, nb, subp)]]

            def chunk_step(U, b0lo, x2=x2, rows_c=rows_c,
                           nb=nb, subp=subp, rp_=rp_, cp_=cp_):
                b0, lo = b0lo[0], b0lo[1]
                xc = jax.lax.dynamic_slice_in_dim(
                    x2, b0, nb).reshape(nb, rp_, cp_)
                rc = jax.lax.dynamic_slice_in_dim(
                    rows_c, b0, nb)
                ids = lo + jax.lax.broadcasted_iota(
                    jnp.int32, (1, 1, subp), 2)
                oh = (rc[:, :, None] == ids).astype(x.dtype)
                y = jnp.einsum(
                    "bir,bic->brc", oh, xc,
                    preferred_element_type=x.dtype)
                usub = jnp.einsum(
                    "brc,bsc->rs", y, y,
                    preferred_element_type=x.dtype,
                    precision=self._upd_prec())
                Uc = jax.lax.dynamic_slice(
                    U, (lo, ulc + lo), (subp, subp))
                return jax.lax.dynamic_update_slice(
                    U, Uc + usub, (lo, ulc + lo)), None

            U, _ = jax.lax.scan(chunk_step, U, b0lo)
        return U

    def _accum_sg_bucket(self, U, ulc, dense, lb, bi, x, aux):
        """Span-granular U accumulation of ONE bucket (see _plan_sg): per
        chunk, place each origin's below panel by SPAN via a one-hot
        einsum, then one GEMM accumulates the chunk's contribution.
        Full-space chunks accumulate only a lower block-triangle; the
        caller mirrors it once after ALL buckets (every contribution is
        block-triangular in that regime, so the mirror reconstructs the
        exact symmetric U)."""
        sgp = dense["sg"]
        s3, S, tri = sgp["s3"], sgp["S"], sgp["tri"]
        R = dense["R"]
        for (bj, nb, ssub) in sgp["groups"]:
            if bj != bi:
                continue
            sc = aux[sgp["slots"][bi]]
            ns3p = sc.shape[1]
            padB = sgp["pad_b"][bi]
            if padB > x.shape[0]:
                pn = padB - x.shape[0]
                x = jnp.concatenate(
                    [x, jnp.zeros((pn,) + x.shape[1:], x.dtype)])
                sc = jnp.concatenate(
                    [sc, jnp.full((pn, ns3p), S, jnp.int32)])
            rp3 = ns3p * s3
            if rp3 > x.shape[1]:
                x = jnp.concatenate(
                    [x, jnp.zeros((x.shape[0], rp3 - x.shape[1],
                                   x.shape[2]), x.dtype)], axis=1)
            # keep the scan operand 2-D: the 4-D (B, ns3p, s3, cp) view
            # is taken per CHUNK inside the scan body, so no layout pass
            # ever materializes the whole tensor with tiny minor dims
            x2 = x.reshape(x.shape[0], rp3 * lb.cp)
            b0lo = aux[sgp["gslots"][(bi, nb, ssub)]]

            def chunk_step(U, b0lo, x2=x2, sc=sc, nb=nb, ssub=ssub,
                           ns3p=ns3p, cp=lb.cp):
                b0, slo = b0lo[0], b0lo[1]
                xc = jax.lax.dynamic_slice_in_dim(
                    x2, b0, nb).reshape(nb, ns3p, s3, cp)
                scc = jax.lax.dynamic_slice_in_dim(sc, b0, nb)
                ids = slo + jax.lax.broadcasted_iota(
                    jnp.int32, (1, 1, ssub), 2)
                oh = (scc[:, :, None] == ids).astype(xc.dtype)
                y = jnp.einsum("bns,bnic->bsic", oh, xc,
                               preferred_element_type=xc.dtype)
                ym = y.reshape(nb, ssub * s3, cp)
                if tri is not None and ssub == S:
                    for ai, (a0, a1) in enumerate(tri):
                        for (c0, c1) in tri[:ai + 1]:
                            us = jnp.einsum(
                                "bmc,bnc->mn", ym[:, a0:a1], ym[:, c0:c1],
                                preferred_element_type=xc.dtype,
                                precision=self._upd_prec())
                            U = U.at[a0:a1, ulc + c0:ulc + c1].add(us)
                    return U, None
                us = jnp.einsum("bmc,bnc->mn", ym, ym,
                                preferred_element_type=xc.dtype,
                                precision=self._upd_prec())
                lo = slo * s3
                Uc = jax.lax.dynamic_slice(
                    U, (lo, ulc + lo), (ssub * s3, ssub * s3))
                return jax.lax.dynamic_update_slice(
                    U, Uc + us, (lo, ulc + lo)), None

            U, _ = jax.lax.scan(chunk_step, U, b0lo)
        if tri is not None:
            for ai, (a0, a1) in enumerate(tri):
                for (c0, c1) in tri[:ai]:
                    U = U.at[c0:c1, ulc + a0:ulc + a1].set(
                        U[a0:a1, ulc + c0:ulc + c1].T)
        return U

    # ------------------------------------------------------------------
    # multi-chip: ONE factorization sharded over a device mesh
    # ------------------------------------------------------------------
    # Each level's batched panel work (potrf/trsm — and the level-update
    # FLOPs: per-origin syge products, partial W W^T, one-hot chunk GEMMs)
    # splits across mesh devices; per level one all_gather shares the
    # factored panels (every device holds the full replicated data vector)
    # and, on dense levels, one psum reduces the compact update U. This
    # has no reference counterpart (the reference is single-node):
    # supernode-level model parallelism across the cards of one host.
    SHARD_MIN_B = 2  # buckets with B < n_shards*this run replicated

    def _register_factor_level_sharded(self, level, aux_np, N) -> int:
        """Register the level's standard aux plus shard descriptors:
        padded per-bucket geometry, padded w-mode row maps, padded+
        sentineled oh-mode chunk items."""
        max_win = self._register_factor_level(level, aux_np)
        lump_buckets, pair_buckets, ptot, dense = level
        for bi, lb in enumerate(lump_buckets):
            B = len(lb.off)
            if B < N * self.SHARD_MIN_B:
                lb.shard = None
                continue
            Bs = -(-B // N)
            padn = N * Bs - B
            # pad with member 0 (real SPD panel: cholesky stays finite;
            # padded results are trimmed before any write)
            offp = np.concatenate([lb.off, np.repeat(lb.off[:1], padn)])
            colsp = np.concatenate([lb.cols, np.repeat(lb.cols[:1], padn)])
            lb.shard = (Bs, len(aux_np))
            aux_np.extend([_i32(offp), _i32(colsp)])
            if dense is not None and dense.get("mode") == "w" and \
                    bi in dense.get("col_base", {}):
                rc = dense["row_maps"][bi]
                rcp = np.concatenate([
                    rc, np.full((padn, rc.shape[1]), dense["R"],
                                np.int32)])
                lb.shard_rc = len(aux_np)
                aux_np.append(_i32(rcp))
        if dense is not None and dense.get("mode") == "oh":
            # chunk items pad to a multiple of N with sentinel chunks
            # pointing at all-R rows of the (extended) row map — their
            # one-hot is identically zero, so they contribute nothing
            dense["gslots_sh"] = {}
            dense["xpad_sh"] = {}
            for (bi, nb, subp), items in dense["groups"].items():
                B = len(lump_buckets[bi].off)
                padB = dense["pad_b"][bi]
                xpad = max(padB, B) + nb
                dense["xpad_sh"][bi] = max(dense["xpad_sh"].get(bi, 0),
                                           xpad)
                nc = len(items)
                ncp = -(-nc // N) * N
                itp = np.array(items + [(B, 0)] * (ncp - nc),
                               dtype=np.int32)
                dense["gslots_sh"][(bi, nb, subp)] = len(aux_np)
                aux_np.append(itp)
        return max_win

    def _factor_bucket_sharded(self, ext, lb, axis_name, N, idx, aux,
                               want_below):
        """Factor my shard of the bucket's panels, all_gather the
        results, write the full set back. Returns (ext, x_local,
        x_full)."""
        B = len(lb.off)
        Bs, slot = lb.shard
        offp, colsp = aux[slot], aux[slot + 1]
        my_off = jax.lax.dynamic_slice_in_dim(offp, idx * Bs, Bs)
        my_cols = jax.lax.dynamic_slice_in_dim(colsp, idx * Bs, Bs)
        h = lb.cp + lb.rp
        gnums = jax.lax.GatherDimensionNumbers(
            offset_dims=(1,), collapsed_slice_dims=(),
            start_index_map=(0,))
        flat = jax.lax.gather(ext, my_off[:, None], gnums,
                              slice_sizes=(h * lb.cp,))
        panels = flat.reshape(Bs, h, lb.cp)
        pad_eye = self._pad_eye(my_cols, lb.cp, ext.dtype)
        diag_in = panels[:, :lb.cp] + pad_eye
        below_in = panels[:, lb.cp:] if lb.rp > 0 else None
        L, x, Linv = self._factor_panels(diag_in, below_in, lb.cp,
                                         ext.dtype)
        diag_store = self._embed_inv(L, Linv, pad_eye)
        newp = jnp.concatenate([diag_store, x], axis=1) \
            if x is not None else diag_store
        allp = jax.lax.all_gather(newp, axis_name)
        full = allp.reshape(N * Bs, h, lb.cp)[:B]
        ext = self._write_panels(ext, lb, full)
        x_full = full[:, lb.cp:] if lb.rp > 0 else None
        return ext, x, x_full

    def _run_factor_level_sharded(self, ext, level, aux, axis_name, N):
        lump_buckets, pair_buckets, ptot, dense = level
        idx = jax.lax.axis_index(axis_name)
        if dense is None:
            prods = []
            for lb in lump_buckets:
                if lb.shard is None:
                    ext, prod = self._factor_bucket(ext, lb)
                    if prod is not None:
                        prods.append(prod)
                    continue
                ext, x, _xf = self._factor_bucket_sharded(
                    ext, lb, axis_name, N, idx, aux, False)
                if lb.rp > 0:
                    # per-origin products computed on my shard only
                    prod_d = jnp.einsum("brk,bsk->brs", x, x,
                                        preferred_element_type=ext.dtype)
                    allp = jax.lax.all_gather(prod_d, axis_name)
                    B = len(lb.off)
                    prods.append(allp.reshape(
                        N * x.shape[0], lb.rp, lb.rp)[:B].reshape(-1))
            if prods:
                flat = jnp.concatenate(prods) if len(prods) > 1 \
                    else prods[0]
                ext = self._apply_pairs(ext, flat, pair_buckets, aux)
            return ext

        R = dense["R"]
        xs_local, xs_full, sharded = {}, {}, {}
        for bi, lb in enumerate(lump_buckets):
            if lb.shard is None:
                ext, x = self._factor_bucket(ext, lb, want_below=True)
                if x is not None:
                    xs_local[bi] = x
                    xs_full[bi] = x
                    sharded[bi] = False
                continue
            ext, x, xf = self._factor_bucket_sharded(
                ext, lb, axis_name, N, idx, aux, True)
            if lb.rp > 0:
                xs_local[bi] = x
                xs_full[bi] = xf
                sharded[bi] = True
        upr, ulc, urc = dense["u_pads"]
        if dense.get("mode") == "w":
            Kp = dense["Kp"]
            W = jnp.zeros((R + 1) * Kp, ext.dtype)
            onshard0 = (idx == 0).astype(ext.dtype)
            for bi, base in dense["col_base"].items():
                if bi not in xs_local:
                    continue
                lb = lump_buckets[bi]
                ci = jax.lax.broadcasted_iota(jnp.int32, (1, 1, lb.cp), 2)
                if sharded[bi]:
                    Bs = lb.shard[0]
                    rc = jax.lax.dynamic_slice_in_dim(
                        aux[lb.shard_rc], idx * Bs, Bs)
                    colb = base + (idx * Bs + jnp.arange(
                        Bs, dtype=jnp.int32)) * lb.cp
                    x = xs_local[bi]
                else:
                    # replicated bucket: contribute on shard 0 only
                    rc = aux[dense["slots"][bi]]
                    colb = jnp.asarray(base + np.arange(
                        len(lb.off), dtype=np.int32) * lb.cp)
                    x = xs_local[bi] * onshard0
                flat_idx = jnp.clip(
                    rc[:, :, None] * Kp + colb[:, None, None] + ci,
                    0, (R + 1) * Kp - 1)
                W = W.at[flat_idx].set(x)
            Wm = W.reshape(R + 1, Kp)[:R]
            U_core = jnp.einsum("rk,sk->rs", Wm, Wm,
                                preferred_element_type=ext.dtype,
                                precision=self._upd_prec())
            U_core = jax.lax.psum(U_core, axis_name)
            if (upr, ulc, urc) == (0, 0, 0):
                U = U_core
            else:
                U = jnp.zeros((R + upr, ulc + R + urc), ext.dtype)
                U = jax.lax.dynamic_update_slice(U, U_core, (0, ulc))
        else:
            # oh mode: chunk scans shard by chunk index; psum the U
            U = jnp.zeros((R + upr, ulc + R + urc), ext.dtype)
            for (bi, nb, subp), _items in dense["groups"].items():
                lb = lump_buckets[bi]
                x = xs_full[bi]
                rows_c = aux[dense["slots"][bi]]
                xpad = dense["xpad_sh"][bi]
                if xpad > x.shape[0]:
                    pn = xpad - x.shape[0]
                    x = jnp.concatenate(
                        [x, jnp.zeros((pn,) + x.shape[1:], x.dtype)])
                    rows_c = jnp.concatenate(
                        [rows_c, jnp.full((pn, rows_c.shape[1]), R,
                                          jnp.int32)])
                itp = aux[dense["gslots_sh"][(bi, nb, subp)]]
                ncp = itp.shape[0]
                Is = ncp // N
                my_items = jax.lax.dynamic_slice_in_dim(itp, idx * Is, Is)

                def chunk_step(U, b0lo, x=x, rows_c=rows_c, nb=nb,
                               subp=subp):
                    b0, lo = b0lo[0], b0lo[1]
                    xc = jax.lax.dynamic_slice_in_dim(x, b0, nb)
                    rc = jax.lax.dynamic_slice_in_dim(rows_c, b0, nb)
                    ids = lo + jax.lax.broadcasted_iota(
                        jnp.int32, (1, 1, subp), 2)
                    oh = (rc[:, :, None] == ids).astype(x.dtype)
                    y = jnp.einsum("bir,bic->brc", oh, xc,
                                   preferred_element_type=x.dtype)
                    usub = jnp.einsum("brc,bsc->rs", y, y,
                                      preferred_element_type=x.dtype,
                                      precision=self._upd_prec())
                    Uc = jax.lax.dynamic_slice(
                        U, (lo, ulc + lo), (subp, subp))
                    return jax.lax.dynamic_update_slice(
                        U, Uc + usub, (lo, ulc + lo)), None

                U, _ = jax.lax.scan(chunk_step, U, my_items)
            U = jax.lax.psum(U, axis_name)
        ext = self._apply_dense_slices(ext, dense, U, ulc, aux)
        if pair_buckets:  # outlier origins (oh mode): replicated
            prods = []
            for bi, idxs, _bidx in dense["out_groups"]:
                xo = xs_full[bi][jnp.asarray(idxs)]
                prods.append(jnp.einsum(
                    "brk,bsk->brs", xo, xo,
                    preferred_element_type=ext.dtype).reshape(-1))
            flat = jnp.concatenate(prods) if len(prods) > 1 else prods[0]
            ext = self._apply_pairs(ext, flat, pair_buckets, aux)
        return ext

    def make_factor_sharded(self, start_lump: int, end_lump: int,
                            axis_name: str, n_shards: int):
        """Factor function to run INSIDE shard_map over a 1-D mesh axis:
        `data` replicated in, replicated factor out."""
        sched = self._factor_schedule(start_lump, end_lump)
        sk = self.plan.skel
        dsize = sk.data_size
        mask = sk.padding_mask()
        need_mask = bool(np.any(mask == 0))
        aux_np = []
        mask_slot = None
        if need_mask:
            mask_slot = len(aux_np)
            aux_np.append(mask)
        max_win = 2
        for level in sched:
            max_win = max(max_win, self._register_factor_level_sharded(
                level, aux_np, n_shards))

        def factor(data, aux):
            if need_mask:
                data = data * aux[mask_slot].astype(data.dtype)
            ext = jnp.concatenate([data, jnp.zeros(max_win, data.dtype)])
            for level in sched:
                ext = self._run_factor_level_sharded(
                    ext, level, aux, axis_name, n_shards)
            return ext[:dsize]

        return factor, aux_np

    # -- solve ----------------------------------------------------------
    def _bucket_xidx(self, sb: LumpBucket, order):
        cols = jnp.asarray(sb.cols)
        xr = jax.lax.broadcasted_iota(jnp.int32, (1, sb.cp), 1)
        return jnp.where(xr < cols[:, None],
                         jnp.asarray(sb.vec_off)[:, None] + xr, order)

    def _tri(self, L, x, transpose):
        if L.shape[1] <= self.UNROLL_CP:
            # tiny widths: closed-form inverse + batched matmul (the
            # tiny-panel route of _factor_panels)
            Linv = self._unrolled_lower_inv(L)
            eq = "bji,bjn->bin" if transpose else "bij,bjn->bin"
            return jnp.einsum(eq, Linv, x,
                              preferred_element_type=x.dtype)
        if L.shape[1] > self.SOLVE_BLOCK:
            return self._big_panel_solve(L, x, transpose)
        return jax.lax.linalg.triangular_solve(
            L, x, left_side=True, lower=True, transpose_a=transpose)

    def _tri_stored(self, P, cols, x, transpose):
        """Diagonal solve against the inverse the factor embedded in the
        stored diag block (see _embed_inv): reconstruct Linv = strict
        upper transposed + 1/diag, then ONE batched matmul — no
        triangular_solve primitive anywhere in the hot solve program."""
        cp = P.shape[1]
        i_ = jax.lax.broadcasted_iota(jnp.int32, (1, cp, cp), 1)
        j_ = jax.lax.broadcasted_iota(jnp.int32, (1, cp, cp), 2)
        d = jnp.diagonal(P, axis1=1, axis2=2)
        ri = jax.lax.broadcasted_iota(jnp.int32, (1, cp), 1)
        dinv = jnp.where(ri < jnp.asarray(cols)[:, None], 1.0 / d, 1.0)
        Linv = jnp.where(i_ > j_, jnp.swapaxes(P, 1, 2),
                         jnp.where(i_ == j_, dinv[:, :, None], 0.0))
        eq = "bji,bjn->bin" if transpose else "bij,bjn->bin"
        return jnp.einsum(eq, Linv, x, preferred_element_type=x.dtype)

    def _diag_solve(self, ext, vv, sb: LumpBucket, order, transpose,
                    bidx=None, dx=None, ret_xb=False, use_inv=False):
        """One bucket's diagonal solve. `bidx` (below-row RHS positions)
        enables the scatter-based below update; dense levels pass None and
        route below updates through compact accumulators instead.
        `use_inv` selects the stored-inverse matmul path (valid only on
        data produced by this backend's factor, which embeds Linv in the
        diag block's strict upper — pseudo-factored data doesn't)."""
        cp = sb.cp
        # fusion fence on the RHS vector: same scatter->gather chain
        # compile blow-up as _factor_bucket (see comment there), on vv
        # instead of ext (a 5k-lump Schur solve program)
        vv = jax.lax.optimization_barrier(vv)
        panels = self._read_panels(ext, sb)
        if not use_inv:
            L = panels[:, :cp] + self._pad_eye(sb.cols, cp, ext.dtype)
        below = panels[:, cp:] if sb.rp > 0 else None
        rcnt = getattr(sb, "row_cnt", None)
        if below is not None and rcnt is not None:
            # fused-bucket overread rows hold the NEXT panel's memory;
            # zero them so they can't dirty the sentinel row (L pass) or
            # multiply it back into real rows (Lt pass of the same vv)
            ri = jax.lax.broadcasted_iota(jnp.int32, (1, sb.rp, 1), 1)
            below = jnp.where(ri < jnp.asarray(rcnt)[:, None, None],
                              below, 0.0)
        xidx = self._bucket_xidx(sb, order)
        x = vv[xidx]
        if dx is not None:  # dense-path transpose correction
            x = x - dx
        if transpose and below is not None and bidx is not None:
            tmp = vv[bidx]
            x = x - jnp.einsum("brk,brn->bkn", below, tmp,
                               preferred_element_type=vv.dtype)
        x0 = x
        if use_inv:
            x = self._tri_stored(panels[:, :cp], sb.cols, x, transpose)
        else:
            x = self._tri(L, x, transpose)
        if not transpose and below is not None and bidx is not None:
            # one fused scatter-add (see _scan_solve_step)
            y = jnp.einsum("brk,bkn->brn", below, x,
                           preferred_element_type=vv.dtype)
            idx = jnp.concatenate([xidx, bidx], axis=1)
            upd = jnp.concatenate([x - x0, -y], axis=1)
            vv = vv.at[idx].add(upd)
        else:
            vv = vv.at[xidx].set(x)
        if ret_xb:
            return vv, x, below
        return vv

    def _solve_aux(self, sched):
        aux_np = []
        for buckets in sched:
            for sb in buckets:
                if sb.rp > 0:
                    sb.aux_slot = len(aux_np)
                    aux_np.append(sb.below_idx)
        return aux_np

    def _full_range(self, start_lump: int, end_lump: int) -> bool:
        """Stored-inverse solves only apply to the full factor range:
        partial solves also run on pseudo-factored data (Gauss-Seidel
        preconditioner), which carries no embedded inverse."""
        return start_lump == 0 and end_lump == self.plan.skel.num_lumps

    def make_solve_l(self, start_lump: int, end_lump: int):
        sched = self._solve_schedule(start_lump, end_lump)
        order = self.plan.skel.order
        aux_np = self._solve_aux(sched)
        use_inv = self._full_range(start_lump, end_lump)

        def solve_l(data, v, aux):
            ext = jnp.concatenate([data, jnp.zeros(2, data.dtype)])
            vv = jnp.concatenate([v, jnp.zeros((1, v.shape[1]), v.dtype)])
            for buckets in sched:
                for sb in buckets:
                    bidx = aux[sb.aux_slot] if sb.rp > 0 else None
                    vv = self._diag_solve(ext, vv, sb, order, False, bidx,
                                          use_inv=use_inv)
            return vv[:order]

        return solve_l, aux_np

    def make_solve_lt(self, start_lump: int, end_lump: int):
        sched = self._solve_schedule(start_lump, end_lump)
        order = self.plan.skel.order
        aux_np = self._solve_aux(sched)
        use_inv = self._full_range(start_lump, end_lump)

        def solve_lt(data, v, aux):
            ext = jnp.concatenate([data, jnp.zeros(2, data.dtype)])
            vv = jnp.concatenate([v, jnp.zeros((1, v.shape[1]), v.dtype)])
            for buckets in reversed(sched):
                for sb in buckets:
                    bidx = aux[sb.aux_slot] if sb.rp > 0 else None
                    vv = self._diag_solve(ext, vv, sb, order, True, bidx,
                                          use_inv=use_inv)
            return vv[:order]

        return solve_lt, aux_np

    # -- scan-folded solve levels ---------------------------------------
    SCAN_WASTE = 8.0  # padded/actual volume cap when folding levels
    SCAN_CP_MAX = 16  # row-granular gathers are modeled cheap only for
    #                   short rows; wide levels stay unrolled on
    #                   contiguous panel reads instead (carried over
    #                   unmeasured on the current GPU target)
    # modeled costs for the fold-vs-unroll decision (carried over
    # unmeasured on the current GPU target): the scan pays Bp*(cpm+rpm)
    # PADDED gather+scatter rows per step, while unrolled levels touch
    # only actual rows (and contiguous buckets read panels as plain
    # slices). Folding only wins on deep chains of small levels where
    # per-bucket op overhead dominates padded rows.
    SOLVE_OP_US = 17e-6      # per sequential solve-op inside the program
    SOLVE_DIAG_OPS = 8.0     # XLA ops per unrolled bucket diag-solve
    SOLVE_SCAN_STEP_OPS = 12.0
    GATHER_ROW_NS = 9e-9     # short-slice gather, per addressed row
    SCATTER_ROW_NS = 60e-9   # scatter, per addressed row

    def _scan_fold_pays(self, grp) -> bool:
        """Cost the group as ONE lax.scan vs unrolled levels (forward
        pass shape; the backward pass scales both sides similarly)."""
        L = len(grp)
        if L < 2:
            return False
        Bp = max(sum(len(lb.off) for lb in bs) for bs in grp)
        cpm = max(lb.cp for bs in grp for lb in bs)
        hm = max(lb.cp + lb.rp for bs in grp for lb in bs)
        scan = L * (self.SOLVE_SCAN_STEP_OPS * self.SOLVE_OP_US
                    + Bp * hm * self.GATHER_ROW_NS
                    + Bp * hm * self.SCATTER_ROW_NS)
        unroll = 0.0
        for bs in grp:
            fused = {}
            for lb in bs:
                fused[lb.cp] = True
                unroll += len(lb.off) * (
                    lb.cp + lb.rp) * self.SCATTER_ROW_NS + \
                    len(lb.off) * (0 if lb.contiguous
                                   else self.GATHER_ROW_NS * (lb.cp + lb.rp))
            unroll += len(fused) * self.SOLVE_DIAG_OPS * self.SOLVE_OP_US
        return scan < unroll

    def _partition_scan_groups(self, pend):
        """Greedy split of a run of consecutive plain solve levels (each a
        bucket list) so the common-padded scan volume stays within
        SCAN_WASTE x the actual panel volume."""
        def stats(levs):
            Bp = max(sum(len(lb.off) for lb in bs) for bs in levs)
            cpm = max(lb.cp for bs in levs for lb in bs)
            hm = max(lb.cp + lb.rp for bs in levs for lb in bs)
            act = sum(len(lb.off) * (lb.cp + lb.rp) * lb.cp
                      for bs in levs for lb in bs)
            return Bp, cpm, hm, act

        out, cur = [], []
        for item in pend:
            trial = cur + [item]
            Bp, cpm, hm, act = stats(trial)
            if cur and len(trial) * Bp * hm * cpm > self.SCAN_WASTE * act:
                out.append(cur)
                cur = [item]
            else:
                cur = trial
        if cur:
            out.append(cur)
        return out

    def _build_scan_group(self, levels):
        """Stack a run of consecutive solve levels into per-level index
        arrays of one common padded shape, so the run executes as ONE
        lax.scan instead of ~8 XLA ops per level (solve latency is
        modeled as per-op overhead bound). Panel rows are gathered
        row-granularly (start = panel offset + r*storage stride), which
        lets lumps of different storage widths share one tile: overread
        columns are masked to zero, absent rows point at the zero margin
        past the data. Requires the stored-inverse diag solve (_tri_stored)."""
        sk = self.plan.skel
        order = sk.order
        zoff = int(sk.data_size)
        Bp = max(sum(len(lb.off) for lb in bs) for bs in levels)
        cpm = max(lb.cp for bs in levels for lb in bs)
        rpm = max(lb.rp for bs in levels for lb in bs)
        hm = cpm + rpm
        L = len(levels)
        rstart = np.full((L, Bp * hm), zoff, dtype=np.int32)
        cols = np.zeros((L, Bp), dtype=np.int32)
        voff = np.full((L, Bp), order, dtype=np.int32)
        bidx = np.full((L, Bp, max(rpm, 1)), order, dtype=np.int32)
        for li, bs in enumerate(levels):
            rs = rstart[li].reshape(Bp, hm)
            i = 0
            for lb in bs:
                n = len(lb.off)
                cp, rp = lb.cp, lb.rp
                r = np.arange(cp, dtype=np.int32)
                rs[i:i + n, :cp] = lb.off[:, None] + r[None, :] * cp
                if rp > 0:
                    rb = np.arange(rp, dtype=np.int32)
                    rs[i:i + n, cpm:cpm + rp] = \
                        lb.off[:, None] + (cp + rb[None, :]) * cp
                    bidx[li, i:i + n, :rp] = lb.below_idx
                cols[li, i:i + n] = lb.cols
                voff[li, i:i + n] = lb.vec_off
                i += n
        return {"L": L, "Bp": Bp, "cpm": cpm, "rpm": rpm,
                "rstart": rstart, "cols": cols, "voff": voff,
                "bidx": bidx.reshape(L, -1)}

    def _scan_solve_step(self, ext, vv, inp, cpm, rpm, order, transpose):
        """One level of a scan-folded solve (body traced once per group)."""
        rst, cols, voff, bx = inp
        Bp = cols.shape[0]
        hm = cpm + rpm
        vv = jax.lax.optimization_barrier(vv)
        gnums = jax.lax.GatherDimensionNumbers(
            offset_dims=(1,), collapsed_slice_dims=(),
            start_index_map=(0,))
        tile = jax.lax.gather(ext, rst[:, None], gnums,
                              slice_sizes=(cpm,)).reshape(Bp, hm, cpm)
        jm = jax.lax.broadcasted_iota(jnp.int32, (1, 1, cpm), 2)
        tile = jnp.where(jm < cols[:, None, None], tile, 0.0)
        P = tile[:, :cpm]
        below = tile[:, cpm:] if rpm > 0 else None
        bx = bx.reshape(Bp, max(rpm, 1))
        xr = jax.lax.broadcasted_iota(jnp.int32, (1, cpm), 1)
        xidx = jnp.where(xr < cols[:, None], voff[:, None] + xr, order)
        x = vv[xidx]
        if transpose and below is not None:
            tmp = vv[bx]
            x = x - jnp.einsum("brk,brn->bkn", below, tmp,
                               preferred_element_type=vv.dtype)
        x1 = self._tri_stored(P, cols, x, transpose)
        if not transpose and below is not None:
            # one fused scatter-add: x rows as (x1 - x0) deltas + below
            # updates (disjoint targets except the sentinel row)
            y = jnp.einsum("brk,bkn->brn", below, x1,
                           preferred_element_type=vv.dtype)
            idx = jnp.concatenate([xidx, bx], axis=1)
            upd = jnp.concatenate([x1 - x, -y], axis=1)
            return vv.at[idx].add(upd)
        return vv.at[xidx].set(x1)

    # -- fused full solve (single XLA program: L pass + Lt pass) --------
    VEC_SLICE_UNROLL = 96

    def make_solve(self, start_lump: int, end_lump: int):
        """One jitted program for the whole solve. Three latency levers vs
        the per-level make_solve_l/make_solve_lt path (solve cost is
        modeled as per-XLA-op overhead dominated):
          * L and Lt passes share one program (panel gathers CSE'd),
          * same-width buckets of a level fuse into one batched op,
          * levels whose factor took the dense W路W^T path push/pull their
            below-row updates through the same one-hot chunk machinery
            (compact camera-space accumulators) instead of RHS scatters —
            on BA problems those scatters have thousands-deep collisions
            (every landmark hits the same few camera rows)."""
        fsched = self._factor_schedule(start_lump, end_lump)
        use_inv = self._full_range(start_lump, end_lump)
        sk = self.plan.skel
        order = sk.order
        aux_np = []
        levels = []
        margin = 2
        pend = []  # consecutive plain levels, folded into lax.scans

        def add_plain(lump_buckets):
            nonlocal margin
            fused = self._fuse_same_cp(lump_buckets)
            info = {"buckets": fused, "dense": None, "bidx": {}}
            for i, sb in enumerate(fused):
                if sb.rp > 0:
                    info["bidx"][i] = len(aux_np)
                    aux_np.append(sb.below_idx)
                if not sb.contiguous:
                    margin = max(margin, (sb.cp + sb.rp) * sb.cp)
            levels.append(info)

        def flush_plain():
            nonlocal margin
            if not pend:
                return
            for grp in self._partition_scan_groups(pend):
                if len(grp) == 1 or not self._scan_fold_pays(grp):
                    for bs in grp:
                        add_plain(bs)
                    continue
                sg = self._build_scan_group(grp)
                slots = []
                for k in ("rstart", "cols", "voff", "bidx"):
                    slots.append(len(aux_np))
                    aux_np.append(sg[k])
                margin = max(margin, sg["cpm"])
                levels.append({"dense": None, "scan": sg,
                               "slots": tuple(slots)})
            pend.clear()

        for lump_buckets, pair_buckets, ptot, dense in fsched:
            if dense is not None:
                flush_plain()
                info = {"buckets": lump_buckets, "dense": dense,
                        "slots": {}, "gslots": {}, "bidx": {}}
                for bi, rm in enumerate(dense["row_maps"]):
                    if rm is None:
                        continue
                    info["slots"][bi] = len(aux_np)
                    aux_np.append(rm)
                for gkey, items in dense["groups"].items():
                    info["gslots"][gkey] = len(aux_np)
                    aux_np.append(_i32(np.array(items)))
                sg = dense.get("sg")
                if sg is not None:
                    info["sg_slots"] = {}
                    for bi, m in sg["maps"].items():
                        info["sg_slots"][bi] = len(aux_np)
                        aux_np.append(m)
                    info["sg_gslots"] = {}
                    for gkey, items in sg["groups"].items():
                        info["sg_gslots"][gkey] = len(aux_np)
                        aux_np.append(_i32(np.array(items)))
                info["out"] = []
                for bi, idxs, bidx in dense.get("out_groups", []):
                    slot = len(aux_np)
                    aux_np.append(bidx)
                    info["out"].append((bi, idxs, slot))
                vs = dense["vec_slices"]
                if len(vs) > self.VEC_SLICE_UNROLL:
                    cidx = np.full(dense["R"], order, dtype=np.int32)
                    for v0, ln, g0 in vs:
                        cidx[g0:g0 + ln] = v0 + np.arange(ln)
                    info["cidx_slot"] = len(aux_np)
                    aux_np.append(cidx)
                levels.append(info)
            else:
                if use_inv and max(lb.cp for lb in lump_buckets) \
                        <= self.SCAN_CP_MAX:
                    # scan folding needs the stored-inverse diag solve
                    # and gather-cheap (short-slice) panel rows
                    pend.append(lump_buckets)
                else:
                    flush_plain()
                    add_plain(lump_buckets)
        flush_plain()

        def xcat_of(info, xs, nrhs, dtype):
            """Concatenate per-bucket solved values (B, cp, nrhs) into
            W-column order (Kp, nrhs); padded columns hold zeros."""
            dense = info["dense"]
            parts = []
            for bi, base in sorted(dense["col_base"].items(),
                                   key=lambda kv: kv[1]):
                x = xs.get(bi)
                lb = info["buckets"][bi]
                if x is None:
                    parts.append(jnp.zeros((len(lb.off) * lb.cp, nrhs),
                                           dtype))
                else:
                    parts.append(x.reshape(-1, nrhs))
            return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

        def dense_below_fwd_w(vv, info, xs, belows, aux):
            """W-mode forward below update: vv[rows] -= W @ xcat."""
            dense = info["dense"]
            nrhs = vv.shape[1]
            Wm = self._build_w(vv.dtype, dense, info["buckets"], belows,
                               aux, slots=info["slots"])
            acc = jnp.einsum("rk,kn->rn", Wm,
                             xcat_of(info, xs, nrhs, vv.dtype),
                             preferred_element_type=vv.dtype)
            if "cidx_slot" in info:
                vv = vv.at[aux[info["cidx_slot"]]].add(
                    -acc, indices_are_sorted=False, unique_indices=True)
            else:
                for v0, ln, g0 in dense["vec_slices"]:
                    vv = vv.at[v0:v0 + ln].add(-acc[g0:g0 + ln])
            return vv

        def dense_dx_w(vv, info, belows, aux):
            """W-mode transpose corrections: dx = W^T acc, split back to
            per-bucket (B, cp, nrhs)."""
            dense = info["dense"]
            R = dense["R"]
            nrhs = vv.shape[1]
            if "cidx_slot" in info:
                acc = vv[aux[info["cidx_slot"]]]
            else:
                acc = jnp.zeros((R, nrhs), vv.dtype)
                for v0, ln, g0 in dense["vec_slices"]:
                    acc = acc.at[g0:g0 + ln].set(vv[v0:v0 + ln])
            Wm = self._build_w(vv.dtype, dense, info["buckets"], belows,
                               aux, slots=info["slots"])
            dxcat = jnp.einsum("rk,rn->kn", Wm, acc,
                               preferred_element_type=vv.dtype)
            dxs = {}
            for bi, base in dense["col_base"].items():
                lb = info["buckets"][bi]
                piece = dxcat[base:base + len(lb.off) * lb.cp]
                dxs[bi] = piece.reshape(len(lb.off), lb.cp, nrhs)
            return dxs

        def _sg_pad(sgp, bi, arrs, sc, S):
            """Pad chunk operands to the sg pad_b member count (sentinel
            span rows contribute nothing)."""
            padB = sgp["pad_b"][bi]
            if padB > arrs[0].shape[0]:
                pn = padB - arrs[0].shape[0]
                arrs = [jnp.concatenate(
                    [a, jnp.zeros((pn,) + a.shape[1:], a.dtype)])
                    for a in arrs]
                sc = jnp.concatenate(
                    [sc, jnp.full((pn, sc.shape[1]), S, jnp.int32)])
            return arrs, sc

        def fwd_sg_bucket(acc, info, bi, x0, below0, aux):
            """Span-granular forward below update of ONE bucket into the
            compact accumulator: per chunk, per-origin products place by
            SPAN (the solve analog of _accum_sg_bucket; oh volume / s3^2
            vs row form). Per-bucket so only one bucket's below panels
            are live at a time (BAL-scale levels exceed HBM otherwise)."""
            dense = info["dense"]
            sgp = dense["sg"]
            s3, S = sgp["s3"], sgp["S"]
            nrhs = acc.shape[1]
            for (bj, nb, ssub), islot in info["sg_gslots"].items():
                if bj != bi:
                    continue
                sc = aux[info["sg_slots"][bi]]
                ns3p = sc.shape[1]
                (x, below), sc = _sg_pad(
                    sgp, bi, [x0, below0], sc, S)
                b0lo = aux[islot]
                # 2-D scan operands: see _accum_sg_bucket
                cpx, nrx = x.shape[1], x.shape[2]
                rpb, cpb = below.shape[1], below.shape[2]
                x2 = x.reshape(x.shape[0], cpx * nrx)
                bl2 = below.reshape(below.shape[0], rpb * cpb)

                def step(acc, b0lo, x2=x2, bl2=bl2, sc=sc, nb=nb,
                         ssub=ssub, ns3p=ns3p, cpx=cpx, nrx=nrx,
                         rpb=rpb, cpb=cpb):
                    b0, slo = b0lo[0], b0lo[1]
                    xc = jax.lax.dynamic_slice_in_dim(
                        x2, b0, nb).reshape(nb, cpx, nrx)
                    bl = jax.lax.dynamic_slice_in_dim(
                        bl2, b0, nb).reshape(nb, rpb, cpb)
                    scc = jax.lax.dynamic_slice_in_dim(sc, b0, nb)
                    t = jnp.einsum("brc,bcn->brn", bl, xc,
                                   preferred_element_type=x.dtype)
                    rp3 = ns3p * s3
                    if rp3 > t.shape[1]:
                        t = jnp.concatenate(
                            [t, jnp.zeros((nb, rp3 - t.shape[1], nrhs),
                                          t.dtype)], axis=1)
                    t4 = t.reshape(nb, ns3p, s3, nrhs)
                    ids = slo + jax.lax.broadcasted_iota(
                        jnp.int32, (1, 1, ssub), 2)
                    oh = (scc[:, :, None] == ids).astype(t.dtype)
                    contrib = jnp.einsum(
                        "bns,bnim->sim", oh, t4,
                        preferred_element_type=t.dtype
                    ).reshape(ssub * s3, nrhs)
                    lo = slo * s3
                    z = jnp.zeros((), lo.dtype)
                    cur = jax.lax.dynamic_slice(
                        acc, (lo, z), (ssub * s3, nrhs))
                    return jax.lax.dynamic_update_slice(
                        acc, cur + contrib, (lo, z)), None

                acc, _ = jax.lax.scan(step, acc, b0lo)
            return acc

        def dx_sg_bucket(acc, info, bi, below0, aux):
            """Span-granular transpose corrections of ONE bucket
            (dx_oh_bucket analog)."""
            dense = info["dense"]
            sgp = dense["sg"]
            s3, S = sgp["s3"], sgp["S"]
            nrhs = acc.shape[1]
            cp = info["buckets"][bi].cp
            dx0 = None  # 2-D (padB, cp*nrhs) carry: see _accum_sg_bucket
            for (bj, nb, ssub), islot in info["sg_gslots"].items():
                if bj != bi:
                    continue
                sc = aux[info["sg_slots"][bi]]
                ns3p = sc.shape[1]
                rp = below0.shape[1]
                (below,), sc = _sg_pad(sgp, bi, [below0], sc, S)
                padB = below.shape[0]
                b0lo = aux[islot]
                rpb, cpb = below.shape[1], below.shape[2]
                bl2 = below.reshape(padB, rpb * cpb)
                if dx0 is None:
                    dx0 = jnp.zeros((padB, cp * nrhs), acc.dtype)
                elif dx0.shape[0] < padB:
                    dx0 = jnp.concatenate(
                        [dx0, jnp.zeros((padB - dx0.shape[0], cp * nrhs),
                                        acc.dtype)])

                def step(dx, b0lo, bl2=bl2, sc=sc, nb=nb,
                         ssub=ssub, ns3p=ns3p, rp=rp, rpb=rpb, cpb=cpb):
                    b0, slo = b0lo[0], b0lo[1]
                    bl = jax.lax.dynamic_slice_in_dim(
                        bl2, b0, nb).reshape(nb, rpb, cpb)
                    scc = jax.lax.dynamic_slice_in_dim(sc, b0, nb)
                    ids = slo + jax.lax.broadcasted_iota(
                        jnp.int32, (1, 1, ssub), 2)
                    oh = (scc[:, :, None] == ids).astype(acc.dtype)
                    lo = slo * s3
                    av = jax.lax.dynamic_slice(
                        acc, (lo, jnp.zeros((), lo.dtype)),
                        (ssub * s3, nrhs)).reshape(ssub, s3, nrhs)
                    t4 = jnp.einsum("bns,sim->bnim", oh, av,
                                    preferred_element_type=acc.dtype)
                    t = t4.reshape(nb, ns3p * s3, nrhs)[:, :rp]
                    delta = jnp.einsum("brc,brn->bcn", bl, t,
                                       preferred_element_type=acc.dtype)
                    return jax.lax.dynamic_update_slice_in_dim(
                        dx, delta.reshape(nb, -1), b0, axis=0), None

                dx0, _ = jax.lax.scan(step, dx0, b0lo)
            if dx0 is not None:
                dx0 = dx0.reshape(dx0.shape[0], cp, nrhs)
            return dx0

        def fwd_oh_bucket(acc, info, bi, x0, below0, aux):
            """One bucket's oh-mode forward below update into the compact
            accumulator."""
            dense = info["dense"]
            R = dense["R"]
            nrhs = acc.shape[1]
            for (bj, nb, subp), items_slot in info["gslots"].items():
                if bj != bi:
                    continue
                x, below = x0, below0
                rows_c = aux[info["slots"][bi]]
                padB = dense["pad_b"][bi]
                if padB > x.shape[0]:
                    pn = padB - x.shape[0]
                    x = jnp.concatenate(
                        [x, jnp.zeros((pn,) + x.shape[1:], x.dtype)])
                    below = jnp.concatenate(
                        [below, jnp.zeros((pn,) + below.shape[1:],
                                          below.dtype)])
                    rows_c = jnp.concatenate(
                        [rows_c, jnp.full((pn, rows_c.shape[1]), R,
                                          jnp.int32)])
                b0lo = aux[items_slot]
                # 2-D scan operands: see _accum_sg_bucket
                cpx, nrx = x.shape[1], x.shape[2]
                rpb, cpb = below.shape[1], below.shape[2]
                x2 = x.reshape(x.shape[0], cpx * nrx)
                bl2 = below.reshape(below.shape[0], rpb * cpb)

                def step(acc, b0lo, x2=x2, bl2=bl2, rows_c=rows_c,
                         nb=nb, subp=subp, cpx=cpx, nrx=nrx,
                         rpb=rpb, cpb=cpb):
                    b0, lo = b0lo[0], b0lo[1]
                    xc = jax.lax.dynamic_slice_in_dim(
                        x2, b0, nb).reshape(nb, cpx, nrx)
                    bl = jax.lax.dynamic_slice_in_dim(
                        bl2, b0, nb).reshape(nb, rpb, cpb)
                    rc = jax.lax.dynamic_slice_in_dim(rows_c, b0, nb)
                    t = jnp.einsum("brc,bcn->brn", bl, xc,
                                   preferred_element_type=x.dtype)
                    ids = lo + jax.lax.broadcasted_iota(
                        jnp.int32, (1, 1, subp), 2)
                    oh = (rc[:, :, None] == ids).astype(x.dtype)
                    contrib = jnp.einsum("brs,brn->sn", oh, t,
                                         preferred_element_type=x.dtype)
                    z = jnp.zeros((), lo.dtype)
                    cur = jax.lax.dynamic_slice(acc, (lo, z), (subp, nrhs))
                    return jax.lax.dynamic_update_slice(
                        acc, cur + contrib, (lo, z)), None

                acc, _ = jax.lax.scan(step, acc, b0lo)
            return acc

        def dx_oh_bucket(acc, info, bi, below0, aux):
            """One bucket's oh-mode transpose corrections
            dx = below^T acc_rows."""
            dense = info["dense"]
            R = dense["R"]
            nrhs = acc.shape[1]
            cp = info["buckets"][bi].cp
            dx0 = None  # 2-D (padB, cp*nrhs) carry: see _accum_sg_bucket
            for (bj, nb, subp), items_slot in info["gslots"].items():
                if bj != bi:
                    continue
                below = below0
                rows_c = aux[info["slots"][bi]]
                padB = dense["pad_b"][bi]
                if padB > below.shape[0]:
                    pn = padB - below.shape[0]
                    below = jnp.concatenate(
                        [below, jnp.zeros((pn,) + below.shape[1:],
                                          below.dtype)])
                    rows_c = jnp.concatenate(
                        [rows_c, jnp.full((pn, rows_c.shape[1]), R,
                                          jnp.int32)])
                b0lo = aux[items_slot]
                rpb, cpb = below.shape[1], below.shape[2]
                bl2 = below.reshape(below.shape[0], rpb * cpb)
                if dx0 is None:
                    dx0 = jnp.zeros((padB, cp * nrhs), acc.dtype)
                elif dx0.shape[0] < padB:
                    dx0 = jnp.concatenate(
                        [dx0, jnp.zeros((padB - dx0.shape[0], cp * nrhs),
                                        acc.dtype)])

                def step(dx, b0lo, bl2=bl2, rows_c=rows_c,
                         nb=nb, subp=subp, rpb=rpb, cpb=cpb):
                    b0, lo = b0lo[0], b0lo[1]
                    bl = jax.lax.dynamic_slice_in_dim(
                        bl2, b0, nb).reshape(nb, rpb, cpb)
                    rc = jax.lax.dynamic_slice_in_dim(rows_c, b0, nb)
                    ids = lo + jax.lax.broadcasted_iota(
                        jnp.int32, (1, 1, subp), 2)
                    oh = (rc[:, :, None] == ids).astype(acc.dtype)
                    av = jax.lax.dynamic_slice(
                        acc, (lo, jnp.zeros((), lo.dtype)), (subp, nrhs))
                    t = jnp.einsum("brs,sn->brn", oh, av,
                                   preferred_element_type=acc.dtype)
                    delta = jnp.einsum("brc,brn->bcn", bl, t,
                                       preferred_element_type=acc.dtype)
                    return jax.lax.dynamic_update_slice_in_dim(
                        dx, delta.reshape(nb, -1), b0, axis=0), None

                dx0, _ = jax.lax.scan(step, dx0, b0lo)
            if dx0 is not None:
                dx0 = dx0.reshape(dx0.shape[0], cp, nrhs)
            return dx0

        def acc_of_vv(vv, info, aux):
            """Read the level's compact accumulator rows from vv."""
            dense = info["dense"]
            if "cidx_slot" in info:
                return vv[aux[info["cidx_slot"]]]
            acc = jnp.zeros((dense["R"], vv.shape[1]), vv.dtype)
            for v0, ln, g0 in dense["vec_slices"]:
                acc = acc.at[g0:g0 + ln].set(vv[v0:v0 + ln])
            return acc

        def apply_acc(vv, info, acc, aux):
            """Subtract the accumulated below update into vv."""
            dense = info["dense"]
            if "cidx_slot" in info:
                return vv.at[aux[info["cidx_slot"]]].add(
                    -acc, indices_are_sorted=False, unique_indices=True)
            for v0, ln, g0 in dense["vec_slices"]:
                vv = vv.at[v0:v0 + ln].add(-acc[g0:g0 + ln])
            return vv

        def solve(data, v, aux):
            nrhs = v.shape[1]
            ext = jnp.concatenate([data, jnp.zeros(margin, data.dtype)])
            vv = jnp.concatenate([v, jnp.zeros((1, nrhs), v.dtype)])
            def run_scan(vv, info, transpose):
                sg = info["scan"]
                s0, s1, s2, s3 = info["slots"]
                inp = (aux[s0], aux[s1], aux[s2], aux[s3])

                def step(vvc, i, cpm=sg["cpm"], rpm=sg["rpm"]):
                    return self._scan_solve_step(
                        ext, vvc, i, cpm, rpm, order, transpose), None

                vv, _ = jax.lax.scan(step, vv, inp, reverse=transpose)
                return vv

            def out_map_of(info):
                m: Dict[int, list] = {}
                for bi, idxs, slot in info["out"]:
                    m.setdefault(bi, []).append((idxs, slot))
                return m

            # forward (L) pass
            for info in levels:
                if info.get("scan") is not None:
                    vv = run_scan(vv, info, False)
                elif info["dense"] is not None:
                    if info["dense"].get("mode") == "w":
                        # w mode is size-capped (W_MAX_ELEMS): the
                        # whole-level W build is safe to materialize
                        xs, belows = {}, {}
                        for bi, sb in enumerate(info["buckets"]):
                            vv, x, below = self._diag_solve(
                                ext, vv, sb, order, False, ret_xb=True,
                                use_inv=use_inv)
                            if below is not None:
                                xs[bi], belows[bi] = x, below
                        if xs:
                            vv = dense_below_fwd_w(vv, info, xs, belows,
                                                   aux)
                        for bi, idxs, slot in info["out"]:
                            ji = jnp.asarray(idxs)
                            y = jnp.einsum(
                                "brk,bkn->brn", belows[bi][ji],
                                xs[bi][ji],
                                preferred_element_type=vv.dtype)
                            vv = vv.at[aux[slot]].add(-y)
                    else:
                        # sg/oh: fold each bucket's below update into the
                        # compact accumulator as soon as it is solved, so
                        # one bucket's panels are live at a time (BAL-
                        # scale levels exceed HBM otherwise)
                        sgp = info["dense"].get("sg")
                        out_m = out_map_of(info)
                        acc = jnp.zeros((info["dense"]["R"], nrhs),
                                        vv.dtype)
                        any_below = False
                        for bi, sb in enumerate(info["buckets"]):
                            vv, x, below = self._diag_solve(
                                ext, vv, sb, order, False, ret_xb=True,
                                use_inv=use_inv)
                            if below is None:
                                continue
                            any_below = True
                            if sgp is not None:
                                acc = fwd_sg_bucket(acc, info, bi, x,
                                                    below, aux)
                            else:
                                acc = fwd_oh_bucket(acc, info, bi, x,
                                                    below, aux)
                            for idxs, slot in out_m.get(bi, ()):
                                ji = jnp.asarray(idxs)
                                y = jnp.einsum(
                                    "brk,bkn->brn", below[ji], x[ji],
                                    preferred_element_type=vv.dtype)
                                vv = vv.at[aux[slot]].add(-y)
                        if any_below:
                            vv = apply_acc(vv, info, acc, aux)
                else:
                    for i, sb in enumerate(info["buckets"]):
                        bidx = aux[info["bidx"][i]] \
                            if i in info["bidx"] else None
                        vv = self._diag_solve(ext, vv, sb, order, False,
                                              bidx, use_inv=use_inv)
            # backward (Lt) pass
            for info in reversed(levels):
                if info.get("scan") is not None:
                    vv = run_scan(vv, info, True)
                elif info["dense"] is not None:
                    if info["dense"].get("mode") == "w":
                        belows = {}
                        for bi, sb in enumerate(info["buckets"]):
                            if sb.rp > 0:
                                panels = self._read_panels(ext, sb)
                                belows[bi] = panels[:, sb.cp:]
                        dxs = dense_dx_w(vv, info, belows, aux) \
                            if belows else {}
                        for bi, idxs, slot in info["out"]:
                            ji = jnp.asarray(idxs)
                            tmp = vv[aux[slot]]
                            delta = jnp.einsum(
                                "brk,brn->bkn", belows[bi][ji], tmp,
                                preferred_element_type=vv.dtype)
                            dx0 = dxs.get(bi)
                            if dx0 is None:
                                sbx = info["buckets"][bi]
                                dx0 = jnp.zeros(
                                    (len(sbx.off), sbx.cp, vv.shape[1]),
                                    vv.dtype)
                            dxs[bi] = dx0.at[ji].add(delta)
                        for bi, sb in enumerate(info["buckets"]):
                            dx = dxs.get(bi)
                            if dx is not None:
                                dx = dx[:len(sb.off)]
                            vv = self._diag_solve(ext, vv, sb, order,
                                                  True, dx=dx,
                                                  use_inv=use_inv)
                    else:
                        # sg/oh: per-bucket panels read + dx + diag solve
                        # (acc read once BEFORE any of this level's diag
                        # solves — they only touch this level's rows,
                        # disjoint from the accumulator's below rows)
                        sgp = info["dense"].get("sg")
                        out_m = out_map_of(info)
                        acc = acc_of_vv(vv, info, aux)
                        for bi, sb in enumerate(info["buckets"]):
                            dx, below = None, None
                            if sb.rp > 0:
                                panels = self._read_panels(ext, sb)
                                below = panels[:, sb.cp:]
                                dx = (dx_sg_bucket if sgp is not None
                                      else dx_oh_bucket)(
                                    acc, info, bi, below, aux)
                            for idxs, slot in out_m.get(bi, ()):
                                ji = jnp.asarray(idxs)
                                tmp = vv[aux[slot]]
                                delta = jnp.einsum(
                                    "brk,brn->bkn", below[ji], tmp,
                                    preferred_element_type=vv.dtype)
                                if dx is None:
                                    dx = jnp.zeros(
                                        (len(sb.off), sb.cp, nrhs),
                                        vv.dtype)
                                dx = dx.at[ji].add(delta)
                            if dx is not None:
                                dx = dx[:len(sb.off)]
                            vv = self._diag_solve(ext, vv, sb, order,
                                                  True, dx=dx,
                                                  use_inv=use_inv)
                else:
                    for i, sb in enumerate(info["buckets"]):
                        bidx = aux[info["bidx"][i]] \
                            if i in info["bidx"] else None
                        vv = self._diag_solve(ext, vv, sb, order, True,
                                              bidx, use_inv=use_inv)
            return vv[:order]

        return solve, aux_np

    def make_solve_sharded(self, start_lump: int, end_lump: int,
                           axis_name: str, n_shards: int):
        """Solve to run INSIDE shard_map over a 1-D mesh axis: replicated
        (data, v) in, replicated solution out. Each level's bucket panels
        split across the axis; every shard accumulates its panels' RHS
        updates into a delta vector and ONE psum per level combines them
        (deltas of a level touch disjoint RHS rows across lumps, except
        the shared sacrificial sentinel row). Buckets too small to split
        run replicated with their delta scaled by 1/N. Completes the
        model-parallel story next to factor_sharded — no reference analog
        (the reference is single-node). Requires factor data with
        embedded inverses (factor / factor_sharded output)."""
        sched = self._solve_schedule(start_lump, end_lump)
        sk = self.plan.skel
        order = sk.order
        dsize = int(sk.data_size)
        aux_np = []
        margin = 2
        levels = []
        for buckets in sched:
            binfos = []
            for lb in buckets:
                B = len(lb.off)
                rp, cp = lb.rp, lb.cp
                h = rp + cp
                if B >= n_shards * self.SHARD_MIN_B:
                    Bs = -(-B // n_shards)
                    Pn = n_shards * Bs
                    offp = np.full(Pn, dsize, np.int32)
                    offp[:B] = lb.off
                    colsp = np.zeros(Pn, np.int32)
                    colsp[:B] = lb.cols
                    voffp = np.full(Pn, order, np.int32)
                    voffp[:B] = lb.vec_off
                    slot = len(aux_np)
                    aux_np += [offp, colsp, voffp]
                    bslot = None
                    if rp > 0:
                        bxp = np.full((Pn, rp), order, np.int32)
                        bxp[:B] = lb.below_idx
                        bslot = len(aux_np)
                        aux_np.append(bxp)
                    margin = max(margin, h * cp)
                    binfos.append(("shard", lb, Bs, slot, bslot))
                else:
                    bslot = None
                    if rp > 0:
                        bslot = len(aux_np)
                        aux_np.append(lb.below_idx)
                    if not lb.contiguous:
                        margin = max(margin, h * cp)
                    binfos.append(("rep", lb, None, None, bslot))
            levels.append(binfos)

        inv_n = 1.0 / n_shards
        gnums = jax.lax.GatherDimensionNumbers(
            offset_dims=(1,), collapsed_slice_dims=(),
            start_index_map=(0,))

        def bucket_delta(ext, vv, delta, info, aux, idx, transpose):
            kind, lb, Bs, slot, bslot = info
            cp = lb.cp
            if kind == "shard":
                off = jax.lax.dynamic_slice_in_dim(aux[slot], idx * Bs, Bs)
                cols = jax.lax.dynamic_slice_in_dim(aux[slot + 1],
                                                    idx * Bs, Bs)
                voff = jax.lax.dynamic_slice_in_dim(aux[slot + 2],
                                                    idx * Bs, Bs)
                bx = None
                if bslot is not None:
                    bx = jax.lax.dynamic_slice_in_dim(aux[bslot],
                                                      idx * Bs, Bs, axis=0)
                h = cp + lb.rp
                flat = jax.lax.gather(ext, off[:, None], gnums,
                                      slice_sizes=(h * cp,))
                panels = flat.reshape(Bs, h, cp)
                scale = None
            else:
                panels = self._read_panels(ext, lb)
                cols = jnp.asarray(lb.cols)
                voff = jnp.asarray(lb.vec_off)
                bx = aux[bslot] if bslot is not None else None
                scale = inv_n
            P = panels[:, :cp]
            below = panels[:, cp:] if lb.rp > 0 else None
            xr = jax.lax.broadcasted_iota(jnp.int32, (1, cp), 1)
            xidx = jnp.where(xr < cols[:, None], voff[:, None] + xr, order)
            x0 = vv[xidx]
            x = x0
            if transpose and below is not None and bx is not None:
                x = x - jnp.einsum("brk,brn->bkn", below, vv[bx],
                                   preferred_element_type=vv.dtype)
            x = self._tri_stored(P, cols, x, transpose)
            dx = x - x0
            dy = None
            if not transpose and below is not None and bx is not None:
                dy = -jnp.einsum("brk,bkn->brn", below, x,
                                 preferred_element_type=vv.dtype)
            if scale is not None:
                dx = scale * dx
                dy = scale * dy if dy is not None else None
            delta = delta.at[xidx].add(dx)
            if dy is not None:
                delta = delta.at[bx].add(dy)
            return delta

        def solve(data, v, aux, _skip_l=False, _skip_lt=False):
            idx = jax.lax.axis_index(axis_name)
            ext = jnp.concatenate([data, jnp.zeros(margin, data.dtype)])
            vv = jnp.concatenate([v, jnp.zeros((1, v.shape[1]), v.dtype)])
            if not _skip_l:
                for binfos in levels:
                    delta = jnp.zeros_like(vv)
                    for info in binfos:
                        delta = bucket_delta(ext, vv, delta, info, aux,
                                             idx, False)
                    vv = vv + jax.lax.psum(delta, axis_name)
            if not _skip_lt:
                for binfos in reversed(levels):
                    delta = jnp.zeros_like(vv)
                    for info in binfos:
                        delta = bucket_delta(ext, vv, delta, info, aux,
                                             idx, True)
                    vv = vv + jax.lax.psum(delta, axis_name)
            return vv[:order]

        return solve, aux_np

    # -- symmetric block mat-vec (fully parallel, no level deps) --------
    def make_add_mv(self, start_lump: int):
        plan = self.plan
        order = plan.skel.order
        buckets = self._bucket_lumps(
            np.arange(start_lump, plan.skel.num_lumps, dtype=np.int64),
            with_below_idx=True)

        aux_np = []
        for sb in buckets:
            if sb.rp > 0:
                sb.aux_slot = len(aux_np)
                aux_np.append(sb.below_idx)

        def add_mv(data, x, out, alpha, aux):
            nrhs = x.shape[1]
            ext = jnp.concatenate([data, jnp.zeros(2, data.dtype)])
            xx = jnp.concatenate([x, jnp.zeros((1, nrhs), x.dtype)])
            oo = jnp.concatenate([out, jnp.zeros((1, nrhs), out.dtype)])
            for sb in buckets:
                cp = sb.cp
                # scheduling fence: ties each bucket's padded panel read
                # to the PREVIOUS bucket's output update, so XLA cannot
                # hoist every bucket's multi-GB read to the program start
                # (ten coexisting reads at BAL scale)
                ext, oo = jax.lax.optimization_barrier((ext, oo))
                panels = self._read_panels(ext, sb)
                diag = panels[:, :cp]
                i_ = jax.lax.broadcasted_iota(jnp.int32, (1, cp, cp), 1)
                j_ = jax.lax.broadcasted_iota(jnp.int32, (1, cp, cp), 2)
                lower = jnp.where(i_ >= j_, diag, 0.0)
                sym = lower + jnp.where(i_ > j_, lower,
                                        0.0).transpose(0, 2, 1)
                cols = jnp.asarray(sb.cols)
                xr = jax.lax.broadcasted_iota(jnp.int32, (1, cp), 1)
                xidx = jnp.where(xr < cols[:, None],
                                 jnp.asarray(sb.vec_off)[:, None] + xr,
                                 order)
                xl = xx[xidx]
                contrib = alpha * jnp.einsum(
                    "bij,bjn->bin", sym, xl,
                    preferred_element_type=xx.dtype)
                if sb.rp > 0:
                    below = panels[:, cp:]
                    bidx = aux[sb.aux_slot]
                    oo = oo.at[bidx].add(alpha * jnp.einsum(
                        "brk,bkn->brn", below, xl,
                        preferred_element_type=xx.dtype))
                    contrib = contrib + alpha * jnp.einsum(
                        "brk,brn->bkn", below, xx[bidx],
                        preferred_element_type=xx.dtype)
                oo = oo.at[xidx].add(contrib)
            return oo[:order]

        return add_mv, aux_np

    def make_pseudo_factor(self, start_span: int, end_span: int):
        # per-span strided panels; cold path (Gauss-Seidel precond setup),
        # reuse the unrolled implementation
        from .ref_backend import UnrolledBackend
        return UnrolledBackend(self.plan).make_pseudo_factor(
            start_span, end_span)
