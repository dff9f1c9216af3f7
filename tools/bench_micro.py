#!/usr/bin/env python
"""Microbenchmarks of the assembly primitives on the ambient device.

Measures, with amortized multi-dispatch timing (one block_until_ready per
window):
  * exact-shape block scatter-add (the _apply_pairs element path) across
    (P, rs, cs) shapes — per-element cost vs block size,
  * masked/padded scatter-add (the catch-all path),
  * full-panel scatter .at[].set of (B, rp, cp) into a compact W matrix,
  * one-hot row-placement GEMM (the dense-update chunk step),
  * plain large syrk (W @ W.T) for the matmul roofline,
  * windowed dynamic-slice read-modify-write under lax.scan.

These calibrate the dense-vs-pairs cost constants in planned_backend
(ROW_NS & co), the dense-vs-pairs decision of each factor level.
"""
import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    log(f"devices: {len(jax.devices())} x {dev.platform} ({dev.device_kind})")
    rng = np.random.RandomState(0)
    N = 20_000_000
    base = jnp.asarray(rng.rand(N).astype(np.float32))

    def timed(fn, *args, min_window=0.25, max_reps=600):
        out = jax.block_until_ready(fn(*args))
        n = 4
        while True:
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn(*args)
            jax.block_until_ready(out)
            tot = time.perf_counter() - t0
            if tot >= min_window or n >= max_reps:
                return tot / n
            n = min(max_reps, max(n * 2,
                                  int(np.ceil(n * min_window / max(tot, 1e-6)))))

    null_t = timed(jax.jit(lambda x: x * 1.000001), jnp.zeros(8, jnp.float32))
    log(f"null dispatch: {null_t*1e6:.1f} us")

    def t_of(fn, *args):
        return max(timed(fn, *args) - null_t, 1e-9)

    # ---- exact block scatter-add --------------------------------------
    log("\n== exact block scatter-add: ext.at[tgt].add(vals) ==")
    for P, rs, cs in [(100000, 3, 3), (30000, 6, 6), (10000, 12, 12),
                      (3000, 24, 24), (1000, 48, 48), (300, 96, 96),
                      (100, 192, 192), (30, 384, 384), (15, 1024, 96),
                      (15, 1024, 1024), (4, 2048, 2048)]:
        elems = P * rs * cs
        if elems > 17_000_000:
            continue
        # targets: random row starts with stride 2048, random col offsets
        trs = rng.randint(0, N - rs * 2048 - cs, P).astype(np.int32)
        srcb = rng.randint(0, N - rs * 2048 - cs, P).astype(np.int32)
        trs_j = jnp.asarray(trs)
        src_j = jnp.asarray(srcb)

        @jax.jit
        def scat(ext, flat, trs_j=trs_j, src_j=src_j, P=P, rs=rs, cs=cs):
            r = jax.lax.broadcasted_iota(jnp.int32, (1, rs, cs), 1)
            c = jax.lax.broadcasted_iota(jnp.int32, (1, rs, cs), 2)
            src = src_j[:, None, None] + r * 2048 + c
            tgt = trs_j[:, None, None] + r * 2048 + c
            return ext.at[tgt].add(-flat[src])

        t = t_of(scat, base, base)
        log(f"P={P:7d} rs={rs:5d} cs={cs:5d} elems={elems:9d}: "
            f"{t*1e6:9.1f} us  {t/elems*1e9:7.3f} ns/el  "
            f"{elems*8/t/1e9:8.1f} GB/s(rw)")

    # ---- masked padded scatter-add ------------------------------------
    log("\n== masked padded scatter-add (catch-all path, ~50% fill) ==")
    for P, rsp, csp in [(10000, 8, 8), (1000, 64, 64), (60, 1024, 1024)]:
        elems = P * rsp * csp
        if elems > 17_000_000:
            P = 17_000_000 // (rsp * csp)
            elems = P * rsp * csp
        trs = rng.randint(0, N - rsp * 2048 - csp, P).astype(np.int32)
        srcb = rng.randint(0, N - rsp * 2048 - csp, P).astype(np.int32)
        rs_a = rng.randint(max(1, rsp // 2), rsp + 1, P).astype(np.int32)
        cs_a = rng.randint(max(1, csp // 2), csp + 1, P).astype(np.int32)
        args = tuple(jnp.asarray(x) for x in (trs, srcb, rs_a, cs_a))

        @jax.jit
        def scat_m(ext, flat, trs_j=args[0], src_j=args[1], rs_j=args[2],
                   cs_j=args[3], rsp=rsp, csp=csp):
            r = jax.lax.broadcasted_iota(jnp.int32, (1, rsp, csp), 1)
            c = jax.lax.broadcasted_iota(jnp.int32, (1, rsp, csp), 2)
            src = src_j[:, None, None] + r * 2048 + c
            tgt = trs_j[:, None, None] + r * 2048 + c
            vals = flat[jnp.clip(src, 0, flat.shape[0] - 1)]
            mask = (r < rs_j[:, None, None]) & (c < cs_j[:, None, None])
            trash = ext.shape[0] - 2
            return ext.at[jnp.where(mask, tgt, trash)].add(-vals)

        t = t_of(scat_m, base, base)
        log(f"P={P:7d} rsp={rsp:4d} csp={csp:5d} elems={elems:9d}: "
            f"{t*1e6:9.1f} us  {t/elems*1e9:7.3f} ns/el")

    # ---- panel scatter into W (dense W build alternative) -------------
    log("\n== panel scatter .at[idx].set: (B, rp, cp) -> W (R x K) ==")
    for B, rp, cp, R in [(28, 2048, 128, 2790), (512, 128, 8, 4096),
                         (16, 2048, 128, 16384)]:
        K = B * cp
        x = jnp.asarray(rng.rand(B, rp, cp).astype(np.float32))
        # random strictly-increasing row maps per member
        rc = np.sort(rng.randint(0, R, (B, rp)).astype(np.int32), axis=1)

        @jax.jit
        def wbuild(x, rc_j=jnp.asarray(rc), B=B, rp=rp, cp=cp, R=R, K=K):
            W = jnp.zeros((R + 1) * K, x.dtype)
            colb = jnp.arange(B, dtype=jnp.int32)[:, None, None] * cp
            ci = jax.lax.broadcasted_iota(jnp.int32, (1, 1, cp), 2)
            idx = rc_j[:, :, None] * K + colb + ci
            return W.at[idx].set(x)

        elems = B * rp * cp
        t = t_of(wbuild, x)
        log(f"B={B:4d} rp={rp:5d} cp={cp:4d} R={R:6d}: {t*1e6:9.1f} us  "
            f"{t/elems*1e9:7.3f} ns/el")

    # ---- one-hot placement GEMM (chunk step) --------------------------
    log("\n== one-hot row placement y = OH^T x ==")
    for nb, rp, subp, cp in [(16, 2048, 2048, 128), (16, 2048, 512, 128),
                             (64, 128, 512, 8), (256, 128, 2048, 8)]:
        x = jnp.asarray(rng.rand(nb, rp, cp).astype(np.float32))
        rc = jnp.asarray(rng.randint(0, subp, (nb, rp)).astype(np.int32))

        @jax.jit
        def oh_place(x, rc=rc, subp=subp):
            ids = jax.lax.broadcasted_iota(jnp.int32, (1, 1, subp), 2)
            oh = (rc[:, :, None] == ids).astype(x.dtype)
            return jnp.einsum("bir,bic->brc", oh, x,
                              preferred_element_type=x.dtype)

        t = t_of(oh_place, x)
        flops = 2 * nb * rp * subp * cp
        oh_el = nb * rp * subp
        log(f"nb={nb:4d} rp={rp:5d} subp={subp:5d} cp={cp:4d}: "
            f"{t*1e6:9.1f} us  {flops/t/1e12:6.2f} Tflop/s  "
            f"{t/oh_el*1e9:7.3f} ns/OHel")

    # ---- plain syrk roofline ------------------------------------------
    log("\n== syrk U = W W^T (highest precision) ==")
    with jax.default_matmul_precision("highest"):
        for R, K in [(2790, 2688), (4096, 4096), (8192, 2048)]:
            W = jnp.asarray(rng.rand(R, K).astype(np.float32))

            @jax.jit
            def syrk(W):
                return jnp.einsum("rk,sk->rs", W, W,
                                  preferred_element_type=W.dtype)

            t = t_of(syrk, W)
            flops = 2 * R * R * K
            log(f"R={R:5d} K={K:5d}: {t*1e6:9.1f} us  "
                f"{flops/t/1e12:6.2f} Tflop/s")

    # ---- windowed RMW scan --------------------------------------------
    log("\n== windowed dynamic-slice RMW under lax.scan ==")
    for S, rsp, st in [(500, 64, 128), (100, 512, 512), (30, 1024, 1024)]:
        offs = jnp.asarray(
            rng.randint(0, N - rsp * st, S).astype(np.int32))
        sub = jnp.asarray(rng.rand(rsp, st).astype(np.float32))

        @jax.jit
        def wrmw(ext, offs=offs, sub=sub, rsp=rsp, st=st):
            def step(e, off):
                reg = jax.lax.dynamic_slice_in_dim(
                    e, off, rsp * st).reshape(rsp, st)
                return jax.lax.dynamic_update_slice_in_dim(
                    e, (reg - sub).reshape(-1), off, axis=0), None
            e, _ = jax.lax.scan(step, ext, offs)
            return e

        t = t_of(wrmw, base)
        elems = S * rsp * st
        log(f"S={S:4d} rsp={rsp:5d} st={st:5d}: {t*1e6:9.1f} us  "
            f"{t/S*1e6:7.2f} us/win  {t/elems*1e9:7.3f} ns/el")


if __name__ == "__main__":
    main()
