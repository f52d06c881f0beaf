#!/usr/bin/env python
"""Headline benchmark: bitslice-row AND+popcount throughput per chip.

Runs the batched inexact-search data plane at BASELINE.json's 1k-sample
config (m=2.5e7 bloom bits, 1024 samples): per k-mer, test its h hash
rows and accumulate per-sample hit counts.

Engine layouts timed (headline = the best, NAMED in the JSON together
with its measured equal-FPR m premium):

* cols16 — the column-major minimizer tile layout (tile_rows=16): each
  sample's tile column is one uint16, so per-kmer presence is ONE
  compare per sample, (col & slot_mask) == slot_mask, replacing the
  masked AND-reduce over bitslice rows AND the csa popcount tree
  (ops/lookup.py:grouped_counts_cols; derived on device from the
  canonical row-major matrix).  Query streams are REAL: sliding-window
  k-mers of random sequences through the fused native prep, so the
  tile-run structure (and the resulting gather count) is the serving
  distribution, not a synthetic best case.
* grouped16 / grouped32 — the row-major grouped (minimizer) path.
* classic — reference-parity layout, fat-row packed.

Methodology: steps are chained INSIDE one compiled program (lax.scan,
each step's indices perturbed by a value derived from the previous
counts so XLA cannot collapse the chain) and the marginal per-step time
is (t_n - t_1) / (n - 1), min over repeats, which leaves the per-call
dispatch cost out.  It refuses to run anywhere but a GPU, and prints the
card's name and power limit first.

Prints ONE JSON line with {"metric", "value", "unit", "vs_baseline"}
(vs_baseline = value / 1e9 rows/s, the BASELINE.md target) plus the
self-describing fields:

* layout / m_premium / near_miss_fpr / precision_1pct — the winning
  config NAMED with its measured FPR and result-quality trade
  (FPR_TRADE below; docs/RESULT_QUALITY.md);
* equal_fpr_hbm_rows_per_s — the headline divided by the measured m
  premium: rows/s at equal background FPR AND equal HBM;
* serving_qps / serving_mode — steady-state queries/s through the
  better of the device-prep (bytes in, ops/prep_jax.py) and host-prep
  serving paths;
* verified_qps — two-stage screen+verify serving (classic result
  dicts) at a pessimistic 8-candidates-per-query verify load, taking
  the better of the host pass and the overlapped host+device split
  (verify_host_ms / verify_split_ms report both);
* spread_ms — per-config min/median/max over EVERY marginal estimate
  of the run (first, and a re-measure with a fresh placement): a
  tight spread marks a stable capture;
* blocked16_rows_per_s — the classic-result-quality middle ground;
* wide_n_{2048,4096}_rows_per_s — sample-width scaling points;
* native_available.
"""

import json
import sys
import time

import numpy as np


# Measured background-FPR m premiums vs classic and near-miss (1-SNP)
# per-kmer FPR at base m — sequence-genome calibration at m=2e6,
# n_kmers=2e5, h=3; schemes v1/v2/v3 measure within noise of each
# other (hashing/scheme.py docstring;
# scripts/fpr_calibration.py).  Near-miss has an m-resistant floor (run
# concentration), so classic near-miss parity is NOT purchasable with m
# — the minimizer layouts are threshold-screening configs by design.
#
# "precision_1pct" is MEASURED end-to-end result quality (not
# extrapolation): worst-case precision of the layout's result dicts vs
# the classic oracle for queries from genomes at 1% divergence over
# t in {0.5, 0.7, 0.9, 1.0} (scripts/result_quality.py full run,
# docs/RESULT_QUALITY.md).  blocked measures classic-grade (1.0);
# raw minimizer layouts are screening configs; "verified" (two-stage
# screen+verify) restores exact classic result dicts at screen speed.
FPR_TRADE = {
    "classic": {
        "m_premium": 1.0, "near_miss_fpr": 0.018, "precision_1pct": 1.0,
    },
    # blocked16 measured 2026-08-20 (--tile-rows 16 --premium): near-miss
    # == background FPR (no run concentration), full classic parity
    # purchasable at 1.75x m — the classic-semantics middle ground.
    "blocked16": {
        "m_premium": 1.75, "near_miss_fpr": 0.0398, "precision_1pct": 1.0,
    },
    "minimizer32": {
        "m_premium": 4.0, "near_miss_fpr": 0.138, "precision_1pct": 0.93,
    },
    "minimizer16": {
        "m_premium": 6.0, "near_miss_fpr": 0.227, "precision_1pct": 0.84,
    },
    "minimizer16-w19": {
        "m_premium": 6.0, "near_miss_fpr": 0.440, "precision_1pct": 0.68,
    },
}


def main():
    import jax
    import jax.numpy as jnp

    from bigsi_tpu.utils.devices import card_info, enable_compile_cache

    enable_compile_cache()

    from bigsi_tpu import native
    from bigsi_tpu.hashing.murmur3 import hash_kmer_matrix
    from bigsi_tpu.hashing.scheme import MINIMIZER_SEED, default_minimizer_s
    from bigsi_tpu.ops.lookup import (
        GROUP_R,
        batched_counts_jnp,
        build_grouped_streams,
        grouped_counts,
        grouped_counts_cols,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(
            "bench.py measures the GPU; JAX found %s devices" % dev.platform
        )
    print("card: %s" % card_info(), file=sys.stderr, flush=True)
    M = 25_000_000  # bloom bits (bitslice rows)
    N = 1024  # samples
    W = N // 32
    B = 256  # queries per batch
    K = 512  # k-mers per query
    H = 3
    KLEN = 31
    CHAIN = 9
    REPEATS = 5
    native_ok = native.available()

    rng = np.random.default_rng(0)

    # per-config spread capture (VERDICT r4 next-8): every marginal
    # estimate observed for a label across the run (first measure,
    # re-measure, idle re-measure, and each repeat within them) — the
    # JSON reports min/median/max so cross-round comparisons see the
    # session variance instead of a single draw
    _SPREAD = {}

    def timed(fn, args):
        out = fn(*args)
        np.asarray(out)[0]  # compile + warm
        ts = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out = fn(*args)
            np.asarray(out)[0]
            ts.append(time.perf_counter() - t0)
        return min(ts), ts

    t_start = time.monotonic()

    def marginal(make, label=""):
        if label:
            print(
                "bench: [%5.0fs] measuring %s"
                % (time.monotonic() - t_start, label),
                file=sys.stderr,
                flush=True,
            )
        f1, a1 = make(1)
        fn, an = make(CHAIN)
        t1, _ = timed(f1, a1)
        tn, tns = timed(fn, an)
        dt = max((tn - t1) / (CHAIN - 1), 1e-9)
        if label:
            base = label.split(" (")[0]  # merge re/idle measures
            _SPREAD.setdefault(base, []).extend(
                max((t - t1) / (CHAIN - 1), 1e-9) for t in tns
            )
            print(
                "bench: %s = %.3f ms/step" % (label, dt * 1e3),
                file=sys.stderr,
                flush=True,
            )
        return dt

    def try_marginal(make, label):
        """A phase that fails (compile error, transient OOM) must not
        zero the whole record — log it and keep measuring."""
        try:
            return marginal(make, label)
        except Exception as e:  # noqa: BLE001 — continue the capture
            print(
                "bench: %s FAILED: %s" % (label, str(e)[:160]),
                file=sys.stderr,
                flush=True,
            )
            return float("inf")

    # ---- real serving streams: sliding-window k-mers of B random
    # sequences through the fused native prep (slot scheme v3) — the
    # honest tile-run distribution for the minimizer paths
    seqs = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=(B, K + KLEN - 1))
    ]
    kmers_flat = np.ascontiguousarray(
        np.concatenate(
            [
                np.lib.stride_tricks.sliding_window_view(q, KLEN)
                for q in seqs
            ]
        )
    )  # [B*K, klen], overlapping rows within each query
    qstart = np.arange(B + 1, dtype=np.int64) * K
    s_mer = default_minimizer_s(KLEN)

    TR16 = 16
    T16 = M // TR16

    def fused_prep(nthreads=0, s=None, r=GROUP_R):
        # slot scheme v3 (the default for new minimizer builds):
        # rolling 2-bit codes + splitmix64, no byte hashing
        return native.prep_minimizer_v3(
            kmers_flat, qstart, s if s is not None else s_mer,
            MINIMIZER_SEED, T16, H, TR16, r, nthreads=nthreads,
        )

    prep16 = fused_prep() if native_ok else None
    if prep16 is None:
        # no native lib: fall back to the (slow) split prep for streams
        from bigsi_tpu.hashing.scheme import minimizer_tiles, slot_hashes_v3

        tile = (
            minimizer_tiles(kmers_flat, T16, s_mer, scheme=3)
            .reshape(B, K)
            .astype(np.int32)
        )
        slots = slot_hashes_v3(kmers_flat, H, TR16).astype(np.uint32)
        smask = np.bitwise_or.reduce(
            np.uint32(1) << slots, axis=1
        ).reshape(B, K)
        ut16, gm16 = build_grouped_streams(tile, smask, r=GROUP_R)
        nv16 = np.full(B, K, dtype=np.int32)
    else:
        ut16, gm16, nv16 = prep16
    U16 = ut16.shape[1]

    # ---- cols16: column-major minimizer tiles, uint16 per sample column
    cols16 = jax.jit(
        lambda k: jax.random.bits(k, (T16, N), jnp.uint16), device=dev
    )(jax.random.PRNGKey(3))
    ut16_d = jax.device_put(ut16, dev)
    gm16_d = jax.device_put(gm16, dev)
    nv16_d = jax.device_put(nv16, dev)

    def make_cols16(nsteps):
        @jax.jit
        def f(cols, utile, gmask, n_valid):
            def body(carry, _):
                u2 = (utile + carry) % T16  # shift tiles, run structure kept
                counts = grouped_counts_cols(cols, u2, gmask, n_valid)
                return (counts[0, 0] & jnp.int32(7)) + 1, ()

            carry, _ = jax.lax.scan(body, jnp.int32(0), None, length=nsteps)
            return carry.reshape(1)

        return f, (cols16, ut16_d, gm16_d, nv16_d)

    # ---- cols16 at minimizer-window 19 ("minimizer-window: 19"
    # config): fewer distinct tiles per query (U 144 -> 64) at a
    # measured near-miss FPR cost (FPR_TRADE) — the headline config.
    # r=20 holds any w=19 run in one entry (runs cap at the window).
    W19, R19 = 19, 20
    if native_ok:
        ut19, gm19, nv19 = native.prep_minimizer_v3(
            kmers_flat, qstart, KLEN - W19 + 1, MINIMIZER_SEED, T16, H,
            TR16, R19,
        )
    else:
        from bigsi_tpu.hashing.scheme import minimizer_tiles, slot_hashes_v3

        tile19 = (
            minimizer_tiles(kmers_flat, T16, KLEN - W19 + 1, scheme=3)
            .reshape(B, K)
            .astype(np.int32)
        )
        sl19 = slot_hashes_v3(kmers_flat, H, TR16).astype(np.uint32)
        sm19 = np.bitwise_or.reduce(
            np.uint32(1) << sl19, axis=1
        ).reshape(B, K)
        ut19, gm19 = build_grouped_streams(tile19, sm19, r=R19)
        nv19 = np.full(B, K, dtype=np.int32)
    ut19_d = jax.device_put(ut19, dev)
    gm19_d = jax.device_put(gm19, dev)
    nv19_d = jax.device_put(nv19, dev)

    def make_cols19(nsteps):
        @jax.jit
        def f(cols, utile, gmask, n_valid):
            def body(carry, _):
                u2 = (utile + carry) % T16
                counts = grouped_counts_cols(cols, u2, gmask, n_valid)
                return (counts[0, 0] & jnp.int32(7)) + 1, ()

            carry, _ = jax.lax.scan(body, jnp.int32(0), None, length=nsteps)
            return carry.reshape(1)

        return f, (cols16, ut19_d, gm19_d, nv19_d)

    dt_cols19 = marginal(make_cols19, 'cols16-w19')  # headline candidate: measured
    # FIRST, on a fresh HBM layout, before other configs allocate

    # ---- ONE-PROGRAM serving step: raw query bytes -> counts, with the
    # whole prep (2-bit packing, splitmix64 minimizers, distinct-kmer
    # dedup, run grouping) ON DEVICE (ops/prep_jax.py).  This is the
    # production serving dispatch (DeviceEngine.counts_batch_seqs): the
    # host's only job is padding bytes, so serving is device-bound.
    from bigsi_tpu.ops.lookup import grouped_counts_cols
    from bigsi_tpu.ops.prep_jax import prep_streams_device

    L = K + KLEN - 1
    LB = ((L + 63) // 64) * 64
    seq_pad = np.full((B, LB), ord("A"), dtype=np.uint8)
    seq_pad[:, :L] = seqs
    lens_b = np.full(B, L, dtype=np.int32)
    seq_d = jax.device_put(seq_pad, dev)
    lens_d = jax.device_put(lens_b, dev)
    S19 = KLEN - W19 + 1
    # the engine's steady-state TIGHT budget (it escalates to the safe
    # _seq_u_cap only on overflow) — measure what serving dispatches
    _nk = LB - KLEN + 1
    _expect = _nk / ((W19 + 1) / 2.0)
    U_CAP = min(_nk, ((int(_expect * 1.15) + 4 + 7) // 8) * 8)

    def make_seqstep(nsteps):
        @jax.jit
        def f(cols, sq, lens):
            def body(carry, _):
                sq2 = jnp.roll(sq, carry, axis=1)  # new bytes per step
                utile, gmask, n_valid, _ok = prep_streams_device(
                    sq2, lens, k=KLEN, s=S19, num_tiles=T16, h=H,
                    tile_rows=TR16, r=R19, u_cap=U_CAP,
                )
                counts = grouped_counts_cols(cols, utile, gmask, n_valid)
                return (counts[0, 0] & jnp.int32(7)) + 1, ()

            carry, _ = jax.lax.scan(body, jnp.int32(0), None, length=nsteps)
            return carry.reshape(1)

        return f, (cols16, seq_d, lens_d)

    dt_seqstep = try_marginal(make_seqstep, 'seq-step (device prep)')

    # ---- blocked16-cols: per-kmer tile fetch (no run grouping) — the
    # classic-RESULT-QUALITY middle ground (docs/RESULT_QUALITY.md:
    # precision 1.0 everywhere, near-miss FPR == background, classic
    # parity at 1.75x m).  Formulated as grouped streams with r=1.
    tiles_pk = rng.integers(0, T16, size=(B, K)).astype(np.int32)
    slots_pk = rng.integers(0, TR16, size=(B, K, H)).astype(np.uint32)
    gm_pk = np.bitwise_or.reduce(np.uint32(1) << slots_pk, axis=2)[
        :, :, None
    ]
    ut_pk_d = jax.device_put(tiles_pk, dev)
    gm_pk_d = jax.device_put(gm_pk, dev)
    nv_pk_d = jax.device_put(np.full(B, K, dtype=np.int32), dev)

    def make_blocked_cols(nsteps):
        @jax.jit
        def f(cols, utile, gmask, n_valid):
            def body(carry, _):
                u2 = (utile + carry) % T16
                counts = grouped_counts_cols(cols, u2, gmask, n_valid)
                return (counts[0, 0] & jnp.int32(7)) + 1, ()

            carry, _ = jax.lax.scan(body, jnp.int32(0), None, length=nsteps)
            return carry.reshape(1)

        return f, (cols16, ut_pk_d, gm_pk_d, nv_pk_d)

    dt_blocked_cols = try_marginal(make_blocked_cols, 'blocked16-cols')

    dt_cols16 = try_marginal(make_cols16, 'cols16-w11')

    # ---- grouped16 (row-major minimizer tiles, same real streams)
    tiles16 = jax.jit(
        lambda key: jax.random.bits(key, (T16, TR16 * W), jnp.uint32),
        device=dev,
    )(jax.random.PRNGKey(2))

    def make_grouped16(nsteps):
        @jax.jit
        def f(tiles, utile, gmask):
            def body(carry, _):
                u2 = (utile + carry) % T16
                counts = grouped_counts(tiles, u2, gmask, TR16)
                return (counts[0, 0] & jnp.int32(7)) + 1, ()

            carry, _ = jax.lax.scan(body, jnp.int32(0), None, length=nsteps)
            return carry.reshape(1)

        return f, (tiles16, ut16_d, gm16_d)

    dt_grouped16 = try_marginal(make_grouped16, 'grouped16')
    del tiles16

    # ---- grouped32 (tile_rows=32, v1-style synthetic streams at the
    # same run structure)
    TR32 = 32
    T32 = M // TR32
    tiles32 = jax.jit(
        lambda k: jax.random.bits(k, (T32, TR32 * W), jnp.uint32), device=dev
    )(jax.random.PRNGKey(0))
    nruns = (K + GROUP_R - 1) // GROUP_R
    run_tiles = rng.integers(0, T32, size=(B, nruns)).astype(np.int32)
    tidx_runs = np.repeat(run_tiles, GROUP_R, axis=1)[:, :K]
    slots32 = rng.integers(0, TR32, size=(B, K, H)).astype(np.uint32)
    sm32 = np.bitwise_or.reduce(np.uint32(1) << slots32, axis=2)
    ut32, gm32 = build_grouped_streams(tidx_runs, sm32)
    ut32_d = jax.device_put(ut32, dev)
    gm32_d = jax.device_put(gm32, dev)

    def make_grouped32(nsteps):
        @jax.jit
        def f(tiles, utile, gmask):
            def body(carry, _):
                u2 = (utile + carry) % T32
                counts = grouped_counts(tiles, u2, gmask, TR32)
                return (counts[0, 0] & jnp.int32(7)) + 1, ()

            carry, _ = jax.lax.scan(body, jnp.int32(0), None, length=nsteps)
            return carry.reshape(1)

        return f, (tiles32, ut32_d, gm32_d)

    dt_grouped32 = try_marginal(make_grouped32, 'grouped32')
    del tiles32

    # ---- classic layout
    words = jax.jit(
        lambda k: jax.random.bits(k, (M, W), jnp.uint32), device=dev
    )(jax.random.PRNGKey(1))
    ridx = jax.device_put(
        rng.integers(0, M, size=(B, K, H)).astype(np.int32), dev
    )
    mask = jax.device_put(np.ones((B, K), dtype=bool), dev)

    def make_classic(nsteps):
        @jax.jit
        def f(words, ridx, mask):
            def body(carry, _):
                i2 = (ridx + carry) % M
                counts = batched_counts_jnp(words, i2, mask)
                return (counts[0, 0] & jnp.int32(7)) + 1, ()

            carry, _ = jax.lax.scan(body, jnp.int32(0), None, length=nsteps)
            return carry.reshape(1)

        return f, (words, ridx, mask)

    dt_classic = try_marginal(make_classic, 'classic')
    del words

    # ---- sample-width scaling: cols19 at N=2048/4096 (equal m),
    # measured LAST so an OOM here cannot poison other configs.
    # rows/s is N-independent by definition; the per-chip SAMPLE
    # throughput is rows/s * N, so flat rows/s across N means linear
    # sample scaling (VERDICT r3 weak-4: unmeasured above N=1024).
    wide_n = {}
    for n_wide in (2048, 4096):
        cols_w = None
        try:
            cols_w = jax.jit(
                lambda key, n=n_wide: jax.random.bits(
                    key, (T16, n), jnp.uint16
                ),
                device=dev,
            )(jax.random.PRNGKey(4))

            def make_wide(nsteps, cols_w=cols_w):
                @jax.jit
                def f(cols, utile, gmask, n_valid):
                    def body(carry, _):
                        u2 = (utile + carry) % T16
                        counts = grouped_counts_cols(
                            cols, u2, gmask, n_valid
                        )
                        return (counts[0, 0] & jnp.int32(7)) + 1, ()

                    carry, _ = jax.lax.scan(
                        body, jnp.int32(0), None, length=nsteps
                    )
                    return carry.reshape(1)

                return f, (cols_w, ut19_d, gm19_d, nv19_d)

            wide_n[n_wide] = marginal(make_wide, 'wide-N %d' % n_wide)
        except Exception as e:  # noqa: BLE001 — OOM at 4096 is data
            wide_n[n_wide] = None
            print("wide-N %d failed: %s" % (n_wide, str(e)[:120]),
                  file=sys.stderr)
        finally:
            # free the HBM NOW — a leaked 12.8 GB buffer (exception
            # tracebacks pin the ref) OOMs every later config
            if cols_w is not None:
                cols_w.delete()

    # Headline + serving re-measure after every other config tears
    # down, on a FRESH allocation of the cols matrix (same bits, new
    # placement); the spread of the two says how stable the number is.
    def remeasure_cols19(label, key):
        fresh = jax.jit(
            lambda k: jax.random.bits(k, (T16, N), jnp.uint16)
        )(jax.random.PRNGKey(key))
        try:
            return try_marginal(
                lambda n: (
                    make_cols19(n)[0],
                    (fresh, ut19_d, gm19_d, nv19_d),
                ),
                label,
            )
        finally:
            fresh.delete()

    dt_cols19 = min(dt_cols19, remeasure_cols19("cols16-w19 (re)", 13))
    dt_seqstep = min(dt_seqstep, try_marginal(make_seqstep, "seq-step (re)"))

    # ---- serving host side (fused native prep; see DeviceEngine.
    # counts_batch_kmers — prep of batch i+1 overlaps device batch i,
    # so the steady-state rate is bounded by max(host, device))
    def time_host(fn, reps=7):
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return min(ts) * 1e3  # steady-state capability (matches the
        # device timings' min-of-repeats; transient contention excluded)

    if native_ok:
        # host-prep fallback path at the headline config (w=19, r=20)
        serve_host_ms = time_host(lambda: fused_prep(s=KLEN - W19 + 1, r=R19))
        serve_host_ms_1t = time_host(
            lambda: fused_prep(nthreads=1, s=KLEN - W19 + 1, r=R19)
        )
    else:
        serve_host_ms = serve_host_ms_1t = float("nan")
    # hash-alone sanity line: murmur3 of B*K canonical-length k-mers mod
    # m — attributes host-path regressions (classic serving prep cost)
    hash_ms = time_host(lambda: hash_kmer_matrix(kmers_flat, H, M), reps=3)

    # device-prep serving: host cost is ONLY padding bytes into [B, LB]
    py_seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, L))
               for _ in range(B)]

    def pad_batch():
        # vectorized: one join + one reshape, and the ACGT gate as 4
        # compares (graph/bigsi.py:_all_acgt)
        from bigsi_tpu.graph.bigsi import BIGSI as _B

        flat = np.frombuffer("".join(py_seqs).encode("ascii"), np.uint8)
        okl = _B._all_acgt(flat)
        out = np.full((B, LB), ord("A"), dtype=np.uint8)
        out[:, :L] = flat.reshape(B, L)
        return out, okl

    pad_ms = time_host(pad_batch)
    serve_dev_qps = (
        B / (dt_seqstep + pad_ms / 1e3) if np.isfinite(dt_seqstep) else 0.0
    )
    serve_host_qps = (
        B / max(serve_host_ms / 1e3, dt_cols19) if native_ok else 0.0
    )
    if serve_dev_qps >= serve_host_qps:
        serve_qps, serve_mode = serve_dev_qps, "device-prep"
    else:
        serve_qps, serve_mode = serve_host_qps, "host-prep"

    # verified serving (screen on device + classic verification of
    # candidate colours on host, pipelined -> bound by the slower side).
    # Candidate budget: 8 colours/query (~0.8% of N — generous vs the
    # measured zero background hit rate, docs/RESULT_QUALITY.md).
    verified_qps = 0.0
    verify_ms = verify_split_ms = float("nan")
    if native_ok:
        from bigsi_tpu import native as _native

        M_V = 2_500_000  # verify matrix scale (host cache-resident;
        # verify cost is row-count-bound, not m-bound)
        words_v = rng.integers(
            0, 1 << 32, size=(M_V, W), dtype=np.uint32
        )
        cand = 8
        idx_v = rng.integers(0, M_V, size=(B * K, H)).astype(np.int64)
        qstart_v = np.arange(B + 1, dtype=np.int64) * K
        wids, wstarts = [], np.zeros(B + 1, dtype=np.int64)
        for i in range(B):
            w_ = np.unique(
                rng.integers(0, W, size=cand).astype(np.int32)
            )
            wids.append(w_)
            wstarts[i + 1] = wstarts[i] + len(w_)
        wids_all = np.concatenate(wids)
        nw_cap = max(len(w_) for w_ in wids)

        def verify_pass():
            return _native.and_count_words_batch(
                words_v, idx_v, qstart_v, wids_all, wstarts, nw_cap, 0
            )

        verify_ms = time_host(verify_pass, reps=3)

        # host+device SPLIT (round 5): the production batch path
        # (graph/bigsi.py:_verified_batch) overlaps a device verify
        # slice with the host pass — disjoint resources, so the
        # combined rate beats either alone (VERDICT r4 next-1).
        verify_split_ms = float("nan")
        try:
            from bigsi_tpu.index.device_engine import DeviceVerifier
            from bigsi_tpu.index.verify import split_verify_queries
            from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix

            verifier = DeviceVerifier(BitSliceMatrix(words_v, N))
            idx_list = [idx_v[i * K : (i + 1) * K] for i in range(B)]
            cand_list = [
                np.unique(rng.integers(0, N, size=cand)).astype(np.int64)
                for _ in range(B)
            ]

            def split_pass():
                return split_verify_queries(
                    words_v, idx_list, cand_list, verifier
                )

            for _ in range(6):  # let the split fraction converge
                split_pass()
            verify_split_ms = time_host(split_pass, reps=3)
        except Exception as e:  # noqa: BLE001 — keep the host number
            print("split verify failed: %s" % str(e)[:120], file=sys.stderr)
        best_verify = min(
            verify_ms,
            verify_split_ms if np.isfinite(verify_split_ms) else verify_ms,
        )
        screen_dt = dt_seqstep if np.isfinite(dt_seqstep) else dt_cols19
        verified_qps = B / max(screen_dt + pad_ms / 1e3, best_verify / 1e3)

    rows = B * K * H
    candidates = {
        "minimizer16-w19": dt_cols19,
        "minimizer16": dt_cols16,
        "minimizer32": dt_grouped32,
        "blocked16": dt_blocked_cols,
        "classic": dt_classic,
    }
    candidates = {
        k2: v for k2, v in candidates.items() if np.isfinite(v)
    } or {"classic": dt_classic}
    best_layout = min(candidates, key=candidates.get)
    best = candidates[best_layout]
    trade = FPR_TRADE[best_layout]
    rows_per_s = rows / best
    # composite: rows/s at equal BACKGROUND FPR and equal HBM — divide
    # by the measured m premium (the index is m_premium x larger per
    # sample, so a chip's HBM holds 1/m_premium as many samples)
    equal_fpr = rows_per_s / trade["m_premium"]
    out = {
        "metric": "bitslice_row_and_popcount_throughput",
        "value": round(rows_per_s, 1),
        "unit": "rows/s/chip",
        "vs_baseline": round(rows_per_s / 1e9, 3),
        "layout": best_layout,
        "m_premium": trade["m_premium"],
        "near_miss_fpr": trade["near_miss_fpr"],
        "precision_1pct": trade["precision_1pct"],
        "equal_fpr_hbm_rows_per_s": round(equal_fpr, 1),
        "native_available": native_ok,
        "serving_qps": round(serve_qps, 1),
        "serving_mode": serve_mode,
        "verified_qps": round(verified_qps, 1),
        "verify_host_ms": round(verify_ms, 2) if verify_ms == verify_ms
        else None,
        "verify_split_ms": round(verify_split_ms, 2)
        if verify_split_ms == verify_split_ms
        else None,
        "blocked16_rows_per_s": round(rows / dt_blocked_cols, 1),
        # per-config session spread (ms/step): all marginal estimates
        # observed across first/re/idle measures — a tight spread means
        # the headline is a stable capture, not a lucky draw
        "spread_ms": {
            lbl: {
                "min": round(min(v) * 1e3, 3),
                "median": round(float(np.median(v)) * 1e3, 3),
                "max": round(max(v) * 1e3, 3),
                "n": len(v),
            }
            for lbl, v in sorted(_SPREAD.items())
        },
    }
    for n_wide, dt in wide_n.items():
        out["wide_n_%d_rows_per_s" % n_wide] = (
            round(rows / dt, 1) if dt else None
        )
    print(json.dumps(out))
    print(
        "detail: %s m=%d N=%d B=%d K=%d h=%d slot-scheme v3, real "
        "sliding-window streams | cols16-w19 %.3f ms/step (%.1f Mrows/s, "
        "U=%d, bg m-premium 6x, near-miss FPR 0.44 - threshold-screening "
        "config; verified mode restores classic results) | "
        "seq-step (DEVICE prep+count, one program) %.3f ms/step | "
        "blocked16-cols %.3f ms/step (%.1f Mrows/s, classic-grade "
        "results, 1.75x m premium) | cols16-w11 %.3f ms/step "
        "(%.1f Mrows/s, U=%d) | grouped16 %.3f ms/step (%.1f Mrows/s) | "
        "grouped32 %.3f ms/step (%.1f Mrows/s) | classic %.3f ms/step "
        "(%.1f Mrows/s) | wide-N %s | serving: device-prep %.0f q/s "
        "(pad %.3f ms + step %.3f ms), host-prep %.0f q/s (fused prep "
        "%.2f ms/batch, 1-thread %.2f) -> %s %.0f q/s | verified "
        "serving %.0f q/s (screen+verify, verify %.2f ms/batch at 8 "
        "cand/query) | hash_kmer_matrix alone %.2f ms/batch | "
        "native_available=%s"
        % (
            dev.platform, M, N, B, K, H,
            dt_cols19 * 1e3, rows / dt_cols19 / 1e6, ut19.shape[1],
            dt_seqstep * 1e3,
            dt_blocked_cols * 1e3, rows / dt_blocked_cols / 1e6,
            dt_cols16 * 1e3, rows / dt_cols16 / 1e6, U16,
            dt_grouped16 * 1e3, rows / dt_grouped16 / 1e6,
            dt_grouped32 * 1e3, rows / dt_grouped32 / 1e6,
            dt_classic * 1e3, rows / dt_classic / 1e6,
            " ".join(
                "N=%d:%s" % (n, "%.1fM" % (rows / dt / 1e6) if dt else "OOM")
                for n, dt in wide_n.items()
            ),
            serve_dev_qps, pad_ms, dt_seqstep * 1e3,
            serve_host_qps, serve_host_ms, serve_host_ms_1t,
            serve_mode, serve_qps,
            verified_qps, verify_ms,
            hash_ms, native_ok,
        ),
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
