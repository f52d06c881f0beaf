"""Two-stage verified search: minimizer screen + classic verification.

The minimizer layouts buy their screening speed with a
near-miss per-kmer FPR the reference's semantics cannot absorb
(hashing/scheme.py FPR table: 0.23-0.44 vs classic's 0.018, with an
m-resistant floor).  A VERIFIED index keeps the reference's one FPR
story (``bigsi/bloom/bloomfilter.py:5-13``: h independent rows anywhere
in [0, m)) by storing TWO structures:

* ``rows.bin`` — the canonical CLASSIC matrix, exactly as a
  layout=classic index would persist it (reference semantics, the
  migration/merge/insert surface, and the scoring path all unchanged);
* ``screen.bin`` — a minimizer-layout matrix over the same samples,
  used only to cheaply bound hit counts from above.

Query = screen + verify:

1. SCREEN: the minimizer cols kernel computes per-colour screen counts
   for the whole batch on device.
2. CANDIDATES: colours with ``screen_count >= min_kmers - margin``.
   A Bloom filter has no false negatives, so for every colour
   ``screen_count >= true_count`` and ``classic_count <= true_count +
   classic_FP_count``; a colour passing the classic threshold is
   therefore screened in whenever its classic false-positive count is
   at most ``margin`` (see :func:`screen_margin`).
3. VERIFY: for the candidate colours (typically << N), recompute hit
   counts with CLASSIC semantics — h murmur3 rows from ``rows.bin``
   restricted to the candidate words (native ``and_count_words``) —
   and threshold/report from those.  Result dicts are identical to a
   pure classic index (``bigsi/graph/bigsi.py:211-230`` semantics),
   at screening speed whenever candidates are sparse.

The screen's higher near-miss FPR only inflates the candidate set
(extra verify work), never the results — which also frees the screen
matrix from classic m-sizing (``screen-m`` may be smaller than m).
"""

from __future__ import annotations

import math

import numpy as np

from bigsi_tpu.hashing.scheme import (
    MINIMIZER,
    SLOT_SCHEME_V3,
    default_run_len,
)

# Default screen window: the fastest serving config on the earlier
# accelerator (minimizer/16 w=19 cols; not re-measured on the H100).
# Its 0.44 near-miss FPR is a candidate-inflation cost here, not a
# result-quality cost.
DEFAULT_SCREEN_WINDOW = 19
DEFAULT_SCREEN_TILE_ROWS = 16

# Margin policy: candidates must cover colours whose CLASSIC count
# clears the threshold only with the help of classic false positives.
# Classic per-kmer FPR at reference sizing is ~0.017
# (hashing/scheme.py FPR table); FP counts are ~Binomial(n, p).  The
# default bounds p at MARGIN_FRACTION with an absolute floor — orders
# of magnitude above the expectation + 6 sigma at any query length, so
# a screened-out passing colour needs a ~never event.  ``verify-margin``
# in the config overrides (0 = report only colours whose TRUE k-mer
# content clears the threshold — scientifically cleaner, but not
# reference-identical).
MARGIN_FRACTION = 0.08
MARGIN_FLOOR = 8


def screen_margin(num_kmers: int, config_margin=None) -> int:
    if config_margin is not None:
        return int(config_margin)
    return max(MARGIN_FLOOR, math.ceil(MARGIN_FRACTION * num_kmers))


def screen_params_from_config(config: dict) -> dict | None:
    """Resolve the screen build parameters, or None when not verified.

    Enabled by ``screen: minimizer`` (the only screen layout).  Keys:
    ``screen-m`` (default m), ``screen-tile-rows`` (default 16),
    ``screen-window`` (default 19), ``screen-run-len`` (default w+1).
    """
    screen = config.get("screen")
    if screen is None:
        return None
    if screen is not True and screen != MINIMIZER:
        raise ValueError(
            "config key 'screen' must be 'minimizer', got %r" % (screen,)
        )
    window = config.get("screen-window", DEFAULT_SCREEN_WINDOW)
    return {
        "m": int(config.get("screen-m", config["m"])),
        "tile_rows": int(
            config.get("screen-tile-rows", DEFAULT_SCREEN_TILE_ROWS)
        ),
        "window": int(window),
        "slot_scheme": SLOT_SCHEME_V3,
        "run_len": int(config.get("screen-run-len", default_run_len(window))),
    }


def classic_counts_for_colours(
    words: np.ndarray, row_idx: np.ndarray, colours: np.ndarray
) -> np.ndarray:
    """Verify candidate colours: -> int64 counts aligned with ``colours``.

    ``words``: the classic matrix uint32[m, W] (rows.bin memmap passes
    through un-copied); ``row_idx``: classic hash rows int64[K, h];
    ``colours``: candidate colour ids.  Counts carry full classic
    semantics: colour c's count = |{kmer : all h rows have bit c set}|.
    """
    import os

    colours = np.asarray(colours, dtype=np.int64)
    if colours.size == 0 or row_idx.shape[0] == 0:
        return np.zeros(colours.size, dtype=np.int64)
    word_ids = np.unique(colours >> 5).astype(np.int32)
    per_word = None
    if not os.environ.get("BIGSI_TPU_NO_NATIVE"):
        from bigsi_tpu import native

        per_word = native.and_count_words(words, row_idx, word_ids)
    if per_word is None:
        per_word = _and_count_words_numpy(words, row_idx, word_ids)
    # map colour -> (word position, bit)
    order = np.searchsorted(word_ids, (colours >> 5).astype(np.int32))
    return per_word[order * 32 + (colours & 31)]


def _and_count_words_numpy(words, row_idx, word_ids) -> np.ndarray:
    """Numpy oracle for ``and_count_words`` (parity-tested)."""
    k, h = row_idx.shape
    # ONE fused fancy-index gather of only the candidate words — the
    # two-step words[rows][:, word_ids] form first materializes K*h
    # FULL rows (~86 MB/query from the mmap at reference sizing)
    sub = words[
        row_idx.reshape(-1)[:, None],
        np.asarray(word_ids)[None, :],
    ].reshape(k, h, -1)
    acc = sub[:, 0, :]
    for j in range(1, h):
        acc = acc & sub[:, j, :]
    bits = (acc[:, :, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return bits.sum(axis=0, dtype=np.int64).reshape(-1)


def split_verify_queries(
    words: np.ndarray,
    row_idx_list: list,
    cand_list: list,
    verifier,
) -> list:
    """Overlapped host+device verification (VERDICT r4 next-1).

    The host pass (native, DRAM-MLP bound) and the device pass (gather
    issue-rate bound) use DISJOINT resources, so splitting the live
    queries and running both concurrently beats either alone: the
    device slice is dispatched async (jax arrays are futures), the
    host slice runs meanwhile, then the device result is resolved.
    The split fraction adapts from the measured per-call rates
    (stored on the verifier), so the ratio tracks whatever the
    hardware pair actually delivers.
    """
    import os
    import time

    use_native = not os.environ.get("BIGSI_TPU_NO_NATIVE")
    if verifier is None or not use_native:
        if verifier is not None:
            return verifier.counts(row_idx_list, cand_list)
        return verify_queries(words, row_idx_list, cand_list)
    b = len(cand_list)
    live = [
        i
        for i in range(b)
        if cand_list[i] is not None
        and len(cand_list[i])
        and row_idx_list[i] is not None
        and len(row_idx_list[i])
    ]
    if len(live) < 8:  # dispatch overhead dominates tiny batches
        return verify_queries(words, row_idx_list, cand_list)
    # the fraction may adapt all the way to 0 (host-only) where the
    # per-batch host<->device transfers cost more than the host pass; a
    # periodic re-probe keeps the door open for the device side
    frac = getattr(verifier, "split_fraction", 0.40)
    calls = getattr(verifier, "_split_calls", 0)
    verifier._split_calls = calls + 1
    if frac < 0.05 and calls % 32 != 31:
        return verify_queries(words, row_idx_list, cand_list)
    if frac < 0.05:
        frac = 0.15  # re-probe draw
    nd = int(round(len(live) * frac))
    if nd == 0 or nd == len(live):
        return verify_queries(words, row_idx_list, cand_list)
    dev_set = set(live[:nd])

    def side(keep):
        return (
            [
                row_idx_list[i] if (i in dev_set) == keep else None
                for i in range(b)
            ],
            [
                cand_list[i] if (i in dev_set) == keep else None
                for i in range(b)
            ],
        )

    d_idx, d_cand = side(True)
    h_idx, h_cand = side(False)
    t0 = time.perf_counter()
    resolve = verifier.counts_async(d_idx, d_cand)
    host_out = verify_queries(words, h_idx, h_cand)
    t_host = time.perf_counter() - t0
    dev_out = resolve()
    t_total = time.perf_counter() - t0
    # adapt: when the device straggles past the host window its rate is
    # measurable and the fraction rebalances from the two rates; when
    # it finishes INSIDE the window its true speed is unobservable, so
    # nudge its share up — the fraction climbs until the device becomes
    # marginally co-critical, which is the balanced operating point
    nh = len(live) - nd
    if t_total > t_host * 1.05:
        r_host = nh / max(t_host, 1e-6)
        r_dev = nd / max(t_total, 1e-6)
        blended = 0.5 * frac + 0.5 * (r_dev / max(r_dev + r_host, 1e-6))
    else:
        blended = frac + 0.05
    verifier.split_fraction = 0.0 if blended < 0.08 else min(0.9, blended)
    return [
        dev_out[i] if i in dev_set else host_out[i] for i in range(b)
    ]


def verify_queries(
    words: np.ndarray,
    row_idx_list: list,
    cand_list: list,
    nthreads: int = 0,
) -> list:
    """Batched verification: one threaded native pass over all queries.

    ``row_idx_list``: per-query classic rows int64[K_i, h] (entries may
    be None/empty when the query has no candidates); ``cand_list``:
    per-query candidate colour arrays.  Returns per-query int64 counts
    aligned with each ``cand_list`` entry.
    """
    import os

    b = len(cand_list)
    out = [np.zeros(0, dtype=np.int64)] * b
    live = [
        i
        for i in range(b)
        if cand_list[i] is not None
        and len(cand_list[i])
        and row_idx_list[i] is not None
        and len(row_idx_list[i])
    ]
    if not live:
        return out
    use_native = not os.environ.get("BIGSI_TPU_NO_NATIVE")
    word_lists = []
    orders = []
    for i in live:
        colours = np.asarray(cand_list[i], dtype=np.int64)
        wids = np.unique(colours >> 5).astype(np.int32)
        word_lists.append(wids)
        orders.append(
            np.searchsorted(wids, (colours >> 5).astype(np.int32)) * 32
            + (colours & 31)
        )
    if use_native:
        from bigsi_tpu import native

        qstart = np.zeros(len(live) + 1, dtype=np.int64)
        np.cumsum([row_idx_list[i].shape[0] for i in live], out=qstart[1:])
        idx = np.concatenate([row_idx_list[i] for i in live])
        wstart = np.zeros(len(live) + 1, dtype=np.int64)
        np.cumsum([len(w) for w in word_lists], out=wstart[1:])
        wids_all = np.concatenate(word_lists)
        nw_cap = int(max(len(w) for w in word_lists))
        got = native.and_count_words_batch(
            words, idx, qstart, wids_all, wstart, nw_cap, nthreads
        )
        if got is not None:
            for j, i in enumerate(live):
                out[i] = got[j][orders[j]]
            return out
    for j, i in enumerate(live):
        per_word = _and_count_words_numpy(
            words, row_idx_list[i], word_lists[j]
        )
        out[i] = per_word[orders[j]]
    return out
