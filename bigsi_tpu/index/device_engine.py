"""Device compute engine: device-resident matrix + jitted query programs.

Drop-in replacement for :class:`bigsi_tpu.index.host_engine.HostEngine`
(same method surface, numpy in / numpy out at the boundaries) that keeps
the packed matrix on device and runs gather/AND/count there.  Query
k-mer counts are bucketed to a few static shapes so XLA compiles once
per bucket; padding k-mers are masked out.

Selected via ``config["engine"] = "device"`` or explicitly through
``BIGSI(config, engine_factory=DeviceEngine)``.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu.ops.lookup import (
    TILE_ROWS,
    blocked_presence,
    counts_from_packed,
    exact_and_reduce,
)
from bigsi_tpu.utils.devices import default_device

logger = logging.getLogger(__name__)

_MIN_BUCKET = 64

# long-query guards for the bytes-to-counts path: hard NK ceiling, and
# a B*NK^2 budget matching the round-4 worst case (256 queries x 1024
# kmers) so lifting the length cap never admits MORE quadratic work
SEQ_MAX_NK = 4096
SEQ_QUAD_WORK_BUDGET = 256 * 1024 * 1024


def seq_batch_geometry(seqs, lens, k: int, window: int, db: int = 1):
    """Shared bucketing/guards for every engine's ``counts_batch_seqs``
    (device / mesh / distributed use the SAME rules so tuning changes
    land once): 64-byte length buckets, pow2 batch bucket rounded to a
    multiple of ``db`` (the mesh batch axis), the quadratic-work
    long-query guard, and the grouped-entry budget.  Returns None when
    the batch must take a host path, else (padded uint8[BB, LB],
    lens int32[BB], lb, u_cap)."""
    b, l = seqs.shape
    lb = max(k, ((l + 63) // 64) * 64)
    bb = 8
    while bb < b:
        bb *= 2
    bb = -(-bb // db) * db
    nk = lb - k + 1
    # the device prep's dup + stream-build passes are O(B * NK^2); the
    # chunked formulation (ops/prep_jax.py PREP_CHUNK) bounds their
    # MEMORY, and this bounds their TIME: any batch under ~1 kb queries
    # stays allowed (the round-4 envelope), longer queries up to
    # SEQ_MAX_NK ride the device path when the batch is small enough
    # that the quadratic work stays within that same envelope
    if nk > SEQ_MAX_NK:
        return None
    if nk > 1024 and bb * nk * nk > SEQ_QUAD_WORK_BUDGET:
        return None
    padded = np.full((bb, lb), ord("A"), dtype=np.uint8)
    padded[:b, :l] = seqs
    lens_b = np.zeros(bb, dtype=np.int32)
    lens_b[:b] = lens
    u_cap = DeviceEngine._seq_u_cap(lb - k + 1, window)
    return padded, lens_b, lb, u_cap


def bucket_size(k: int) -> int:
    b = _MIN_BUCKET
    while b < k:
        b *= 2
    return b


@functools.partial(jax.jit, static_argnames=("g", "w"))
def _and_rows_fat(fat, row_idx, g, w):
    k, h = row_idx.shape
    rows = fat_gather(fat, g, w, row_idx.reshape(-1)).reshape(k, h, w)
    out = rows[:, 0, :]
    for j in range(1, h):
        out = out & rows[:, j, :]
    return out


@functools.partial(jax.jit, static_argnames=("g", "w"))
def _counts_batch_fat(fat, row_idx, mask, g, w):
    """Classic layout, batched: row_idx int32[B, K, h], mask bool[B, K]
    -> counts int32[B, w*32].  One fused gather/AND/unpack-sum program."""
    from bigsi_tpu.ops.lookup import csa_counts

    b, k, h = row_idx.shape
    packed = _and_rows_fat.__wrapped__(fat, row_idx.reshape(b * k, h), g, w)
    packed = packed.reshape(b, k, w)
    masked = jnp.where(mask[:, :, None], packed, jnp.uint32(0))
    return csa_counts(masked, axis=1)


@functools.partial(jax.jit, static_argnames=("tile_rows",))
def _counts_batch_blocked(tiles, tile_idx, slot_mask, mask, tile_rows):
    from bigsi_tpu.ops.lookup import blocked_counts

    return blocked_counts(tiles, tile_idx, slot_mask, mask, tile_rows)


@functools.partial(jax.jit, static_argnames=("tile_rows",))
def _counts_batch_grouped(tiles, utile, gmask, tile_rows):
    from bigsi_tpu.ops.lookup import grouped_counts

    return grouped_counts(tiles, utile, gmask, tile_rows)


@jax.jit
def _counts_batch_cols(cols, utile, gmask, n_valid):
    from bigsi_tpu.ops.lookup import grouped_counts_cols

    return grouped_counts_cols(cols, utile, gmask, n_valid)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "s", "num_tiles", "h", "tile_rows", "r", "u_cap", "seed",
    ),
)
def _counts_batch_seqs(
    cols, seqs, lens, *, k, s, num_tiles, h, tile_rows, r, u_cap, seed
):
    """ONE device program: padded query bytes -> per-colour hit counts.

    Fuses the whole serving prep (ops/prep_jax.py: 2-bit packing,
    splitmix64 minimizers, distinct-kmer dedup, run grouping) with the
    cols count kernel, so the host ships only uint8[B, L] bytes.  The
    ``ok`` flag is False when a query exceeds the grouped-entry budget
    (u_cap); the caller falls back to the host-prep path for the batch.
    """
    from bigsi_tpu.ops.lookup import grouped_counts_cols
    from bigsi_tpu.ops.prep_jax import prep_streams_device

    utile, gmask, n_valid, ok = prep_streams_device(
        seqs, lens, k=k, s=s, num_tiles=num_tiles, h=h,
        tile_rows=tile_rows, r=r, u_cap=u_cap, seed=seed,
    )
    counts = grouped_counts_cols(cols, utile, gmask, n_valid)
    return counts, n_valid, ok


@jax.jit
def _cols_and(cols, tile_idx, slot_mask):
    from bigsi_tpu.ops.lookup import cols_presence

    return cols_presence(cols, tile_idx, slot_mask)


@functools.partial(jax.jit, static_argnames=("tile_rows",))
def _blocked_and(tiles, tile_idx, slot_mask, tile_rows):
    return blocked_presence(tiles, tile_idx, slot_mask, tile_rows)


@jax.jit
def _counts(packed, mask):
    return counts_from_packed(packed, mask)


@jax.jit
def _exact(packed, mask):
    return exact_and_reduce(packed, mask)


def fat_pack(words: np.ndarray) -> tuple[np.ndarray, int]:
    """Re-pack narrow rows into 128-word fat rows.

    A layout chosen for a 128-lane vector unit; whether it pays on the
    H100 against a plain ``[m, W]`` gather is not measured (ROADMAP D6).

    [m, W] with W < 128 -> ([ceil(m/G), G*W], G) where G = 128 // W_p
    and W_p is W rounded up to a power of two; bitslice row r lives in
    fat row r // G at word segment r % G.  For W >= 128 (W padded to a
    multiple of 128) this is the identity with G = 1.
    """
    m, w = words.shape
    wp = 8
    while wp < w:
        wp *= 2
    if wp >= 128:
        wp = ((w + 127) // 128) * 128
        g = 1
    else:
        g = 128 // wp
    if wp != w:
        padded = np.zeros((m, wp), dtype=np.uint32)
        padded[:, :w] = words
        words = padded
    if g == 1:
        return np.ascontiguousarray(words), 1
    m_pad = ((m + g - 1) // g) * g
    if m_pad != m:
        grown = np.zeros((m_pad, wp), dtype=np.uint32)
        grown[:m] = words
        words = grown
    return np.ascontiguousarray(words.reshape(m_pad // g, g * wp)), g


def fat_gather(fat: jax.Array, g: int, w: int, row_idx: jax.Array) -> jax.Array:
    """Gather bitslice rows from the fat-packed matrix -> uint32[R, w]."""
    if g == 1:
        return jnp.take(fat, row_idx, axis=0)[:, :w]
    rows = jnp.take(fat, row_idx // g, axis=0)  # [R, g*wp]
    wp = fat.shape[1] // g
    rows = rows.reshape(rows.shape[0], g, wp)
    seg = (row_idx % g)[:, None, None]
    return jnp.take_along_axis(rows, seg, axis=1)[:, 0, :w]


def tile_pack(words: np.ndarray, tile_rows: int = TILE_ROWS) -> np.ndarray:
    """[m, W] -> tile-major uint32[ceil(m/tile_rows), tile_rows*W_pad]
    for the blocked layout: one fat row per tile, lane-aligned (W padded
    to a multiple of 4 so tile_rows*W_pad is a multiple of 128 for
    tile_rows >= 32; smaller tiles still land on word-aligned rows)."""
    m, w = words.shape
    wp = ((w + 3) // 4) * 4
    mp = ((m + tile_rows - 1) // tile_rows) * tile_rows
    if (wp, mp) != (w, m):
        grown = np.zeros((mp, wp), dtype=np.uint32)
        grown[:m, :w] = words
        words = grown
    return np.ascontiguousarray(words.reshape(mp // tile_rows, tile_rows * wp))


class DeviceEngine:
    def __init__(
        self, matrix: BitSliceMatrix, device=None, layout="classic",
        tile_rows: int = TILE_ROWS, minimizer_window: int | None = None,
        slot_scheme: int = 1, run_len: int | None = None,
    ):
        self.matrix = matrix
        self.device = device or default_device()
        logger.info(
            "device engine: %s layout on %s (%s)",
            layout, self.device.platform, self.device.device_kind,
        )
        self.layout = layout
        self.tile_rows = tile_rows
        self.slot_scheme = slot_scheme
        self.minimizer_window = minimizer_window
        # grouped-stream run bucket: persisted per index (ksi:run_len);
        # the tuned default r = w+1 holds any single-occurrence run in
        # one entry (hashing/scheme.py default_run_len)
        if run_len is None and layout == "minimizer":
            from bigsi_tpu.hashing.scheme import default_run_len

            run_len = default_run_len(minimizer_window)
        self.run_len = run_len
        self.w = matrix.num_words
        # per-length-bucket escalation state for counts_batch_seqs:
        # {padded length lb: big-budget batches left before retrying
        # the tight grouped-entry cap}
        self._seq_cap_esc = {}
        self.cols = None
        if layout in ("blocked", "minimizer"):
            self.words = jax.device_put(
                tile_pack(np.asarray(matrix.words), tile_rows), self.device
            )
            self.g = None
            from bigsi_tpu.ops.lookup import cols_dtype, pack_tile_cols

            if layout == "minimizer" and cols_dtype(tile_rows) is not None:
                # column-major derived layout: ONE compare per sample
                # replaces the masked AND-reduce + csa tree (chosen on
                # the earlier accelerator; its H100 speed-up is not
                # measured).  Same bits, so the row-major copy is
                # dropped after packing.  self.words already lives on
                # self.device, so the jit runs there.
                self.cols = jax.jit(
                    pack_tile_cols, static_argnums=1
                )(self.words, tile_rows)
                self.cols.block_until_ready()
                self.words = None
        else:
            fat, self.g = fat_pack(np.asarray(matrix.words))
            self.words = jax.device_put(fat, self.device)

    # `packed` flows through BIGSI opaquely: device arrays stay on
    # device between and_rows and the reductions.

    def and_rows(self, row_idx: np.ndarray):
        k = row_idx.shape[0]
        if k == 0:
            return np.empty((0, self.matrix.num_words), dtype=np.uint32)
        b = bucket_size(k)
        if self.layout in ("blocked", "minimizer"):
            # all h rows of a k-mer share one tile by construction
            tr = self.tile_rows
            tile = np.zeros(b, dtype=np.int32)
            tile[:k] = row_idx[:, 0] // tr
            sm = np.zeros(b, dtype=np.uint32)
            sm[:k] = np.bitwise_or.reduce(
                np.uint32(1) << (row_idx % tr).astype(np.uint32), axis=1
            )
            if self.cols is not None:
                packed = _cols_and(
                    self.cols,
                    jax.device_put(tile, self.device),
                    jax.device_put(sm, self.device),
                )
                return _PackedQuery(packed, k)
            packed = _blocked_and(
                self.words,
                jax.device_put(tile, self.device),
                jax.device_put(sm, self.device),
                tr,
            )
            return _PackedQuery(packed, k)
        idx = np.zeros((b, row_idx.shape[1]), dtype=np.int32)
        idx[:k] = row_idx
        packed = _and_rows_fat(
            self.words, jax.device_put(idx, self.device), self.g, self.w
        )
        return _PackedQuery(packed, k)

    def exact_colours(self, packed) -> np.ndarray:
        if isinstance(packed, np.ndarray):  # empty-query path
            return np.empty(0, dtype=np.int64)
        allk = np.asarray(_exact(packed.rows, packed.mask))
        bits = np.unpackbits(allk.view(np.uint8), bitorder="little")
        return np.flatnonzero(bits).astype(np.int64)

    def counts(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.zeros(num_cols, dtype=np.int64)
        counts = np.asarray(_counts(packed.rows, packed.mask))
        return counts[:num_cols].astype(np.int64)

    def presence_matrix(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty((0, num_cols), dtype=np.uint8)
        host = np.asarray(packed.rows[: packed.k])
        bits = np.unpackbits(host.view(np.uint8), axis=-1, bitorder="little")
        return bits[:, :num_cols]

    def counts_batch(
        self, row_idx: np.ndarray, mask: np.ndarray, num_cols: int
    ) -> np.ndarray:
        """Batched per-query hit counts in ONE device dispatch.

        row_idx int [B, K, h] (padding rows 0), mask bool [B, K] ->
        int64 [B, num_cols].  This is the serving hot path: `bulk_search`
        batches all FASTA records into one program execution instead of
        the reference's one-process-per-chunk Pool (``__main__.py:278``).

        Layout dispatch:
        * minimizer — tile-deduplicated grouped streams, counted on the
          column-major tiles when present (ops/lookup.py:
          grouped_counts_cols), else on the row-major ones;
        * blocked — one tile fetch per k-mer, selection-masked AND
          (ops/lookup.py:blocked_presence);
        * classic — batched fat-row gather + AND over h.
        """
        b, k, h = row_idx.shape
        if b == 0 or k == 0:
            return np.zeros((b, num_cols), dtype=np.int64)
        kb = bucket_size(k)
        # pow2 batch bucket too: serving batches vary per linger window
        # and each distinct (b, k) shape is a fresh XLA compile
        bb = 8
        while bb < b:
            bb *= 2
        orig_b, b = b, bb
        grown = np.zeros((bb, k, h), dtype=row_idx.dtype)
        grown[:orig_b] = row_idx
        row_idx = grown
        mgrown = np.zeros((bb, k), dtype=bool)
        mgrown[:orig_b] = mask
        mask = mgrown
        if self.layout in ("blocked", "minimizer"):
            tr = self.tile_rows
            tile = np.zeros((b, kb), dtype=np.int32)
            tile[:, :k] = row_idx[:, :, 0] // tr
            sm = np.zeros((b, kb), dtype=np.uint32)
            sm[:, :k] = np.where(
                mask,
                np.bitwise_or.reduce(
                    np.uint32(1) << (row_idx % tr).astype(np.uint32), axis=2
                ),
                np.uint32(0),
            )
            if self.layout == "minimizer":
                # consecutive k-mers share tiles: gather each distinct
                # tile once (about 6x fewer fetches at w=11)
                from bigsi_tpu.ops.lookup import GROUP_R, build_grouped_streams

                utile, gmask = build_grouped_streams(
                    tile, sm, r=self.run_len or GROUP_R
                )
                if self.cols is not None:
                    n_valid = mask.sum(axis=1).astype(np.int32)
                    counts = _counts_batch_cols(
                        self.cols,
                        jax.device_put(utile, self.device),
                        jax.device_put(gmask, self.device),
                        jax.device_put(n_valid, self.device),
                    )
                    return np.asarray(counts)[:orig_b, :num_cols].astype(
                        np.int64
                    )
                counts = _counts_batch_grouped(
                    self.words,
                    jax.device_put(utile, self.device),
                    jax.device_put(gmask, self.device),
                    tr,
                )
                return np.asarray(counts)[:orig_b, :num_cols].astype(np.int64)
            mfull = np.zeros((b, kb), dtype=bool)
            mfull[:, :k] = mask
            counts = _counts_batch_blocked(
                self.words,
                jax.device_put(tile, self.device),
                jax.device_put(sm, self.device),
                jax.device_put(mfull, self.device),
                tr,
            )
            return np.asarray(counts)[:orig_b, :num_cols].astype(np.int64)
        idx = np.zeros((b, kb, h), dtype=np.int32)
        idx[:, :k] = row_idx
        mfull = np.zeros((b, kb), dtype=bool)
        mfull[:, :k] = mask
        counts = _counts_batch_fat(
            self.words,
            jax.device_put(idx, self.device),
            jax.device_put(mfull, self.device),
            self.g,
            self.w,
        )
        return np.asarray(counts)[:orig_b, :num_cols].astype(np.int64)

    # -- fused serving path (minimizer layout, slot scheme v2) ---------

    # queries per device dispatch in the fused path; sized on the
    # earlier accelerator, not tuned for the H100
    SERVE_CHUNK = 256
    # clean big-budget batches (per length bucket) before the tight
    # grouped-entry cap is retried in counts_batch_seqs
    SEQ_CAP_DECAY = 64

    def supports_kmer_batch(self) -> bool:
        """True when the fused ASCII-kmers-in counts path is available:
        minimizer layout, slot scheme v2, column-major tiles on device,
        and the native prep library loaded."""
        from bigsi_tpu import native

        return (
            self.layout == "minimizer"
            and self.slot_scheme in (2, 3)
            and self.cols is not None
            and native.available()
        )

    def _prep_kmer_chunk(self, kmer_rows, qstart, h):
        """One threaded native pass: ASCII k-mer rows -> device streams.

        Returns (utile, gmask, n_valid) bucketed, gmask narrowed to
        uint16 when tile_rows <= 16 (halves the host->device bytes; the
        device compare casts to the cols dtype anyway).
        """
        from bigsi_tpu import native
        from bigsi_tpu.hashing.scheme import (
            MINIMIZER_SEED,
            default_minimizer_s,
            window_to_s,
        )
        from bigsi_tpu.ops.lookup import GROUP_R

        k = kmer_rows.shape[1]
        s = window_to_s(k, self.minimizer_window) or default_minimizer_s(k)
        num_tiles = max(1, self.matrix.num_rows // self.tile_rows)
        prep = (
            native.prep_minimizer_v3
            if self.slot_scheme == 3
            else native.prep_minimizer_v2
        )
        out = prep(
            kmer_rows, qstart, s, MINIMIZER_SEED, num_tiles, h,
            self.tile_rows, self.run_len or GROUP_R,
        )
        if out is None:
            raise RuntimeError(
                "native fused prep unavailable — call "
                "supports_kmer_batch() first"
            )
        utile, gmask, n_valid = out
        if self.tile_rows <= 16:
            gmask = gmask.astype(np.uint16)
        return utile, gmask, n_valid

    def _dispatch_kmer_chunk(self, prep, num_cols):
        utile, gmask, n_valid = prep
        b = utile.shape[0]
        bb = 8
        while bb < b:
            bb *= 2
        if bb != b:
            utile = np.pad(utile, ((0, bb - b), (0, 0)))
            gmask = np.pad(gmask, ((0, bb - b), (0, 0), (0, 0)))
            n_valid = np.pad(n_valid, (0, bb - b))
        counts = _counts_batch_cols(
            self.cols,
            jax.device_put(utile, self.device),
            jax.device_put(gmask, self.device),
            jax.device_put(n_valid, self.device),
        )
        return np.asarray(counts)[:b, :num_cols].astype(np.int64)

    def counts_batch_kmers(
        self, kmer_rows: np.ndarray, qstart: np.ndarray, h: int,
        num_cols: int,
    ) -> np.ndarray:
        """Serving hot path: ASCII k-mers straight to per-query counts.

        kmer_rows uint8[n, k] (concatenated per-query distinct k-mers,
        overlap-friendly order), qstart int64[B+1] -> int64[B, num_cols].

        Fuses the whole host side (canonicalize + minimizer + slot hash
        + grouped-stream build) into ONE threaded C pass
        (native/bigsi_native.cpp:prep_minimizer_v2) and the whole device
        side into one fused XLA program per chunk
        (ops/lookup.py:grouped_counts_cols).  Batches larger than
        SERVE_CHUNK are processed in chunks with the NEXT chunk's host
        prep overlapping the current chunk's device execution (the
        native pass releases the GIL), so steady-state throughput is
        bounded by max(host prep, device step), not their sum.
        Replaces the reference's multiprocessing fan-out
        (bigsi/__main__.py:276-283).
        """
        b = len(qstart) - 1
        if b == 0:
            return np.zeros((0, num_cols), dtype=np.int64)
        chunk = self.SERVE_CHUNK
        if b <= chunk:
            return self._dispatch_kmer_chunk(
                self._prep_kmer_chunk(kmer_rows, qstart, h), num_cols
            )
        from concurrent.futures import ThreadPoolExecutor

        spans = [
            (qstart[i], qstart[min(i + chunk, b)], i, min(i + chunk, b))
            for i in range(0, b, chunk)
        ]

        def prep(span):
            r0, r1, q0, q1 = span
            qs = (qstart[q0 : q1 + 1] - qstart[q0]).astype(np.int64)
            return self._prep_kmer_chunk(kmer_rows[r0:r1], qs, h)

        out = np.zeros((b, num_cols), dtype=np.int64)
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(prep, spans[0])
            for i, span in enumerate(spans):
                ready = pending.result()
                if i + 1 < len(spans):
                    pending = pool.submit(prep, spans[i + 1])
                out[span[2] : span[3]] = self._dispatch_kmer_chunk(
                    ready, num_cols
                )
        return out

    # -- on-device serving prep (minimizer cols, slot scheme v3) -------

    def supports_seq_batch(self) -> bool:
        """True when the all-on-device path is available: minimizer
        layout, slot scheme v3, cols tiles resident, power-of-two
        tile_rows, and a modulus the device mod routine handles."""
        num_tiles = max(1, self.matrix.num_rows // self.tile_rows)
        return (
            self.layout == "minimizer"
            and self.slot_scheme == 3
            and self.cols is not None
            and self.tile_rows & (self.tile_rows - 1) == 0
            and num_tiles < (1 << 28)
        )

    @staticmethod
    def _seq_u_cap(nk: int, window: int) -> int:
        """Grouped-entry budget for the device prep: expected entries
        ~= nk / ((w+1)/2) with ~1.4x headroom, bucketed to 8.  The
        fused step's gather and compare work scale with the budget, so
        keep it tight: random streams reach u_max ~61 at nk=512, w=19
        (cap 80).  The headroom was chosen on the earlier accelerator;
        its cost on the H100 is not measured.  Overflow is safe — the
        ok flag sends the batch to the host-prep path."""
        expect = nk / max(1.0, (window + 1) / 2.0)
        cap = int(expect * 1.4) + 8
        cap = ((cap + 7) // 8) * 8
        return min(nk, cap)

    @staticmethod
    def _seq_u_tight(nk: int, window: int) -> int:
        """First-try entry budget (~1.15x expected entries): most real
        streams fit, and overflow costs one extra dispatch before the
        safe ``_seq_u_cap`` budget re-runs the batch."""
        expect = nk / max(1.0, (window + 1) / 2.0)
        return min(nk, ((int(expect * 1.15) + 4 + 7) // 8) * 8)

    def counts_batch_seqs(
        self, seqs: np.ndarray, lens: np.ndarray, k: int, h: int,
        num_cols: int,
    ):
        """Serving hottest path: padded ASCII query bytes straight to
        per-query hit counts, all on device.

        seqs uint8[B, L] (rows padded with any byte), lens int32[B] ->
        (counts int64[B, num_cols], n_valid int32[B]) where n_valid is
        the DISTINCT k-mer count per query (reference ``set(kmers)``
        semantics) — or None when a query overflows the grouped-entry
        budget (caller falls back to the host-prep path).  ACGT-only
        bytes are the caller's contract (gate before calling).
        """
        from bigsi_tpu.hashing.scheme import (
            MINIMIZER_SEED,
            default_minimizer_s,
            window_to_s,
        )
        from bigsi_tpu.ops.lookup import GROUP_R

        b, l = seqs.shape
        if b == 0:
            return (
                np.zeros((0, num_cols), dtype=np.int64),
                np.zeros(0, dtype=np.int32),
            )
        s = window_to_s(k, self.minimizer_window) or default_minimizer_s(k)
        window = k - s + 1
        num_tiles = max(1, self.matrix.num_rows // self.tile_rows)
        geom = seq_batch_geometry(seqs, lens, k, window)
        if geom is None:
            return None
        padded, lens_b, lb, u_big = geom
        # the count kernel's gather AND compare work scale with u_cap,
        # so try a TIGHT budget first (~1.15x expected entries) and
        # escalate to the safe one on overflow.  Escalation is keyed by
        # length bucket and DECAYS: one pathological batch pessimizes
        # only its own bucket, and after SEQ_CAP_DECAY clean big-budget
        # batches the tight budget is retried (bounded waste of one
        # extra dispatch per decay window, vs. a permanently sticky
        # flag that never recovered)
        nk = lb - k + 1
        u_small = self._seq_u_tight(nk, window)
        esc = self._seq_cap_esc
        remaining = esc.get(lb, 0)
        caps = (
            [u_big]
            if remaining > 0 or u_small >= u_big
            else [u_small, u_big]
        )
        pd = jax.device_put(padded, self.device)
        ld = jax.device_put(lens_b, self.device)
        for cap in caps:
            counts, n_valid, ok = _counts_batch_seqs(
                self.cols, pd, ld,
                k=k, s=s, num_tiles=num_tiles, h=h,
                tile_rows=self.tile_rows, r=self.run_len or GROUP_R,
                u_cap=cap, seed=MINIMIZER_SEED,
            )
            if bool(ok):
                if cap == u_big and remaining > 0:
                    esc[lb] = remaining - 1
                return (
                    np.asarray(counts)[:b, :num_cols].astype(np.int64),
                    np.asarray(n_valid)[:b],
                )
            if cap != u_big:
                esc[lb] = self.SEQ_CAP_DECAY
        return None


class DeviceVerifier:
    """Device-resident classic matrix for the VERIFY stage of two-stage
    search.

    Runs the classic batched counts program (``_counts_batch_fat``) on
    the candidate queries and slices the candidate colours out of the
    ``[B, W*32]`` result on the host.  On the earlier accelerator a
    candidate-restricted formulation (one-hot word selection) cost more
    than counting every word, and the device pass alone was slower than
    the host's native pass; neither was measured on the H100.  Its use
    is ``counts_async``, which OVERLAPS a device verify with the host
    pass on a disjoint query slice (``verify.split_verify_queries``).
    Same result contract as :func:`bigsi_tpu.index.verify.verify_queries`.
    """

    def __init__(self, matrix: BitSliceMatrix, device=None):
        self.matrix = matrix
        self.device = device or default_device()
        logger.info(
            "device verifier on %s (%s)",
            self.device.platform, self.device.device_kind,
        )
        fat, self.g = fat_pack(np.asarray(matrix.words))
        self.words = jax.device_put(fat, self.device)
        self.w = matrix.num_words

    def counts_async(self, row_idx_list, cand_list):
        """Dispatch the verify batch; returns a resolver callable.

        The device program is dispatched asynchronously (jax arrays are
        futures), so the caller can run host-side verification of OTHER
        queries while this computes; calling the resolver synchronizes
        and returns the per-query int64 count arrays (contract of
        ``verify_queries``)."""
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
            return lambda: out
        h = row_idx_list[live[0]].shape[1]
        kmax = bucket_size(max(row_idx_list[i].shape[0] for i in live))
        bb = 8
        while bb < len(live):
            bb *= 2
        idx = np.zeros((bb, kmax, h), dtype=np.int32)
        mask = np.zeros((bb, kmax), dtype=bool)
        for j, i in enumerate(live):
            nk = row_idx_list[i].shape[0]
            idx[j, :nk] = row_idx_list[i]
            mask[j, :nk] = True
        counts = _counts_batch_fat(
            self.words,
            jax.device_put(idx, self.device),
            jax.device_put(mask, self.device),
            self.g,
            self.w,
        )  # async dispatch — [BB, W*32] int32 future

        def resolve():
            host_counts = np.asarray(counts)
            for j, i in enumerate(live):
                colours = np.asarray(cand_list[i], dtype=np.int64)
                out[i] = host_counts[j, colours].astype(np.int64)
            return out

        return resolve

    def counts(self, row_idx_list, cand_list) -> list:
        """Synchronous form of :meth:`counts_async`."""
        return self.counts_async(row_idx_list, cand_list)()


class _PackedQuery:
    """Device presence rows for one query's (bucketed) k-mer batch."""

    def __init__(self, rows: jax.Array, k: int):
        self.rows = rows
        self.k = k

    @property
    def mask(self) -> jax.Array:
        return (jnp.arange(self.rows.shape[0]) < self.k)

    @property
    def shape(self):
        return (self.k, self.rows.shape[1])
