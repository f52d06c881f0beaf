"""Device query ops (pure jnp / XLA).

The query pipeline over the packed bitslice matrix ``uint32[m, W]``:

1. gather the ``h`` hash rows of each k-mer (``jnp.take``),
2. AND over ``h`` -> per-kmer presence ``uint32[K, W]``,
3. either AND over k-mers (exact filter) or unpack + sum (hit counts).

Replaces the reference's storage row fetches + bitarray ops
(``bigsi/graph/index.py:72-80``, ``bigsi/graph/bigsi.py:35-56``).
Every program here is plain jnp/lax that XLA compiles for the device;
there is no hand-written kernel.

Several constants and formulations below were tuned on the accelerator
this system was first built for.  They stay as they are; their effect
on the H100 is not measured (ROADMAP S5).

All shapes are static: callers bucket ``K`` (pad row indices with 0)
and pass a validity mask.  Padding k-mers contribute the AND identity
(all-ones) to the exact filter and zero to the counts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

def _bit_shifts():
    # fresh per trace — caching a jnp array globally would leak tracers
    # when first materialized inside a jit trace
    return jnp.arange(32, dtype=jnp.uint32)


def and_rows_jnp(matrix: jax.Array, row_idx: jax.Array) -> jax.Array:
    """matrix uint32[m, W], row_idx int32[K, h] -> uint32[K, W]."""
    rows = jnp.take(matrix, row_idx.reshape(-1), axis=0)
    rows = rows.reshape(row_idx.shape[0], row_idx.shape[1], -1)
    # unrolled AND over the (small, static) h axis
    out = rows[:, 0, :]
    for j in range(1, row_idx.shape[1]):
        out = out & rows[:, j, :]
    return out


def unpack_words(packed: jax.Array) -> jax.Array:
    """uint32[..., W] -> uint8 bits [..., W*32] (sample-ordered)."""
    bits = (packed[..., None] >> _bit_shifts()) & jnp.uint32(1)
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32).astype(jnp.uint8)


def counts_from_packed(packed: jax.Array, mask: jax.Array) -> jax.Array:
    """Per-sample hit counts: uint32[K, W], bool[K] -> int32[W*32].

    Equivalent of ``unpack_and_sum`` (``bigsi.py:35-44``), via the
    carry-save popcount tree (see :func:`csa_counts`).
    """
    masked = jnp.where(mask[:, None], packed, jnp.uint32(0))
    return csa_counts(masked, axis=0)


def exact_and_reduce(packed: jax.Array, mask: jax.Array) -> jax.Array:
    """AND over all valid k-mers: uint32[K, W], bool[K] -> uint32[W]."""
    ones = jnp.uint32(0xFFFFFFFF)
    masked = jnp.where(mask[:, None], packed, ones)
    return jax.lax.reduce(
        masked, ones, jax.lax.bitwise_and, dimensions=(0,)
    )


def query_counts_jnp(
    matrix: jax.Array, row_idx: jax.Array, mask: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Full single-query step: -> (counts int32[N_padded], exact uint32[W]).

    One fused jit region: gather + AND over h + (count, exact-AND).
    """
    packed = and_rows_jnp(matrix, row_idx)
    return counts_from_packed(packed, mask), exact_and_reduce(packed, mask)


def batched_counts_jnp(matrix, row_idx, mask):
    """Batched hit counts: row_idx int32[B, K, h], mask bool[B, K]
    -> counts int32[B, W*32]."""
    b, k, h = row_idx.shape
    packed = and_rows_jnp(matrix, row_idx.reshape(b * k, h)).reshape(b, k, -1)
    masked = jnp.where(mask[:, :, None], packed, jnp.uint32(0))
    return csa_counts(masked, axis=1)


TILE_ROWS = 32


def blocked_presence(
    tiles: jax.Array, tile_idx: jax.Array, slot_mask: jax.Array,
    tile_rows: int = TILE_ROWS,
) -> jax.Array:
    """Blocked-layout lookup: one tile fetch per k-mer, no row gather.

    ``tiles`` uint32[T, tile_rows*W]; ``tile_idx`` int32[K] (which tile
    holds each k-mer's h rows); ``slot_mask`` uint32[K] (bit s set if
    tile row s is one of the k-mer's hash rows) -> presence uint32[K, W].

    The per-kmer AND over its h tile rows is computed WITHOUT selecting
    them: every non-selected row is replaced by the AND identity
    (all-ones) and the whole tile is AND-reduced.  That turns a
    second gather into pure fused vector work.
    """
    k = tile_idx.shape[0]
    w = tiles.shape[1] // tile_rows
    g = jnp.take(tiles, tile_idx, axis=0).reshape(k, tile_rows, w)
    r = jax.lax.broadcasted_iota(jnp.uint32, (1, tile_rows, 1), 1)
    sel = ((slot_mask[:, None, None] >> r) & jnp.uint32(1)).astype(bool)
    masked = jnp.where(sel, g, jnp.uint32(0xFFFFFFFF))
    return jax.lax.reduce(
        masked, jnp.uint32(0xFFFFFFFF), jax.lax.bitwise_and, (1,)
    )


def blocked_counts(tiles, tile_idx, slot_mask, mask, tile_rows: int = TILE_ROWS):
    """Batched blocked-layout hit counts.

    tile_idx int32[B, K], slot_mask uint32[B, K], mask bool[B, K]
    -> counts int32[B, W*32].
    """
    b, k = tile_idx.shape
    packed = blocked_presence(
        tiles, tile_idx.reshape(-1), slot_mask.reshape(-1), tile_rows
    ).reshape(b, k, -1)
    masked = jnp.where(mask[:, :, None], packed, jnp.uint32(0))
    return csa_counts(masked, axis=1)


def _add_planes(a: list, b: list) -> list:
    """Bitwise bignum add of two bit-sliced counts (lists of uint32
    planes, LSB first).  Plane arithmetic: full adder per bit position.
    """
    out = []
    carry = None
    for i in range(max(len(a), len(b))):
        x = a[i] if i < len(a) else None
        y = b[i] if i < len(b) else None
        terms = [t for t in (x, y, carry) if t is not None]
        if len(terms) == 1:
            out.append(terms[0])
            carry = None
        elif len(terms) == 2:
            out.append(terms[0] ^ terms[1])
            carry = terms[0] & terms[1]
        else:
            s = terms[0] ^ terms[1]
            out.append(s ^ terms[2])
            carry = (terms[0] & terms[1]) | (s & terms[2])
    if carry is not None:
        out.append(carry)
    return out


def csa_counts_planes(planes: list, axis: int = -2) -> jax.Array:
    """Carry-save popcount from an ALREADY bit-sliced count: ``planes``
    is a list of uint32 arrays (LSB plane first) each ``[..., K, W]``;
    reduces along ``axis`` and unpacks to int32 counts ``[..., W*32]``.

    Lets callers fuse the tree's first level(s) into an upstream
    producer (e.g. the grouped sibling reduces combine presence pairs
    in-register before anything is written to HBM) and hand the rest of
    the reduction here.
    """
    planes = [jnp.moveaxis(p, axis, -2) for p in planes]
    while planes[0].shape[-2] > 1:
        kc = planes[0].shape[-2]
        if kc % 2:
            pad = [(0, 0)] * planes[0].ndim
            pad[-2] = (0, 1)
            planes = [jnp.pad(p, pad) for p in planes]
        a = [p[..., 0::2, :] for p in planes]
        b = [p[..., 1::2, :] for p in planes]
        planes = _add_planes(a, b)
    planes = [p[..., 0, :] for p in planes]
    shifts = _bit_shifts()
    total = None
    for i, p in enumerate(planes):
        bits = ((p[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.int32)
        term = bits << i
        total = term if total is None else total + term
    return total.reshape(*total.shape[:-2], total.shape[-2] * 32)


def csa_counts(rows: jax.Array, axis: int = -2) -> jax.Array:
    """Per-sample-bit popcount over an axis of packed rows, WITHOUT the
    32x unpack: int32[..., W*32].

    Reduces ``uint32[..., K, W]`` along ``K`` with a carry-save adder
    tree in bit-sliced form (each partial sum is a list of uint32
    planes), then unpacks only the ~log2(K) result planes.  ~10x fewer
    vector operations than the unpack-then-sum formulation of the reference's
    ``unpack_and_sum`` (``bigsi/graph/bigsi.py:35-44``).

    Masking: zero out masked rows BEFORE calling (a zero row adds 0).

    The level-wise vectorized tree lives in :func:`csa_counts_planes`
    (each level halves K by adding even/odd row pairs in one op).
    """
    return csa_counts_planes([rows], axis)


GROUP_R = 6  # k-mers per distinct tile in the grouped layout (runs ~6)
# chosen on the earlier accelerator over R=8 and R=12; not measured on
# the H100.


def build_grouped_streams(
    tile, smask, r: int = GROUP_R, u_bucket: int = 16, slots=None
):
    """Host prep for the grouped (tile-deduplicated) XLA query path.

    tile int32[B, K] (tile id per k-mer), smask uint32[B, K] (0 = pad)
    -> (utile int32[B, U], gmask uint32[B, U, r]) where each distinct
    consecutive tile run becomes one ``utile`` entry and its k-mers'
    slot masks fill the run's ``gmask`` row (runs longer than ``r``
    spill into a fresh entry with the same tile id).  U is the max
    spilled-run count over the batch, rounded up to ``u_bucket``.

    With the minimizer layout (~6 consecutive k-mers share a tile) this
    cuts the issue-rate-bound device gather ~6x; the expansion back to
    per-kmer presence happens as dense masked-AND vector work.

    If ``slots`` (int[B, K, h] per-kmer tile-row indices) is given, a
    third array ``uslot int32[B, U, r, h]`` is returned with the same
    scatter (padding entries hold 0) — used by selection paths that
    need the h row ids separately rather than as a bit mask.

    This sits on the serving critical path (numpy cost ~8 ms per
    [256, 512] batch vs ~1.4 ms device time), so a C fast path handles
    the no-``slots`` form (native/bigsi_native.cpp:grouped_streams,
    parity-tested in tests/test_native.py).
    """
    import numpy as np

    b, k = tile.shape
    if slots is None and b * k:
        from bigsi_tpu import native

        fast = native.grouped_streams(tile, smask, r)
        if fast is not None:
            utile_full, gmask_full, u_max = fast
            u = max(u_bucket, ((u_max + u_bucket - 1) // u_bucket) * u_bucket)
            if u <= k:
                return (
                    np.ascontiguousarray(utile_full[:, :u]),
                    np.ascontiguousarray(gmask_full[:, :u]),
                )
            utile_pad = np.zeros((b, u), dtype=np.int32)
            gmask_pad = np.zeros((b, u, r), dtype=np.uint32)
            utile_pad[:, :k] = utile_full
            gmask_pad[:, :k] = gmask_full
            return utile_pad, gmask_pad
    valid = smask != 0
    tt = np.where(valid, tile, -1)
    new = np.ones((b, k), dtype=bool)
    new[:, 1:] = tt[:, 1:] != tt[:, :-1]
    new &= valid
    # spill runs longer than r: position within run
    run_id = np.cumsum(new, axis=1) - 1  # per-query run index (valid only)
    # position within run: index - first index of run
    idx = np.arange(k)[None, :]
    first_of_run = np.zeros((b, k), dtype=np.int64)
    np.maximum.accumulate(np.where(new, idx, 0), axis=1, out=first_of_run)
    pos = idx - first_of_run
    group = run_id * 0  # placeholder, computed below
    # entry index = run_id offset by spills: each run contributes
    # ceil(run_len/r) entries; entry = base[run] + pos // r.  Compute
    # base via cumsum of per-run spill counts — vectorized per query.
    spill = pos // r  # which spill segment within the run
    # new_entry marks k-mers that OPEN an entry (run start or spill point)
    new_entry = new | (valid & (pos % r == 0))
    entry = np.cumsum(new_entry, axis=1) - 1
    entry = np.where(valid, entry, 0)
    slot_in_entry = pos % r
    u_max = int(new_entry.sum(axis=1).max()) if k else 0
    u = max(u_bucket, ((u_max + u_bucket - 1) // u_bucket) * u_bucket)
    utile = np.zeros((b, u), dtype=np.int32)
    gmask = np.zeros((b, u, r), dtype=np.uint32)
    bi, ki = np.nonzero(new_entry)
    utile[bi, entry[bi, ki]] = tile[bi, ki]
    vi = np.nonzero(valid)
    gmask[vi[0], entry[vi], slot_in_entry[vi]] = smask[vi]
    if slots is None:
        return utile, gmask
    uslot = np.zeros((b, u, r, slots.shape[2]), dtype=np.int32)
    uslot[vi[0], entry[vi], slot_in_entry[vi], :] = slots[vi]
    return utile, gmask, uslot


def grouped_counts(
    tiles: jax.Array, utile: jax.Array, gmask: jax.Array,
    tile_rows: int = TILE_ROWS,
):
    """Grouped-layout batched hit counts (one gather per DISTINCT tile).

    tiles uint32[T, tile_rows*W], utile int32[B, U],
    gmask uint32[B, U, R] -> counts int32[B, W*32].

    The per-slot presence expansion is written as R SIBLING reduces over
    the one gathered input (not one broadcast [B, U, R, rows, W] reduce):
    XLA multi-output-fuses the siblings into a single pass that reads
    the gathered tiles from device memory ONCE instead of once per slot.
    That won on the earlier accelerator; not measured on the H100.
    """
    b, u = utile.shape
    r = gmask.shape[2]
    w = tiles.shape[1] // tile_rows
    g = jnp.take(tiles, utile.reshape(-1), axis=0).reshape(b, u, tile_rows, w)
    rowbit = jax.lax.broadcasted_iota(jnp.uint32, (1, 1, tile_rows, 1), 2)
    pres = []
    for j in range(r):
        # arithmetic masking (sel-1: 0 if selected, all-ones otherwise)
        # instead of a bool where
        sel = (gmask[:, :, j, None, None] >> rowbit) & jnp.uint32(1)
        masked = g | (sel - jnp.uint32(1))
        p = jax.lax.reduce(
            masked, jnp.uint32(0xFFFFFFFF), jax.lax.bitwise_and, (2,)
        )  # [B, U, W]
        valid = (gmask[:, :, j] != 0)[..., None]
        pres.append(jnp.where(valid, p, jnp.uint32(0)))
    rows = jnp.stack(pres, axis=2).reshape(b, u * r, w)
    return csa_counts(rows, axis=1)


def cols_dtype(tile_rows: int):
    """Narrowest unsigned dtype holding one sample's tile column."""
    if tile_rows <= 8:
        return jnp.uint8
    if tile_rows <= 16:
        return jnp.uint16
    if tile_rows <= 32:
        return jnp.uint32
    return None  # tile_rows > 32: no cols layout (use grouped_counts)


def pack_tile_cols(tiles: jax.Array, tile_rows: int = TILE_ROWS) -> jax.Array:
    """Row-major tiles -> column-major tile columns (derived layout).

    ``tiles`` uint32[T, tile_rows*W] (bitslice rows, sample bit n at
    word n//32 bit n%32) -> ``cols`` uintX[T, W*32] where ``cols[t, n]``
    holds sample n's tile_rows-bit column (bit s = row s of the tile).

    Same bits, transposed within each tile: lets the query path test a
    k-mer's h rows with ONE compare per sample —
    ``(col & slot_mask) == slot_mask`` — instead of a masked AND-reduce
    across tile_rows bitslice rows (see :func:`grouped_counts_cols`).
    Derived on device from the canonical row-major matrix at engine
    load; never persisted.

    Chunked with ``lax.map`` over tile blocks: the 32x bit-unpack
    intermediate is bounded per chunk instead of materializing
    ~12 GB at the m=2.5e7 config.
    """
    t, x = tiles.shape
    w = x // tile_rows
    dtype = cols_dtype(tile_rows)

    def pack_chunk(chunk):
        tc = chunk.shape[0]
        g = chunk.reshape(tc, tile_rows, w, 1)
        bits = (g >> _bit_shifts().reshape(1, 1, 1, 32)) & jnp.uint32(1)
        rows = jnp.arange(tile_rows, dtype=jnp.uint32).reshape(
            1, tile_rows, 1, 1
        )
        cols = jax.lax.reduce(
            bits << rows, jnp.uint32(0), jax.lax.bitwise_or, (1,)
        )  # [tc, w, 32]
        return cols.reshape(tc, w * 32).astype(dtype)

    chunk = 65536
    if t <= chunk:
        return pack_chunk(tiles)
    nfull = t // chunk
    body = jax.lax.map(
        pack_chunk, tiles[: nfull * chunk].reshape(nfull, chunk, x)
    ).reshape(nfull * chunk, w * 32)
    if nfull * chunk == t:
        return body
    return jnp.concatenate([body, pack_chunk(tiles[nfull * chunk :])])


def pack_tile_cols_host(words, tile_rows: int = TILE_ROWS):
    """Host (numpy) twin of :func:`pack_tile_cols`: row-major packed
    words uint32[m, W] -> column-major tile columns uintX[T, W*32].
    Chunked over tiles so the 32x bit-unpack intermediate stays bounded;
    used to stage the cols layout onto device meshes (the device
    version targets the single-chip engine)."""
    import numpy as np

    dtype = cols_dtype(tile_rows)
    m, w = words.shape
    t = -(-m // tile_rows)
    m_pad = t * tile_rows
    if m_pad != m:
        grown = np.zeros((m_pad, w), dtype=np.uint32)
        grown[:m] = words
        words = grown
    if dtype is None:
        raise ValueError("no cols layout for tile_rows=%d" % tile_rows)
    out = np.empty((t, w * 32), dtype=np.dtype(dtype.__name__))
    shifts32 = np.arange(32, dtype=np.uint32)
    rowbits = np.arange(tile_rows, dtype=np.uint64)[None, :, None]
    chunk = max(1, (1 << 22) // max(1, tile_rows * w * 32))
    t3 = words.reshape(t, tile_rows, w)
    for t0 in range(0, t, chunk):
        blk = t3[t0 : t0 + chunk]
        bits = ((blk[:, :, :, None] >> shifts32) & np.uint32(1)).astype(
            np.uint64
        )  # [tc, tr, W, 32]
        colsv = (bits << rowbits[:, :, :, None]).sum(axis=1)  # [tc, W, 32]
        out[t0 : t0 + chunk] = colsv.reshape(blk.shape[0], w * 32).astype(
            out.dtype
        )
    return out


def grouped_counts_cols(
    cols: jax.Array, utile: jax.Array, gmask: jax.Array, n_valid: jax.Array
):
    """Grouped-layout hit counts over the column-major tile layout.

    cols uintX[T, N] (see :func:`pack_tile_cols`), utile int32[B, U],
    gmask uint32[B, U, R] (0 = padding slot), n_valid int32[B] (count of
    valid k-mers per query) -> counts int32[B, N].

    Presence of k-mer j of entry u at sample n is
    ``(cols[utile, n] & gmask) == gmask`` — h-row membership tested in
    ONE compare per sample instead of a masked AND-reduce over
    tile_rows rows.  The whole step is a single fused XLA reduction
    over U (gather -> compare -> sum), so the gathered tiles stream
    from device memory once and nothing per-slot materializes.  Padding
    slots (gmask == 0) compare true everywhere; the fixed overcount
    ``U*R - n_valid`` is subtracted at the end.

    Bit-exact vs :func:`grouped_counts` on the same streams
    (tests/test_layout.py): the csa tree and the per-slot expansion
    passes disappear.  The U-sum runs as TWO independent half-U
    reduction chains, and accumulates in int16 when U*R < 2^15 (every
    per-query count is bounded by U*R slots, so int16 cannot overflow).
    Both choices won on the earlier accelerator; neither is measured on
    the H100 (ROADMAP S5).
    """
    b, u = utile.shape
    gm = gmask.astype(cols.dtype)
    acc = jnp.int16 if u * gmask.shape[2] < 2 ** 15 else jnp.int32
    halves = (slice(0, u // 2), slice(u // 2, u)) if u >= 2 else (slice(0, u),)
    counts = None
    for sl in halves:
        g = jnp.take(cols, utile[:, sl].reshape(-1), axis=0).reshape(
            b, utile[:, sl].shape[1], -1
        )
        part = None
        for j in range(gmask.shape[2]):
            gmj = gm[:, sl, j][:, :, None]
            pj = ((g & gmj) == gmj).astype(acc)
            part = pj if part is None else part + pj
        s = part.sum(axis=1, dtype=acc)  # [B, N]
        counts = s if counts is None else counts + s
    pad = jnp.int32(u * gmask.shape[2]) - n_valid.astype(jnp.int32)
    return counts.astype(jnp.int32) - pad[:, None]


def cols_presence(
    cols: jax.Array, tile_idx: jax.Array, slot_mask: jax.Array
) -> jax.Array:
    """Per-k-mer presence rows from the column-major layout.

    cols uintX[T, N], tile_idx int32[K], slot_mask uint32[K] (0 = pad)
    -> packed presence uint32[K, W] (bit n%32 of word n//32 = presence
    at sample n), matching :func:`blocked_presence` bit-for-bit —
    padding k-mers (slot_mask 0) produce the AND identity (all-ones),
    and zero-padded samples produce 0.
    """
    g = jnp.take(cols, tile_idx, axis=0)  # [K, N]
    sm = slot_mask.astype(g.dtype)[:, None]
    bits = ((g & sm) == sm).astype(jnp.uint32)  # [K, N] 0/1
    k, n = bits.shape
    w = n // 32
    words = bits.reshape(k, w, 32) << _bit_shifts().reshape(1, 1, 32)
    return jax.lax.reduce(words, jnp.uint32(0), jax.lax.bitwise_or, (2,))


def make_full_query_step(m: int, h: int):
    """ONE-program serving step: raw ASCII k-mers in, hit counts out.

    step(words, kmers, mask) with words uint32[m, W], kmers
    uint8[B, K, klen], mask bool[B, K] -> counts int32[B, W*32].

    Everything runs on device — canonicalization, murmur3 hashing, row
    gather, AND over h, masked unpack-sum — so the host's only job is
    padding the query batch (SURVEY §5.8's small-dispatch design).
    Classic layout.
    """
    from bigsi_tpu.ops.hash_jax import canonicalize_jax, row_indices_jax

    @jax.jit
    def step(words, kmers, mask):
        b, k, klen = kmers.shape
        canon = canonicalize_jax(kmers.reshape(b * k, klen))
        idx = row_indices_jax(canon, h, m).reshape(b, k, h)
        return batched_counts_jnp(words, idx, mask)

    return step


def best_query_step(m: int, b: int, k: int, h: int):
    """Currently-best jitted batched step for the bench/serving loop.

    step(words, idx, mask, salt) -> (counts, salt'): the salt chains
    steps into a dependency sequence (benchmarking) and perturbs the
    row indices so identical dispatches can't be coalesced.
    """

    @jax.jit
    def step(words, idx, mask, salt):
        idx = (idx + salt) % m
        counts = batched_counts_jnp(words, idx, mask)
        return counts, (counts[0, 0] & jnp.int32(7))

    return step
