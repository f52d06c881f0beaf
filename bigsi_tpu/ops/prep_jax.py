"""On-device serving prep: raw ACGT bytes -> grouped query streams.

Moves the ENTIRE minimizer serving prep (2-bit packing, strand
canonicalization, splitmix64 s-mer ordering, window minima, tile +
slot-mask derivation, distinct-kmer dedup, run grouping) onto the
device, so one jitted program goes from padded query bytes straight to
per-colour hit counts.  This takes the host prep off the serving path:
the host's only job is padding bytes into a [B, L] uint8 array.

Semantics are EXACTLY slot scheme v3 (hashing/scheme.py: pack_codes_v3
/ splitmix64 / minimizer_tiles scheme=3 / slot_hashes_v3), including
the reference's distinct-raw-kmer dedup (``set(kmers)``,
bigsi/graph/bigsi.py:178) — parity-tested against the numpy oracle and
the native C prep (tests/test_prep_jax.py).  ACGT-only input is the
caller's contract, exactly as for native.prep_minimizer_v3_seqs (the
facade falls back to the host path otherwise).

Design notes.  These were written for the accelerator this system was
first built for, which has no uint64 and whose scatters serialize.
They stay as written; whether each pays on the H100 (which has both
64-bit integers and fast scatters) is not measured (ROADMAP S4):

* every 64-bit quantity is a (hi, lo) uint32 pair.  The two splitmix64
  multiplies are built from 16-bit partial products (4 wrapping u32
  muls each) — ~35 vector ops per element, small against the
  [B, U, N] counting work downstream.
* ``% num_tiles`` (num_tiles is a compile-time constant < 2^28) runs
  as an unrolled 16x4-bit long division in u32 — each step is a
  shift/or plus a constant-divisor u32 mod that XLA strength-reduces
  to a multiply.
* Run grouping uses NO scatter: run starts
  come from a cummax, entry ids from a cumsum, and the [B, U] /
  [B, U, r] stream tensors from one-hot compare-sums that XLA fuses
  into the reductions.  Duplicate k-mers KEEP their slot position with
  a zeroed slot mask — a zero mask compares true everywhere and is
  removed by the kernel's existing U*r - n_valid padding correction
  (ops/lookup.py:grouped_counts_cols), so dedup never perturbs the run
  structure.
* Everything is static-shaped: B, L, U are bucket parameters; a
  per-batch ``ok`` flag reports entry-budget overflow (adversarial
  tile alternation) and the caller re-runs that batch on the host
  path.  Counts stay exact in both arms.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32

# NK-axis chunk for the two quadratic prep passes (dup compare and
# one-hot stream build): bounds their intermediate tensors to
# [B, PREP_CHUNK, NK] / [B, U*r, PREP_CHUNK] for any query length
PREP_CHUNK = 1024

# splitmix64 constants (Steele et al. 2014), split into u32 halves
_SM_GAMMA = (0x9E3779B9, 0x7F4A7C15)
_SM_MUL1 = (0xBF58476D, 0x1CE4E5B9)
_SM_MUL2 = (0x94D049BB, 0x133111EB)


def _c(x):
    return jnp.asarray(x, dtype=U32)


def u64_xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def u64_shr(a, n: int):
    """Logical right shift by a static 0 < n < 64."""
    hi, lo = a
    if n >= 32:
        return (jnp.zeros_like(hi), hi >> (n - 32) if n > 32 else hi)
    return (hi >> n, (lo >> n) | (hi << (32 - n)))


def u64_add_const(a, c: tuple):
    hi, lo = a
    lo2 = lo + _c(c[1])
    carry = (lo2 < _c(c[1])).astype(U32)
    return (hi + _c(c[0]) + carry, lo2)


def _mul32_hilo(a, b_const: int):
    """u32 lane array x u32 constant -> (hi32, lo32) of the product."""
    bl = b_const & 0xFFFF
    bh = (b_const >> 16) & 0xFFFF
    al = a & _c(0xFFFF)
    ah = a >> 16
    p0 = al * _c(bl)
    p1 = al * _c(bh)
    p2 = ah * _c(bl)
    p3 = ah * _c(bh)
    mid = (p0 >> 16) + (p1 & _c(0xFFFF)) + (p2 & _c(0xFFFF))
    lo = (mid << 16) | (p0 & _c(0xFFFF))
    hi = p3 + (p1 >> 16) + (p2 >> 16) + (mid >> 16)
    return hi, lo


def u64_mul_const(a, c: tuple):
    """(hi, lo) * 64-bit constant, mod 2^64."""
    hi, lo = a
    c_hi = c[0]
    c_lo = c[1]
    p_hi, p_lo = _mul32_hilo(lo, c_lo)
    # cross terms only contribute to the high word (mod 2^64)
    p_hi = p_hi + lo * _c(c_hi) + hi * _c(c_lo)
    return (p_hi, p_lo)


def splitmix64_jax(a):
    """Vectorized splitmix64 on (hi, lo) uint32-pair arrays."""
    z = u64_add_const(a, _SM_GAMMA)
    z = u64_mul_const(u64_xor(z, u64_shr(z, 30)), _SM_MUL1)
    z = u64_mul_const(u64_xor(z, u64_shr(z, 27)), _SM_MUL2)
    return u64_xor(z, u64_shr(z, 31))


def u64_lt(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def u64_min(a, b):
    take_a = ~u64_lt(b, a)  # a <= b
    return (
        jnp.where(take_a, a[0], b[0]),
        jnp.where(take_a, a[1], b[1]),
    )


def u64_mod_const(a, d: int):
    """(hi, lo) % d for a static d < 2^28 -> u32.

    Unrolled base-16 long division: the running remainder r < d, so
    (r << 4) | nibble < 2^32 and each step's ``% d`` is a
    constant-divisor u32 mod (XLA lowers it to a reciprocal multiply).
    """
    if d <= 0:
        raise ValueError("modulus must be positive")
    if d == 1:
        return jnp.zeros_like(a[0])
    if d >= 1 << 28:
        raise ValueError("u64_mod_const supports d < 2^28, got %d" % d)
    if d & (d - 1) == 0:
        # power of two: low bits only (d < 2^28 -> within lo except
        # when... d < 2^28 so mask fits in the low word plus nothing)
        return a[1] & _c(d - 1)
    hi, lo = a
    r = jnp.zeros_like(hi)
    dd = _c(d)
    for word in (hi, lo):
        for shift in (28, 24, 20, 16, 12, 8, 4, 0):
            nib = (word >> shift) & _c(0xF)
            r = ((r << 4) | nib) % dd
    return r


# ---------------------------------------------------------------- packing


def byte_codes(seq_u8):
    """ASCII bytes -> 2-bit codes (A/other=0 C=1 G=2 T=3) as uint32."""
    b = seq_u8.astype(jnp.int32)
    return (
        (b == ord("C")).astype(U32)
        + _c(2) * (b == ord("G")).astype(U32)
        + _c(3) * (b == ord("T")).astype(U32)
    )


def byte_comp_codes(seq_u8):
    """2-bit codes of the BYTE-complemented bases (scheme.py
    pack_codes_v3 rc semantics: complement only ACGT; other bytes keep
    code 0 — comp('A')=T=3, comp('C')=G=2, comp('G')=C=1, else 0)."""
    b = seq_u8.astype(jnp.int32)
    return (
        _c(3) * (b == ord("A")).astype(U32)
        + _c(2) * (b == ord("C")).astype(U32)
        + (b == ord("G")).astype(U32)
    )


def _pack_windows(codes, length: int, count: int):
    """codes uint32[..., L] -> (hi, lo) uint32[..., count] where window
    i packs codes[i : i + length] MSB-first into a 2*length-bit value
    split as hi = leading length-16 bases (0 if length <= 16), lo =
    trailing min(length, 16) bases."""
    n_lo = min(length, 16)
    n_hi = length - n_lo
    lo = None
    for j in range(n_lo):
        term = codes[..., n_hi + j : n_hi + j + count] << (2 * (n_lo - 1 - j))
        lo = term if lo is None else lo | term
    if n_hi == 0:
        return jnp.zeros_like(lo), lo
    hi = None
    for j in range(n_hi):
        term = codes[..., j : j + count] << (2 * (n_hi - 1 - j))
        hi = term if hi is None else hi | term
    return hi, lo


def _pack_windows_rc(ccodes, length: int, count: int):
    """Reverse-complement windows: window i packs
    ccodes[i + length - 1], ..., ccodes[i] MSB-first (the byte-revcomp
    of the window), same (hi, lo) split."""
    n_lo = min(length, 16)
    n_hi = length - n_lo
    # rc position p (MSB-first) draws from ccodes[i + length - 1 - p]
    lo = None
    for p in range(n_hi, length):
        j = length - 1 - p
        term = ccodes[..., j : j + count] << (2 * (length - 1 - p))
        lo = term if lo is None else lo | term
    if n_hi == 0:
        return jnp.zeros_like(lo), lo
    hi = None
    for p in range(n_hi):
        j = length - 1 - p
        term = ccodes[..., j : j + count] << (2 * (n_hi - 1 - p))
        hi = term if hi is None else hi | term
    return hi, lo


def _sliding_min_u64(pair, w: int):
    """Sliding-window minimum over the last axis: value i of the result
    is min(pair[..., i : i + w]); output length shrinks by w - 1.
    Doubling spans: log2(w) vectorized min passes."""
    hi, lo = pair
    span = 1
    while span * 2 <= w:
        hi, lo = u64_min(
            (hi[..., : hi.shape[-1] - span], lo[..., : lo.shape[-1] - span]),
            (hi[..., span:], lo[..., span:]),
        )
        span *= 2
    rem = w - span  # 0 <= rem < span: overlapping spans cover w exactly
    if rem:
        hi, lo = u64_min(
            (hi[..., : hi.shape[-1] - rem], lo[..., : lo.shape[-1] - rem]),
            (hi[..., rem:], lo[..., rem:]),
        )
    return hi, lo


# ------------------------------------------------------------- the prep


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "s", "num_tiles", "h", "tile_rows", "r", "u_cap", "seed",
    ),
)
def prep_streams_device(
    seqs,  # uint8[B, L] padded query bytes
    lens,  # int32[B] real byte lengths
    *,
    k: int,
    s: int,
    num_tiles: int,
    h: int,
    tile_rows: int,
    r: int,
    u_cap: int,
    seed: int = 0x5EED5EED,
):
    """Slot-scheme-v3 grouped streams, entirely on device.

    Returns (utile int32[B, u_cap], gmask uint32[B, u_cap, r], n_valid
    int32[B], ok bool[]): the same stream contract as
    native.prep_minimizer_v3_seqs, with ``ok`` False when any query
    needs more than ``u_cap`` grouped entries (caller falls back).
    ``n_valid`` counts DISTINCT k-mers (reference ``set(kmers)``).
    """
    if tile_rows & (tile_rows - 1):
        raise ValueError("device prep needs power-of-two tile_rows")
    if k > 32 or s < 1 or s > k:
        raise ValueError("device prep needs k <= 32, 1 <= s <= k")
    if h > 10:
        raise ValueError("slot scheme v3 supports h <= 10")
    b, l = seqs.shape
    w = k - s + 1
    nk = l - k + 1  # k-mer window positions (static)
    ns = l - s + 1  # s-mer window positions (static)
    if nk < 1:
        raise ValueError("L < k")

    codes = byte_codes(seqs)  # [B, L]
    ccodes = byte_comp_codes(seqs)

    # ---- per-kmer canonical codes + slot masks
    fwd = _pack_windows(codes, k, nk)  # (hi, lo) [B, NK]
    rc = _pack_windows_rc(ccodes, k, nk)
    canon = u64_min(fwd, rc)
    hv = splitmix64_jax(canon)
    hv_full_hi, hv_full_lo = hv
    sm = None
    for j in range(h):
        sh = 6 * j
        if sh == 0:
            field = hv_full_lo
        elif sh < 32:
            field = (hv_full_lo >> sh) | (hv_full_hi << (32 - sh))
        else:
            field = hv_full_hi >> (sh - 32)
        slot = field & _c(tile_rows - 1)
        bit = _c(1) << slot
        sm = bit if sm is None else sm | bit
    # [B, NK] uint32 slot masks

    # ---- per-kmer minimizer tile
    sf = _pack_windows(codes, s, ns)
    sr = _pack_windows_rc(ccodes, s, ns)
    canon_s = u64_min(sf, sr)
    seed_pair = ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
    whash = splitmix64_jax(
        (canon_s[0] ^ _c(seed_pair[0]), canon_s[1] ^ _c(seed_pair[1]))
    )
    mn = _sliding_min_u64(whash, w)  # [B, NK]
    tile = u64_mod_const(mn, num_tiles).astype(jnp.int32)  # [B, NK]

    # ---- validity + distinct-kmer dedup (reference set(kmers))
    iota = jnp.arange(nk, dtype=jnp.int32)[None, :]
    valid = iota < (lens[:, None] - (k - 1))  # [B, NK]
    # dup[i] = exists valid i' < i with the same raw-strand code.
    # The pairwise compare is chunked along i (PREP_CHUNK rows vs the
    # i' < chunk-end prefix) so long queries cost bounded memory: the
    # [B, NK, NK] one-shot tensor capped the path at ~1 kb queries
    # (VERDICT r4 weak #6); total work stays O(NK^2) but the geometry
    # guard (device_engine.seq_batch_geometry) now bounds B*NK^2, not NK
    dup_parts = []
    for c0 in range(0, nk, PREP_CHUNK):
        c1 = min(c0 + PREP_CHUNK, nk)
        eq = (fwd[0][:, c0:c1, None] == fwd[0][:, None, :c1]) & (
            fwd[1][:, c0:c1, None] == fwd[1][:, None, :c1]
        )  # [B, C, c1] — fused into the reduction below
        earlier = (
            jnp.arange(c0, c1, dtype=jnp.int32)[:, None]
            > jnp.arange(c1, dtype=jnp.int32)[None, :]
        )[None]  # i > i'
        dup_parts.append(
            jnp.any(eq & earlier & valid[:, None, :c1], axis=2)
        )
    dup = jnp.concatenate(dup_parts, axis=1) & valid
    appended = valid & ~dup
    n_valid = appended.sum(axis=1, dtype=jnp.int32)
    sm = jnp.where(appended, sm, _c(0))  # dup/invalid: zero mask slot

    # ---- run grouping (dups keep their slot; see module docstring)
    prev_tile = jnp.concatenate(
        [jnp.full((b, 1), -1, jnp.int32), tile[:, :-1]], axis=1
    )
    new_run = valid & ((iota == 0) | (tile != prev_tile))
    run_start = jax.lax.cummax(
        jnp.where(new_run, iota, jnp.int32(-1)), axis=1
    )
    pos = iota - run_start  # position within run (valid where valid)
    new_entry = valid & (new_run | (pos % r == 0))
    entry = jnp.cumsum(new_entry.astype(jnp.int32), axis=1) - 1
    slot = pos % r
    u_count = new_entry.sum(axis=1, dtype=jnp.int32)
    ok = jnp.all(u_count <= u_cap)

    # ---- one-hot compare-sums (no scatter), chunked along NK like the
    # dup pass: the [B, U*r, NK] tensor is the other quadratic-in-NK
    # term (U scales with NK/window), and each key occurs at most once
    # so chunk partial sums stay exact selections
    u_iota = jnp.arange(u_cap, dtype=jnp.int32)
    key = jnp.where(valid, entry * r + slot, jnp.int32(-1))  # [B, NK]
    x_iota = jnp.arange(u_cap * r, dtype=jnp.int32)
    # selection sums run at the narrowest width that holds a slot mask
    # (uint16 halves the bytes of the dominant pass when tile_rows <=
    # 16; chosen on the earlier accelerator, not measured on the H100)
    acc = jnp.uint16 if tile_rows <= 16 else U32
    utile = None
    gflat = None
    for c0 in range(0, nk, PREP_CHUNK):
        c1 = min(c0 + PREP_CHUNK, nk)
        is_open = new_entry[:, None, c0:c1] & (
            entry[:, None, c0:c1] == u_iota[None, :, None]
        )
        u_part = (is_open * tile[:, None, c0:c1]).sum(axis=2)
        utile = u_part if utile is None else utile + u_part
        onehot = key[:, None, c0:c1] == x_iota[None, :, None]
        g_part = (onehot * sm[:, c0:c1].astype(acc)[:, None, :]).sum(
            axis=2, dtype=acc
        )
        gflat = g_part if gflat is None else gflat + g_part
    utile = utile.astype(jnp.int32)
    gmask = gflat.astype(U32).reshape(b, u_cap, r)
    return utile, gmask, n_valid, ok


def prep_streams_host_oracle(seqs, lens, **kw):
    """Numpy reference for tests: route through the native seq prep."""
    from bigsi_tpu import native

    b, l = seqs.shape
    parts = [np.asarray(seqs[i, : lens[i]], dtype=np.uint8) for i in range(b)]
    flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    sstart = np.zeros(b + 1, dtype=np.int64)
    np.cumsum([p.size for p in parts], out=sstart[1:])
    return native.prep_minimizer_v3_seqs(
        flat, sstart, kw["k"], kw["s"], kw.get("seed", 0x5EED5EED),
        kw["num_tiles"], kw["h"], kw["tile_rows"], kw["r"],
    )
