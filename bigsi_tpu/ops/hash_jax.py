"""On-device MurmurHash3_x86_32 (jnp/uint32): hash k-mers on the device.

Bit-exact with ``bigsi_tpu.hashing.murmur3`` (and therefore with the
reference's ``mmh3.hash``, ``bigsi/bloom/bloomfilter.py:5-13``; golden
values ``bigsi/tests/bloom/test_create_bloomfilter.py:5-8``).

Why a device hasher: the host hash path (native C++/numpy) is ample for
interactive queries, but the multi-host serving design broadcasts raw
ASCII k-mer batches to every host (SURVEY §5.8) — hashing on device
keeps the dispatch payload small and removes the host from the
per-query critical path.  The whole query then runs as ONE program:
hash -> row indices -> gather/AND -> counts.

All ops are uint32 vector arithmetic (multiplies, rotates, xors) over a
``[K, k]`` ASCII matrix; ``k`` is static at trace time so the per-word
compression loop unrolls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_C1 = jnp.uint32(0xCC9E2D51)
_C2 = jnp.uint32(0x1B873593)


def _rotl32(x: jax.Array, r: int) -> jax.Array:
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def murmur3_32_jax(data: jax.Array, seeds: jax.Array) -> jax.Array:
    """ASCII matrix uint8[K, k] x seeds uint32[h] -> int32[K, h].

    Matches ``mmh3.hash``'s signed-int32 result for every row/seed.
    """
    if data.ndim != 2:
        raise ValueError("expected [K, k] uint8 matrix")
    K, k = data.shape
    nblocks = k // 4
    ntail = k % 4
    d32 = data.astype(jnp.uint32)
    h = jnp.broadcast_to(
        seeds.astype(jnp.uint32)[None, :], (K, seeds.shape[0])
    )
    for i in range(nblocks):
        kw = (
            d32[:, 4 * i]
            | (d32[:, 4 * i + 1] << jnp.uint32(8))
            | (d32[:, 4 * i + 2] << jnp.uint32(16))
            | (d32[:, 4 * i + 3] << jnp.uint32(24))
        )[:, None]
        kw = _rotl32(kw * _C1, 15) * _C2
        h = h ^ kw
        h = _rotl32(h, 13)
        h = h * jnp.uint32(5) + jnp.uint32(0xE6546B64)
    if ntail:
        kw = jnp.zeros((K,), dtype=jnp.uint32)
        for j in range(ntail):
            kw = kw | (d32[:, nblocks * 4 + j] << jnp.uint32(8 * j))
        kw = _rotl32(kw[:, None] * _C1, 15) * _C2
        h = h ^ kw
    h = h ^ jnp.uint32(k)
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> jnp.uint32(16))
    return h.astype(jnp.int32)


def canonicalize_jax(kmers: jax.Array) -> jax.Array:
    """Vectorized canonical form on device: uint8[..., k] -> uint8[..., k].

    min(kmer, revcomp(kmer)) in byte-lexicographic order — semantics of
    the reference's ``canonical`` (``bigsi/utils/fncts.py:47-54``) and
    of ``bigsi_tpu.kmers.canonicalize_kmer_matrix`` (the host oracle).
    Non-ACGT bytes map to themselves under complement.

    Gather-free on purpose: table lookups (``comp[kmers]``) and
    take_along_axis lower to per-element XLA gathers, which cost far
    more than the arithmetic on the earlier accelerator (not measured on
    the H100); the complement is a select chain and the lexicographic
    compare a static fold over the k byte positions.
    """
    def complement(b):
        out = b
        for src, dst in zip(b"ACGT", b"TGCA"):
            out = jnp.where(b == jnp.uint8(src), jnp.uint8(dst), out)
        return out

    rc = complement(kmers[..., ::-1])
    k = kmers.shape[-1]
    lt = jnp.zeros(kmers.shape[:-1], dtype=bool)   # rc < kmer so far
    eq = jnp.ones(kmers.shape[:-1], dtype=bool)    # equal prefix so far
    for j in range(k):
        bj = kmers[..., j]
        rj = rc[..., j]
        lt = lt | (eq & (rj < bj))
        eq = eq & (rj == bj)
    return jnp.where(lt[..., None], rc, kmers)


def row_indices_jax(kmers: jax.Array, h: int, m: int) -> jax.Array:
    """Classic-layout bloom rows on device: uint8[K, k] -> int32[K, h].

    Python floor-mod semantics on the signed hash (always in [0, m)),
    matching ``hashing.murmur3.hash_kmer_matrix``.  ``m`` must fit in
    int32 (the reference default m=25e6 does).
    """
    seeds = jnp.arange(h, dtype=jnp.uint32)
    hashes = murmur3_32_jax(kmers, seeds)
    r = hashes % jnp.int32(m)
    return jnp.where(r < 0, r + jnp.int32(m), r)
