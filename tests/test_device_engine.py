"""Device (jnp) engine parity vs the host numpy oracle.

Runs on the CPU backend (8 virtual devices, tests/conftest.py); the
same code path compiles for the GPU.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from bigsi_tpu import BIGSI
from bigsi_tpu.index.device_engine import DeviceEngine, bucket_size
from bigsi_tpu.index.host_engine import HostEngine
from bigsi_tpu.kmers import seq_to_kmers
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix
from bigsi_tpu.storage import get_storage


def random_matrix(rng, m, n):
    blooms = [rng.random(m) < 0.3 for _ in range(n)]
    return BitSliceMatrix.create(blooms, m, n)


# m and h are drawn from small sets: each distinct (m, h) is a fresh
# XLA compilation, and unconstrained draws turn this into a
# recompilation storm (~200s).  n and K vary freely — n only changes
# the (lane-padded) W when crossing 4096 and K is bucketed.
@settings(deadline=None, max_examples=10)
@given(
    st.sampled_from([64, 200]),  # rows m
    st.integers(min_value=1, max_value=300),  # samples n
    st.integers(min_value=1, max_value=40),  # kmers K
    st.sampled_from([1, 3]),  # hashes h
    st.integers(min_value=0, max_value=2 ** 31),
)
def test_engine_parity(m, n, K, h, seed):
    rng = np.random.default_rng(seed)
    mat = random_matrix(rng, m, n)
    host = HostEngine(mat)
    dev = DeviceEngine(mat)
    row_idx = rng.integers(0, m, size=(K, h))

    hp = host.and_rows(row_idx)
    dp = dev.and_rows(row_idx)
    assert np.array_equal(np.asarray(dp.rows[:K]), hp)
    assert np.array_equal(dev.exact_colours(dp), host.exact_colours(hp))
    assert np.array_equal(dev.counts(dp, n), host.counts(hp, n))
    assert np.array_equal(dev.presence_matrix(dp, n), host.presence_matrix(hp, n))


def test_bucket_size():
    assert bucket_size(1) == 64
    assert bucket_size(64) == 64
    assert bucket_size(65) == 128
    assert bucket_size(1000) == 1024


def test_end_to_end_search_with_device_engine():
    cfg = {
        "storage-engine": "memory",
        "storage-config": {"filename": "dev-e2e"},
        "k": 3,
        "m": 1000,
        "h": 3,
        "engine": "device",
    }
    get_storage(cfg).delete_all()
    kmers_1 = seq_to_kmers("ATACACAAT", 3)
    kmers_2 = seq_to_kmers("ATACACAAC", 3)
    bloom1 = BIGSI.bloom(cfg, kmers_1)
    bloom2 = BIGSI.bloom(cfg, kmers_2)
    bigsi = BIGSI.build(cfg, [bloom1, bloom2], ["a", "b"])

    cfg_np = dict(cfg, engine="numpy")
    oracle = BIGSI(cfg_np)
    for seq, t, score in [
        ("ATACACAAT", 1.0, False),
        ("ATACACAAT", 0.5, False),
        ("ATACACAAT", 0.5, True),
        ("ACAGTTAAC", 0.5, False),
    ]:
        assert bigsi.search(seq, t, score) == oracle.search(seq, t, score)
    bigsi.delete()


def test_fat_pack_gather_roundtrip():
    import jax.numpy as jnp

    from bigsi_tpu.index.device_engine import fat_gather, fat_pack

    rng = np.random.default_rng(9)
    for m, w in [(10, 1), (33, 2), (100, 8), (64, 32), (50, 96), (20, 130)]:
        words = rng.integers(0, 2 ** 32, size=(m, w), dtype=np.uint32)
        fat, g = fat_pack(words)
        assert fat.shape[1] % 128 == 0 or w >= 128
        idx = rng.integers(0, m, size=37).astype(np.int32)
        got = np.asarray(fat_gather(jnp.asarray(fat), g, w, jnp.asarray(idx)))
        assert np.array_equal(got, words[idx][:, :w])


@settings(deadline=None, max_examples=8)
@given(
    st.sampled_from([64, 192]),  # rows m (multiple of TILE_ROWS or not)
    st.integers(min_value=1, max_value=300),  # samples n
    st.integers(min_value=1, max_value=40),  # kmers K
    st.sampled_from([1, 3]),  # hashes h
    st.integers(min_value=0, max_value=2 ** 31),
)
def test_blocked_engine_parity(m, n, K, h, seed):
    """Blocked tile path vs host row-gather oracle: for any row_idx
    whose h rows share a 32-row tile, results must be identical."""
    from bigsi_tpu.ops.lookup import TILE_ROWS

    rng = np.random.default_rng(seed)
    mat = random_matrix(rng, m, n)
    host = HostEngine(mat)
    dev = DeviceEngine(mat, layout="blocked")
    tiles = rng.integers(0, m // TILE_ROWS, size=(K, 1))
    slots = rng.integers(0, TILE_ROWS, size=(K, h))
    row_idx = tiles * TILE_ROWS + slots

    hp = host.and_rows(row_idx)
    dp = dev.and_rows(row_idx)
    assert np.array_equal(np.asarray(dp.rows[:K, : mat.num_words]), hp)
    assert np.array_equal(dev.exact_colours(dp), host.exact_colours(hp))
    assert np.array_equal(dev.counts(dp, n), host.counts(hp, n))
    assert np.array_equal(dev.presence_matrix(dp, n), host.presence_matrix(hp, n))


def test_full_query_step_matches_host_pipeline():
    """One-program step (canonicalize+hash+gather+count on device) ==
    host hashing + host engine counts."""
    import numpy as np
    import jax.numpy as jnp

    from bigsi_tpu.hashing.murmur3 import hash_kmer_matrix
    from bigsi_tpu.index.host_engine import HostEngine
    from bigsi_tpu.kmers import canonicalize_kmer_matrix
    from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix
    from bigsi_tpu.ops.lookup import make_full_query_step

    rng = np.random.default_rng(0)
    m, n, h, klen = 4096, 256, 3, 9
    blooms = [rng.random(m) < 0.3 for _ in range(n)]
    mat = BitSliceMatrix.create(blooms, m, n)
    host = HostEngine(mat)

    B, K = 3, 16
    kmers = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(B, K, klen))
    mask = rng.random((B, K)) < 0.9

    step = make_full_query_step(m, h)
    counts = np.asarray(step(jnp.asarray(mat.words), jnp.asarray(kmers), jnp.asarray(mask)))

    for i in range(B):
        canon = canonicalize_kmer_matrix(kmers[i][mask[i]])
        idx = hash_kmer_matrix(canon, h, m)
        want = host.counts(host.and_rows(idx), n)
        assert np.array_equal(counts[i, :n], want), i


def test_csa_counts_matches_unpack_sum():
    import numpy as np
    import jax.numpy as jnp

    from bigsi_tpu.ops.lookup import csa_counts

    rng = np.random.default_rng(3)
    for shape in [(1, 5, 3), (2, 200, 4), (3, 64, 32)]:
        rows = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        got = np.asarray(csa_counts(jnp.asarray(rows), axis=1))
        bits = np.unpackbits(
            rows.view(np.uint8).reshape(*shape[:-1], shape[-1] * 4),
            axis=-1, bitorder="little",
        )
        want = bits.sum(axis=1).astype(np.int32)
        assert np.array_equal(got, want), shape


def test_grouped_counts_matches_blocked():
    """Grouped (tile-deduplicated) path == blocked per-kmer path."""
    import numpy as np
    import jax.numpy as jnp

    from bigsi_tpu.ops.lookup import (
        TILE_ROWS,
        blocked_counts,
        build_grouped_streams,
        grouped_counts,
    )

    rng = np.random.default_rng(5)
    T, W, B, K = 23, 4, 3, 40
    tiles = rng.integers(0, 2 ** 32, size=(T, TILE_ROWS * W), dtype=np.uint32)
    tile = rng.integers(0, T, size=(B, K)).astype(np.int32)
    # minimizer-style runs incl. one run longer than GROUP_R
    tile[:, 1:12] = tile[:, 0:1]
    tile[:, 20:24] = tile[:, 20:21]
    slots = rng.integers(0, TILE_ROWS, size=(B, K, 3)).astype(np.uint32)
    smask = np.bitwise_or.reduce(np.uint32(1) << slots, axis=2)
    pad = rng.random((B, K)) < 0.2
    smask[pad] = 0

    utile, gmask = build_grouped_streams(tile, smask)
    got = np.asarray(grouped_counts(jnp.asarray(tiles), jnp.asarray(utile), jnp.asarray(gmask)))
    want = np.asarray(
        blocked_counts(jnp.asarray(tiles), jnp.asarray(tile), jnp.asarray(smask), jnp.asarray(smask != 0))
    )
    assert np.array_equal(got, want)
