"""Slot-scheme v2 (serving hash scheme) parity and plumbing tests.

v2 redefines the minimizer layout's hashes for serving speed (one
murmur per k-mer, one per window — native/bigsi_native.cpp
prep_minimizer_v2); these tests pin the numpy oracle, the native
implementations, and the persisted-scheme plumbing to each other.
The reference has no analogue (its only scheme is classic h-murmur,
``bigsi/bloom/bloomfilter.py:5-13`` — untouched by v2).
"""

import numpy as np
import pytest

from bigsi_tpu import native
from bigsi_tpu.hashing.scheme import (
    MINIMIZER_SEED,
    SLOT_SCHEME_V1,
    SLOT_SCHEME_V2,
    default_minimizer_s,
    default_slot_scheme,
    minimizer_tiles,
    slot_hashes_v2,
)
from bigsi_tpu.kmers import canonicalize_kmer_matrix, seq_to_ascii
from bigsi_tpu.ops.lookup import build_grouped_streams

RNG = np.random.default_rng(42)


def _sliding_kmers(b, k_per_query, klen):
    seqs = np.frombuffer(b"ACGT", dtype=np.uint8)[
        RNG.integers(0, 4, size=(b, k_per_query + klen - 1))
    ]
    rows = np.concatenate(
        [
            np.lib.stride_tricks.sliding_window_view(q, klen).copy()
            for q in seqs
        ]
    )
    qstart = np.arange(b + 1, dtype=np.int64) * k_per_query
    return rows, qstart


def test_tiles_v2_native_matches_numpy(monkeypatch):
    rows, _ = _sliding_kmers(4, 40, 31)
    s = default_minimizer_s(31)
    fast = native.minimizer_tiles_v2(rows, s, MINIMIZER_SEED, 997)
    assert fast is not None
    monkeypatch.setenv("BIGSI_TPU_NO_NATIVE", "1")
    slow = minimizer_tiles(rows, 997, s, scheme=SLOT_SCHEME_V2)
    assert np.array_equal(fast, slow)


def test_tiles_v2_strand_invariant():
    rows, _ = _sliding_kmers(2, 16, 31)
    comp = np.arange(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    rc = comp[rows[:, ::-1]]
    s = default_minimizer_s(31)
    t_f = minimizer_tiles(rows, 1009, s, scheme=SLOT_SCHEME_V2)
    t_r = minimizer_tiles(np.ascontiguousarray(rc), 1009, s, scheme=SLOT_SCHEME_V2)
    assert np.array_equal(t_f, t_r)


def test_tiles_v2_differs_from_v1():
    # different window-order hash -> (almost surely) different tiles
    rows, _ = _sliding_kmers(1, 64, 31)
    s = default_minimizer_s(31)
    t1 = minimizer_tiles(rows, 10**6, s, scheme=SLOT_SCHEME_V1)
    t2 = minimizer_tiles(rows, 10**6, s, scheme=SLOT_SCHEME_V2)
    assert not np.array_equal(t1, t2)


def test_slot_hashes_v2_fields():
    kmers = np.stack([seq_to_ascii("A" * 31), seq_to_ascii("ACGT" * 7 + "AAA")])
    from bigsi_tpu.hashing.murmur3 import murmur3_32

    slots = slot_hashes_v2(kmers, 3, 16)
    for i in range(2):
        hv = murmur3_32(bytes(kmers[i]), 0) & 0xFFFFFFFF
        expect = [(hv >> (6 * j)) % 16 for j in range(3)]
        assert list(slots[i]) == expect


def test_slot_hashes_v2_rejects_h6():
    with pytest.raises(ValueError):
        slot_hashes_v2(np.zeros((1, 31), dtype=np.uint8), 6, 16)


def test_fused_prep_matches_oracle(monkeypatch):
    rows, qstart = _sliding_kmers(8, 48, 31)
    s = default_minimizer_s(31)
    h, tr, r, t = 3, 16, 6, 5003
    out = native.prep_minimizer_v2(rows, qstart, s, MINIMIZER_SEED, t, h, tr, r)
    assert out is not None
    utile, gmask, n_valid = out
    # oracle: v2 tiles + v2 slots on canonical kmers -> grouped streams
    monkeypatch.setenv("BIGSI_TPU_NO_NATIVE", "1")
    tile = minimizer_tiles(rows, t, s, scheme=SLOT_SCHEME_V2)
    canon = canonicalize_kmer_matrix(rows.copy())
    slots = slot_hashes_v2(canon, h, tr).astype(np.uint32)
    smask = np.bitwise_or.reduce(np.uint32(1) << slots, axis=1)
    b, kq = 8, 48
    ut_o, gm_o = build_grouped_streams(
        tile.reshape(b, kq).astype(np.int32), smask.reshape(b, kq), r=r
    )
    u = utile.shape[1]
    assert np.array_equal(utile, ut_o[:, :u])
    assert (ut_o[:, u:] == 0).all()
    assert np.array_equal(gmask, gm_o[:, :u])
    assert (n_valid == kq).all()


def test_fused_prep_non_overlapping_rows():
    # arbitrary (non-sliding) k-mer rows must still be correct — overlap
    # only accelerates the rolling path, never changes results
    rows = np.frombuffer(b"ACGT", dtype=np.uint8)[
        RNG.integers(0, 4, size=(40, 31))
    ].copy()
    qstart = np.asarray([0, 25, 40], dtype=np.int64)
    s = default_minimizer_s(31)
    out = native.prep_minimizer_v2(rows, qstart, s, MINIMIZER_SEED, 211, 3, 16, 6)
    assert out is not None
    utile, gmask, n_valid = out
    tile_a = native.minimizer_tiles_v2(rows, s, MINIMIZER_SEED, 211)
    # single-row calls give the same tiles (no rolling state leak)
    for i in (0, 7, 24, 25, 39):
        assert (
            native.minimizer_tiles_v2(rows[i : i + 1], s, MINIMIZER_SEED, 211)[0]
            == tile_a[i]
        )
    assert list(n_valid) == [25, 15]
    # entries reconstruct the per-kmer tile sequence
    canon = canonicalize_kmer_matrix(rows.copy())
    smask = np.bitwise_or.reduce(
        np.uint32(1) << slot_hashes_v2(canon, 3, 16).astype(np.uint32), axis=1
    )
    for q, (r0, r1) in enumerate(zip(qstart[:-1], qstart[1:])):
        got_tiles, got_masks = [], []
        for e in range(utile.shape[1]):
            for j in range(6):
                if gmask[q, e, j]:
                    got_tiles.append(utile[q, e])
                    got_masks.append(gmask[q, e, j])
        assert got_tiles == list(tile_a[r0:r1])
        assert got_masks == list(smask[r0:r1])


def test_fused_prep_ragged_random_batches(monkeypatch):
    """Property-style: random ragged query lengths (incl. empty) and a
    mix of sliding-window and shuffled rows must match the oracle."""
    s = default_minimizer_s(31)
    h, tr, r, t = 3, 16, 6, 1021
    for trial in range(5):
        rng = np.random.default_rng(100 + trial)
        lens = rng.integers(0, 40, size=7)
        mats = []
        for n in lens:
            if n and rng.random() < 0.5:
                seq = np.frombuffer(b"ACGT", dtype=np.uint8)[
                    rng.integers(0, 4, n + 30)
                ]
                mats.append(
                    np.lib.stride_tricks.sliding_window_view(seq, 31).copy()
                )
            else:
                mats.append(
                    np.frombuffer(b"ACGT", dtype=np.uint8)[
                        rng.integers(0, 4, size=(n, 31))
                    ].copy()
                )
        rows = (
            np.concatenate(mats)
            if sum(lens)
            else np.empty((0, 31), dtype=np.uint8)
        )
        qstart = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=qstart[1:])
        out = native.prep_minimizer_v2(
            rows, qstart, s, MINIMIZER_SEED, t, h, tr, r
        )
        assert out is not None
        utile, gmask, n_valid = out
        assert list(n_valid) == list(lens)
        monkeypatch.setenv("BIGSI_TPU_NO_NATIVE", "1")
        tile = (
            minimizer_tiles(rows, t, s, scheme=SLOT_SCHEME_V2)
            if len(rows)
            else np.empty(0, dtype=np.int64)
        )
        monkeypatch.delenv("BIGSI_TPU_NO_NATIVE")
        canon = canonicalize_kmer_matrix(rows.copy())
        smask = (
            np.bitwise_or.reduce(
                np.uint32(1)
                << slot_hashes_v2(canon, h, tr).astype(np.uint32),
                axis=1,
            )
            if len(rows)
            else np.empty(0, dtype=np.uint32)
        )
        for q, (r0, r1) in enumerate(zip(qstart[:-1], qstart[1:])):
            got = [
                (int(utile[q, e]), int(gmask[q, e, j]))
                for e in range(utile.shape[1])
                for j in range(r)
                if gmask[q, e, j]
            ]
            want = list(
                zip(
                    (int(x) for x in tile[r0:r1]),
                    (int(x) for x in smask[r0:r1]),
                )
            )
            assert got == want, "query %d trial %d" % (q, trial)


def test_fused_prep_rejects_bad_params():
    rows, qstart = _sliding_kmers(2, 8, 31)
    assert (
        native.prep_minimizer_v2(rows, qstart, 21, MINIMIZER_SEED, 97, 6, 16, 6)
        is None
    )  # h=6 > 5
    assert (
        native.prep_minimizer_v2(rows, qstart, 0, MINIMIZER_SEED, 97, 3, 16, 6)
        is None
    )  # s < 1


def test_default_slot_scheme():
    from bigsi_tpu.hashing.scheme import SLOT_SCHEME_V3

    assert default_slot_scheme("classic") == SLOT_SCHEME_V1
    assert default_slot_scheme("blocked") == SLOT_SCHEME_V1
    assert default_slot_scheme("minimizer") == SLOT_SCHEME_V3
    assert default_slot_scheme("minimizer", {"slot-scheme": 1}) == SLOT_SCHEME_V1
    assert default_slot_scheme("minimizer", {"slot-scheme": 2}) == SLOT_SCHEME_V2


def test_config_validates_slot_scheme():
    from bigsi_tpu.config import validate_config

    base = {"k": 31, "m": 1000, "h": 3, "layout": "minimizer"}
    validate_config(dict(base, **{"slot-scheme": 2}))
    validate_config(dict(base, **{"slot-scheme": 3}))
    with pytest.raises(ValueError):
        validate_config(dict(base, **{"slot-scheme": 4}))
    with pytest.raises(ValueError):
        validate_config({"k": 31, "m": 1000, "h": 3, "slot-scheme": 2})
    with pytest.raises(ValueError):
        validate_config(dict(base, h=6, **{"slot-scheme": 2}))
    with pytest.raises(ValueError):
        validate_config(dict(base, h=11, **{"slot-scheme": 3}))
    validate_config(dict(base, h=6, **{"slot-scheme": 3}))


def test_fused_serving_path_is_active_and_exact(tmp_path):
    """DeviceEngine actually takes counts_batch_kmers for v2 minimizer
    indexes, and its results match the host oracle exactly."""
    from bigsi_tpu.graph.bigsi import BIGSI

    config = {
        "k": 31, "m": 65536, "h": 3, "layout": "minimizer", "tile-rows": 16,
        "storage-engine": "rocksdb",
        "storage-config": {"filename": str(tmp_path / "idx")},
    }
    rng = np.random.default_rng(3)
    seqs = [
        "".join("ACGT"[c] for c in rng.integers(0, 4, 150)) for _ in range(6)
    ]
    blooms = [
        BIGSI.bloom(config, [s[i : i + 31] for i in range(len(s) - 30)])
        for s in seqs
    ]
    host = BIGSI.build(config, blooms, ["s%d" % i for i in range(6)])
    queries = [s[10:100] for s in seqs] + [seqs[0][5:40]]
    expect = host.search_batch(queries, threshold=0.6)

    dev = BIGSI(dict(config, engine="device"))
    assert dev.engine.supports_kmer_batch()
    # round 4 added the all-on-device seq path, which supersedes the
    # fused host prep when available — disable it here so this test
    # keeps pinning the HOST-prep fused path (the fallback for
    # non-ACGT/overflow batches and v2 indexes)
    dev.engine.supports_seq_batch = lambda: False
    calls = []
    orig = dev.engine.counts_batch_kmers

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    dev.engine.counts_batch_kmers = spy
    assert dev.search_batch(queries, threshold=0.6) == expect
    assert calls


def test_legacy_index_reopens_as_v1(tmp_path):
    """Indexes persisted without ksi:slot_scheme keep querying with v1."""
    from bigsi_tpu.graph.bigsi import BIGSI
    from bigsi_tpu.index.signature import SLOT_SCHEME_KEY

    config = {
        "k": 31, "m": 4096, "h": 3, "layout": "minimizer", "tile-rows": 16,
        "slot-scheme": 1,
        "storage-engine": "rocksdb",
        "storage-config": {"filename": str(tmp_path / "idx")},
    }
    seq = "".join("ACGT"[i % 4] for i in range(80))
    kmers = [seq[i : i + 31] for i in range(len(seq) - 30)]
    b = BIGSI.build(config, [BIGSI.bloom(config, kmers)], ["s1"])
    assert b.slot_scheme == 1
    hits = b.search(seq, 1.0)
    assert hits and hits[0]["sample_name"] == "s1"
    # simulate a legacy manifest: drop the persisted key, reopen
    del b.storage.kv._data[SLOT_SCHEME_KEY + ":int"]
    b.storage.kv.dirty = True
    b.storage.sync()
    del config["slot-scheme"]
    b2 = BIGSI(config)
    assert b2.slot_scheme == 1
    assert b2.search(seq, 1.0) == hits
