"""Slot-scheme v3 (rolling 2-bit codes + splitmix64 — the serving
default for new minimizer builds): numpy-oracle/native parity, strand
invariance, and end-to-end plumbing."""

import numpy as np
import pytest

from bigsi_tpu import native
from bigsi_tpu.hashing.scheme import (
    MINIMIZER_SEED,
    SLOT_SCHEME_V2,
    SLOT_SCHEME_V3,
    default_minimizer_s,
    minimizer_tiles,
    pack_codes_v3,
    slot_hashes_v3,
    splitmix64,
)
from bigsi_tpu.kmers import seq_to_ascii
from bigsi_tpu.ops.lookup import build_grouped_streams

RNG = np.random.default_rng(77)


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
    return rows, np.arange(b + 1, dtype=np.int64) * k_per_query


def test_pack_codes_roundtrip():
    kmers = np.stack([seq_to_ascii("ACGT"), seq_to_ascii("TTTT")])
    fwd, rc = pack_codes_v3(kmers)
    # ACGT: 00 01 10 11 MSB-first = 0x1B; its revcomp is itself
    assert fwd[0] == 0x1B and rc[0] == 0x1B
    # TTTT fwd = 0xFF; revcomp AAAA = 0
    assert fwd[1] == 0xFF and rc[1] == 0


def test_splitmix64_reference_vector():
    # seed 1234567 -> first splitmix64 output (Steele et al. reference)
    assert splitmix64(np.uint64(1234567))[()] == np.uint64(
        6457827717110365317
    )


def test_tiles_v3_native_matches_numpy(monkeypatch):
    rows, _ = _sliding_kmers(4, 40, 31)
    s = default_minimizer_s(31)
    fast = native.minimizer_tiles_v3(rows, s, MINIMIZER_SEED, 997)
    assert fast is not None
    monkeypatch.setenv("BIGSI_TPU_NO_NATIVE", "1")
    slow = minimizer_tiles(rows, 997, s, scheme=SLOT_SCHEME_V3)
    assert np.array_equal(fast, slow)


def test_v3_strand_invariant():
    rows, _ = _sliding_kmers(2, 16, 31)
    comp = np.arange(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    rc = np.ascontiguousarray(comp[rows[:, ::-1]])
    s = default_minimizer_s(31)
    assert np.array_equal(
        minimizer_tiles(rows, 1009, s, scheme=SLOT_SCHEME_V3),
        minimizer_tiles(rc, 1009, s, scheme=SLOT_SCHEME_V3),
    )
    assert np.array_equal(slot_hashes_v3(rows, 3, 16), slot_hashes_v3(rc, 3, 16))


def test_fused_prep_v3_matches_oracle(monkeypatch):
    rows, qstart = _sliding_kmers(8, 48, 31)
    for window, r in ((11, 6), (19, 20)):
        s = 31 - window + 1
        out = native.prep_minimizer_v3(
            rows, qstart, s, MINIMIZER_SEED, 5003, 3, 16, r
        )
        assert out is not None
        utile, gmask, n_valid = out
        monkeypatch.setenv("BIGSI_TPU_NO_NATIVE", "1")
        tile = minimizer_tiles(rows, 5003, s, scheme=SLOT_SCHEME_V3)
        monkeypatch.delenv("BIGSI_TPU_NO_NATIVE")
        smask = np.bitwise_or.reduce(
            np.uint32(1) << slot_hashes_v3(rows, 3, 16).astype(np.uint32),
            axis=1,
        )
        ut_o, gm_o = build_grouped_streams(
            tile.reshape(8, 48).astype(np.int32), smask.reshape(8, 48), r=r
        )
        u = utile.shape[1]
        assert np.array_equal(utile, ut_o[:, :u])
        assert (ut_o[:, u:] == 0).all()
        assert np.array_equal(gmask, gm_o[:, :u])
        assert (n_valid == 48).all()


def test_v3_non_acgt_deterministic():
    # non-ACGT bytes map to code 0 on BOTH native and oracle sides
    rows = np.stack(
        [seq_to_ascii("ACGTNACGTNACGTNACGTNACGTNACGTNA")] * 2
    )
    s = default_minimizer_s(31)
    fast = native.minimizer_tiles_v3(rows, s, MINIMIZER_SEED, 97)
    import os

    os.environ["BIGSI_TPU_NO_NATIVE"] = "1"
    try:
        slow = minimizer_tiles(rows, 97, s, scheme=SLOT_SCHEME_V3)
    finally:
        del os.environ["BIGSI_TPU_NO_NATIVE"]
    assert np.array_equal(fast, slow)
    assert fast[0] == fast[1]


def test_v3_non_acgt_raw_vs_canonical_parity():
    # Regression (round-3 advisor, high): rc codes must use BYTE-revcomp
    # semantics (complement only ACGT, non-ACGT stays code 0).  The old
    # 3-code complement mapped N -> 3 ('T'-like) in rc only, so raw
    # (query-side) and byte-canonicalized (build-side) forms of
    # N-containing k-mers disagreed on min(fwd, rc) — different
    # tiles/slots at build vs query, silent false negatives.
    from bigsi_tpu.kmers import canonicalize_kmer_matrix, seq_to_kmer_matrix

    seq = "TTTTTNTTTTTACGTNACGTAGCTAGNCTAnACG"
    raw = seq_to_kmer_matrix(seq, 11)
    canon = canonicalize_kmer_matrix(raw)
    fr, rr = pack_codes_v3(raw)
    fc, rcn = pack_codes_v3(canon)
    assert np.array_equal(np.minimum(fr, rr), np.minimum(fc, rcn))
    assert np.array_equal(
        slot_hashes_v3(raw, 3, 16), slot_hashes_v3(canon, 3, 16)
    )
    s = default_minimizer_s(11)
    for scheme_id in (SLOT_SCHEME_V3,):
        t_raw = minimizer_tiles(raw, 997, s, scheme=scheme_id)
        t_canon = minimizer_tiles(canon, 997, s, scheme=scheme_id)
        assert np.array_equal(t_raw, t_canon)
    # native fused prep on the raw form agrees with the numpy oracle on
    # the canonical form (the exact build-vs-fused-serve split)
    qstart = np.asarray([0, raw.shape[0]], dtype=np.int64)
    out = native.prep_minimizer_v3(raw, qstart, s, MINIMIZER_SEED, 997, 3, 16, 6)
    assert out is not None
    utile, gmask, _ = out
    import os

    os.environ["BIGSI_TPU_NO_NATIVE"] = "1"
    try:
        tile = minimizer_tiles(canon, 997, s, scheme=SLOT_SCHEME_V3)
    finally:
        del os.environ["BIGSI_TPU_NO_NATIVE"]
    smask = np.bitwise_or.reduce(
        np.uint32(1) << slot_hashes_v3(canon, 3, 16).astype(np.uint32), axis=1
    )
    ut_o, gm_o = build_grouped_streams(
        tile.reshape(1, -1).astype(np.int32), smask.reshape(1, -1), r=6
    )
    u = utile.shape[1]
    assert np.array_equal(utile, ut_o[:, :u])
    assert np.array_equal(gmask, gm_o[:, :u])


def test_v3_end_to_end_with_n_bases(tmp_path):
    # Build an index from sequences containing N; query with the raw
    # (N-containing) sequence through BOTH engines — the k-mers must be
    # found (the round-3 defect silently dropped them at query time).
    from bigsi_tpu.graph.bigsi import BIGSI

    config = {
        "k": 31, "m": 65536, "h": 3, "layout": "minimizer", "tile-rows": 16,
        "storage-engine": "rocksdb",
        "storage-config": {"filename": str(tmp_path / "idx")},
    }
    rng = np.random.default_rng(9)
    base = "".join("ACGT"[c] for c in rng.integers(0, 4, 150))
    seq_n = base[:60] + "N" + base[61:]  # one N mid-sequence
    blooms = [
        BIGSI.bloom(config, [s[i : i + 31] for i in range(len(s) - 30)])
        for s in (seq_n, base)
    ]
    host = BIGSI.build(config, blooms, ["with_n", "plain"])
    query = seq_n[40:90]  # every k-mer overlaps the N
    res = host.search(query, 1.0)
    assert {r["sample_name"] for r in res} >= {"with_n"}
    dev = BIGSI(dict(config, engine="device"))
    assert dev.search(query, 1.0) == res
    assert dev.search_batch([query], threshold=1.0) == host.search_batch(
        [query], threshold=1.0
    )


def test_v3_differs_from_v2():
    rows, _ = _sliding_kmers(1, 64, 31)
    s = default_minimizer_s(31)
    t2 = minimizer_tiles(rows, 10**6, s, scheme=SLOT_SCHEME_V2)
    t3 = minimizer_tiles(rows, 10**6, s, scheme=SLOT_SCHEME_V3)
    assert not np.array_equal(t2, t3)


def test_v3_end_to_end_and_engine_parity(tmp_path):
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
    assert host.slot_scheme == SLOT_SCHEME_V3  # the new default
    queries = [s[10:100] for s in seqs] + [seqs[0][5:40]]
    expect = host.search_batch(queries, threshold=0.6)
    dev = BIGSI(dict(config, engine="device"))
    assert dev.engine.supports_kmer_batch()
    assert dev.search_batch(queries, threshold=0.6) == expect
    assert [dev.search(q, 1.0) for q in queries] == [
        host.search(q, 1.0) for q in queries
    ]
