"""Two-stage verified search (minimizer screen + classic verification).

The done-criterion from round 3: a screened index must return result
dicts IDENTICAL to a pure classic-layout index on a near-miss-heavy
dataset at t in {0.7, 1.0} — through both engines — while the screen
dispatch is the measured fast path.  Reference semantics being matched:
``bigsi/graph/bigsi.py:211-230`` (inexact counts), ``:192-205`` (exact).
"""

import numpy as np
import pytest

from bigsi_tpu import BIGSI
from bigsi_tpu.kmers import seq_to_kmers

BASES = "ACGT"


def _dataset(rng, n=6, length=400):
    """Indexed genomes + 1-SNP mutants of each (near-miss-heavy)."""
    genomes = [
        "".join(BASES[i] for i in rng.integers(0, 4, length))
        for _ in range(n)
    ]
    muts = []
    for g in genomes:
        p = int(rng.integers(50, length - 50))
        muts.append(g[:p] + BASES[(BASES.index(g[p]) + 1) % 4] + g[p + 1 :])
    return genomes + muts


def _build_pair(tmp_path, seqs, names, m=200000, **extra):
    classic_cfg = {
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": str(tmp_path / "classic")},
        "k": 31, "m": m, "h": 3,
    }
    ver_cfg = {
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": str(tmp_path / "verified")},
        "k": 31, "m": m, "h": 3, "screen": "minimizer", **extra,
    }
    cl = BIGSI.build(
        classic_cfg,
        [BIGSI.bloom(classic_cfg, seq_to_kmers(s, 31)) for s in seqs],
        names,
    )
    vr = BIGSI.build(
        ver_cfg,
        [BIGSI.bloom(ver_cfg, seq_to_kmers(s, 31)) for s in seqs],
        names,
    )
    return cl, vr, classic_cfg, ver_cfg


def test_verified_identical_to_classic_all_engines(tmp_path):
    rng = np.random.default_rng(42)
    seqs = _dataset(rng)
    names = ["g%d" % i for i in range(6)] + ["m%d" % i for i in range(6)]
    cl, vr, classic_cfg, ver_cfg = _build_pair(tmp_path, seqs, names)
    assert vr.screen == {
        "m": 200000, "tile_rows": 16, "window": 19,
        "slot_scheme": 3, "run_len": 20,
    }
    queries = [s[40:260] for s in seqs[:6]] + [s[100:300] for s in seqs[6:]]
    vr_dev = BIGSI(dict(ver_cfg, engine="device"))
    assert type(vr_dev.screen_engine).__name__ == "DeviceEngine"
    assert vr_dev.screen_engine.supports_kmer_batch()  # fused screen
    for t in (1.0, 0.7, 0.5):
        expect_single = [cl.search(q, t) for q in queries]
        expect_batch = cl.search_batch(queries, threshold=t)
        assert [vr.search(q, t) for q in queries] == expect_single
        assert vr.search_batch(queries, threshold=t) == expect_batch
        assert [vr_dev.search(q, t) for q in queries] == expect_single
        assert vr_dev.search_batch(queries, threshold=t) == expect_batch


def test_verified_score_path_identical(tmp_path):
    rng = np.random.default_rng(7)
    seqs = _dataset(rng, n=3)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, vr, _, _ = _build_pair(tmp_path, seqs, names)
    q = seqs[0][40:260]
    assert vr.search(q, 0.7, score=True) == cl.search(q, 0.7, score=True)
    assert vr.search_batch([q, seqs[1][30:200]], 0.7, score=True) == \
        cl.search_batch([q, seqs[1][30:200]], 0.7, score=True)


def test_verified_reopen_insert_compact(tmp_path):
    rng = np.random.default_rng(13)
    seqs = _dataset(rng, n=3)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, vr, classic_cfg, ver_cfg = _build_pair(tmp_path, seqs, names)
    # fresh handle reads the persisted screen params + screen.bin
    vr2 = BIGSI(ver_cfg)
    assert vr2.screen == vr.screen
    assert vr2.screen_matrix is not None
    newbie = "".join(BASES[i] for i in rng.integers(0, 4, 200))
    vr2.insert(BIGSI.bloom(ver_cfg, seq_to_kmers(newbie, 31)), "newbie")
    cl.insert(BIGSI.bloom(classic_cfg, seq_to_kmers(newbie, 31)), "newbie")
    q = newbie[30:150]
    assert vr2.search(q, 0.7) == cl.search(q, 0.7)
    assert vr2.search_batch([q], threshold=0.7) == cl.search_batch(
        [q], threshold=0.7
    )
    vr2.compact()
    cl.compact()
    # post-compact the screen gained the new colour (regression: a
    # compacted-in colour with no screen bits would silently vanish)
    res = vr2.search(q, 0.7)
    assert res == cl.search(q, 0.7)
    assert any(r["sample_name"] == "newbie" for r in res)


def test_verified_merge(tmp_path):
    rng = np.random.default_rng(21)
    seqs = _dataset(rng, n=2)
    cfg = lambda name: {
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": str(tmp_path / name)},
        "k": 31, "m": 100000, "h": 3, "screen": "minimizer",
    }
    c1, c2 = cfg("a"), cfg("b")
    b1 = BIGSI.build(
        c1, [BIGSI.bloom(c1, seq_to_kmers(seqs[0], 31))], ["a0"]
    )
    b2 = BIGSI.build(
        c2, [BIGSI.bloom(c2, seq_to_kmers(seqs[1], 31))], ["b0"]
    )
    b1.merge(b2)
    merged = BIGSI(c1)
    q1, q2 = seqs[0][40:200], seqs[1][40:200]
    assert {r["sample_name"] for r in merged.search(q1, 1.0)} == {"a0"}
    assert {r["sample_name"] for r in merged.search(q2, 1.0)} == {"b0"}
    # screened/unscreened mixes refuse to merge
    c3 = {k: v for k, v in cfg("c").items() if k != "screen"}
    b3 = BIGSI.build(
        c3, [BIGSI.bloom(c3, seq_to_kmers(seqs[0], 31))], ["c0"]
    )
    with pytest.raises(ValueError, match="verified"):
        merged.merge(b3)


def test_classic_counts_for_colours_native_matches_numpy():
    import os

    from bigsi_tpu.index.verify import (
        _and_count_words_numpy,
        classic_counts_for_colours,
        verify_queries,
    )

    rng = np.random.default_rng(5)
    m, w, K, h = 4096, 7, 200, 3
    words = rng.integers(0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(
        np.uint32
    )
    idx = rng.integers(0, m, size=(K, h), dtype=np.int64)
    colours = np.unique(rng.integers(0, w * 32, size=40)).astype(np.int64)
    got = classic_counts_for_colours(words, idx, colours)
    os.environ["BIGSI_TPU_NO_NATIVE"] = "1"
    try:
        want = classic_counts_for_colours(words, idx, colours)
    finally:
        del os.environ["BIGSI_TPU_NO_NATIVE"]
    assert np.array_equal(got, want)
    # full-width cross-check against the host engine
    from bigsi_tpu.index.host_engine import HostEngine
    from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix

    eng = HostEngine(BitSliceMatrix(words, num_cols=w * 32))
    full = eng.counts(eng.and_rows(idx), w * 32)
    assert np.array_equal(got, full[colours])
    # batched threaded verify agrees per query
    idx2 = rng.integers(0, m, size=(150, h), dtype=np.int64)
    col2 = np.unique(rng.integers(0, w * 32, size=10)).astype(np.int64)
    got_b = verify_queries(words, [idx, None, idx2], [colours, None, col2])
    assert np.array_equal(got_b[0], got)
    assert got_b[1].size == 0
    assert np.array_equal(got_b[2], full_counts(eng, idx2)[col2])


def full_counts(eng, idx):
    return eng.counts(eng.and_rows(idx), eng.matrix.num_cols)


def test_screen_margin_policy():
    from bigsi_tpu.index.verify import screen_margin

    assert screen_margin(512) == 41  # ceil(0.08 * 512)
    assert screen_margin(10) == 8  # absolute floor
    assert screen_margin(512, 0) == 0  # config override
    assert screen_margin(512, 100) == 100


def test_screen_config_validation():
    from bigsi_tpu.config import validate_config

    base = {"k": 31, "m": 1000, "h": 3}
    validate_config(dict(base, screen="minimizer"))
    validate_config(
        dict(base, screen="minimizer", **{
            "screen-m": 500, "screen-tile-rows": 16, "screen-window": 15,
            "verify-margin": 0,
        })
    )
    with pytest.raises(ValueError, match="screen"):
        validate_config(dict(base, screen="blocked"))
    with pytest.raises(ValueError, match="layout=classic"):
        validate_config(dict(base, screen="minimizer", layout="minimizer"))
    with pytest.raises(ValueError, match="screen-m"):
        validate_config(dict(base, screen="minimizer", **{"screen-m": -1}))
    with pytest.raises(ValueError, match="needs 'screen"):
        validate_config(dict(base, **{"screen-window": 15}))
    with pytest.raises(ValueError, match="verify-margin"):
        validate_config(
            dict(base, screen="minimizer", **{"verify-margin": -2})
        )


def test_verified_small_screen_m(tmp_path):
    """The screen may be SMALLER than m: its FPR only inflates the
    candidate set (verify work), never the results."""
    rng = np.random.default_rng(31)
    seqs = _dataset(rng, n=4)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, vr, _, ver_cfg = _build_pair(
        tmp_path, seqs, names, **{"screen-m": 50000}
    )
    assert vr.screen["m"] == 50000
    queries = [s[40:260] for s in seqs]
    for t in (1.0, 0.7):
        assert [vr.search(q, t) for q in queries] == [
            cl.search(q, t) for q in queries
        ]
        assert vr.search_batch(queries, threshold=t) == cl.search_batch(
            queries, threshold=t
        )


def test_verified_index_over_http(tmp_path):
    """HTTP serving of a verified index: /search returns the classic
    result dicts (screen+verify behind the batcher)."""
    import json
    import threading
    import urllib.request

    import numpy as np

    from bigsi_tpu.graph.bigsi import BIGSI
    from bigsi_tpu.http.server import make_server
    from bigsi_tpu.kmers import seq_to_kmers

    rng = np.random.default_rng(4)
    genomes = [
        "".join("ACGT"[c] for c in rng.integers(0, 4, 500)) for _ in range(4)
    ]
    cfg = {
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": str(tmp_path / "vidx")},
        "k": 31, "m": 1 << 18, "h": 3, "screen": "minimizer",
    }
    blooms = [BIGSI.bloom(cfg, seq_to_kmers(g, 31)) for g in genomes]
    BIGSI.build(cfg, blooms, ["s%d" % i for i in range(4)])
    ccfg = {
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": str(tmp_path / "cidx")},
        "k": 31, "m": 1 << 18, "h": 3,
    }
    cblooms = [BIGSI.bloom(ccfg, seq_to_kmers(g, 31)) for g in genomes]
    oracle = BIGSI.build(ccfg, cblooms, ["s%d" % i for i in range(4)])

    server = make_server(cfg, host="127.0.0.1", port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        q = genomes[2][40:300]
        url = "http://127.0.0.1:%d/search?seq=%s&threshold=0.7" % (port, q)
        with urllib.request.urlopen(url) as resp:
            d = json.loads(resp.read())
        want = oracle.search(q, threshold=0.7)
        assert d["results"] == want
    finally:
        server.shutdown()


def test_device_verifier_engaged_and_identical(tmp_path, monkeypatch):
    """With engine=device the verify pass runs on the device
    (DeviceVerifier over the device-staged classic matrix) and the
    result dicts stay identical to a pure classic index."""
    rng = np.random.default_rng(91)
    seqs = _dataset(rng)
    names = ["g%d" % i for i in range(6)] + ["m%d" % i for i in range(6)]
    cl, vr, classic_cfg, ver_cfg = _build_pair(tmp_path, seqs, names)
    vr_dev = BIGSI(dict(ver_cfg, engine="device"))
    assert vr_dev.verifier is not None, "auto verify-device did not engage"
    calls = {"n": 0}
    orig = vr_dev.verifier.counts_async

    def spy(idx_list, cand_list):
        calls["n"] += 1
        return orig(idx_list, cand_list)

    monkeypatch.setattr(vr_dev.verifier, "counts_async", spy)
    queries = [s[40:260] for s in seqs]
    for t in (1.0, 0.7, 0.5):
        assert vr_dev.search_batch(queries, threshold=t) == \
            cl.search_batch(queries, threshold=t)
        assert [vr_dev.search(q, t) for q in queries] == \
            [cl.search(q, t) for q in queries]
    assert calls["n"] > 0, "device verifier never used"
    # explicit opt-out falls back to the host pass
    vr_off = BIGSI(dict(ver_cfg, engine="device", **{"verify-device": False}))
    assert vr_off.verifier is None
    assert vr_off.search_batch(queries, threshold=0.7) == \
        cl.search_batch(queries, threshold=0.7)


def test_device_verifier_refreshes_on_compact(tmp_path):
    """Insert + compact swaps the classic matrix; a stale HBM copy
    would silently drop the new colour from verification."""
    rng = np.random.default_rng(17)
    seqs = _dataset(rng, n=3)
    names = ["s%d" % i for i in range(len(seqs))]
    cl, vr, classic_cfg, ver_cfg = _build_pair(tmp_path, seqs, names)
    vd = BIGSI(dict(ver_cfg, engine="device"))
    assert vd.verifier is not None
    old_matrix = vd.verifier.matrix
    newbie = "".join(BASES[i] for i in rng.integers(0, 4, 200))
    vd.insert(BIGSI.bloom(ver_cfg, seq_to_kmers(newbie, 31)), "newbie")
    cl.insert(BIGSI.bloom(classic_cfg, seq_to_kmers(newbie, 31)), "newbie")
    q = newbie[30:150]
    assert vd.search(q, 0.7) == cl.search(q, 0.7)  # side-shard path
    vd.compact()
    cl.compact()
    assert vd.verifier.matrix is not old_matrix
    res = vd.search(q, 0.7)
    assert res == cl.search(q, 0.7)
    assert any(r["sample_name"] == "newbie" for r in res)


def test_split_fraction_adapts_both_directions(tmp_path):
    """split_verify_queries must grow the device share when the device
    side is fast, decay to host-only when it is slow, and re-probe
    periodically after decaying."""
    import time

    import bigsi_tpu.index.verify as vf

    rng = np.random.default_rng(3)
    m, w = 50000, 4
    words = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint32)
    # big enough that the host pass takes a few ms — at sub-ms batch
    # scale, scheduler noise reads as device straggle
    b, k, h = 64, 512, 3
    idx_list = [
        rng.integers(0, m, size=(k, h)).astype(np.int64) for _ in range(b)
    ]
    cand_list = [
        np.unique(rng.integers(0, w * 32, size=4)).astype(np.int64)
        for _ in range(b)
    ]
    want = vf.verify_queries(words, idx_list, cand_list)

    class FakeVerifier:
        """Oracle-correct device stand-in with a tunable delay."""

        def __init__(self, delay):
            self.delay = delay

        def counts_async(self, ridx, cands):
            out = vf.verify_queries(words, ridx, cands)

            def resolve():
                time.sleep(self.delay)
                return out

            return resolve

    fast = FakeVerifier(0.0)
    for _ in range(6):
        got = vf.split_verify_queries(words, idx_list, cand_list, fast)
    assert all(np.array_equal(a, bb) for a, bb in zip(got, want))
    assert fast.split_fraction > 0.4  # fast device earns more share

    slow = FakeVerifier(0.05)
    for _ in range(8):
        got = vf.split_verify_queries(words, idx_list, cand_list, slow)
    assert all(np.array_equal(a, bb) for a, bb in zip(got, want))
    assert slow.split_fraction == 0.0  # slow device decays to host-only
    # decayed: host-only calls never touch the device...
    calls_before = slow._split_calls
    dispatches = {"n": 0}
    orig = slow.counts_async

    def spy(ridx, cands):
        dispatches["n"] += 1
        return orig(ridx, cands)

    slow.counts_async = spy
    for _ in range(31 - (calls_before % 32) if calls_before % 32 else 0):
        vf.split_verify_queries(words, idx_list, cand_list, slow)
    assert dispatches["n"] == 0
    # ...except the periodic re-probe draw (every 32nd call)
    vf.split_verify_queries(words, idx_list, cand_list, slow)
    assert dispatches["n"] == 1


def test_device_verifier_unit_parity_random_shapes():
    """DeviceVerifier.counts must equal verify_queries on random
    shapes, including empty-candidate and None entries."""
    from bigsi_tpu.index.device_engine import DeviceVerifier
    from bigsi_tpu.index.verify import verify_queries
    from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix

    rng = np.random.default_rng(8)
    for trial in range(3):
        m = int(rng.integers(2000, 20000))
        w = int(rng.integers(1, 9))
        h = int(rng.integers(2, 5))
        words = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint32)
        b = 6
        idx_list, cand_list = [], []
        for i in range(b):
            if i == 2:
                idx_list.append(None)
                cand_list.append(None)
                continue
            k = int(rng.integers(1, 300))
            idx_list.append(
                rng.integers(0, m, size=(k, h)).astype(np.int64)
            )
            nc = int(rng.integers(0, 9))
            cand_list.append(
                np.unique(
                    rng.integers(0, w * 32, size=nc)
                ).astype(np.int64)
            )
        ver = DeviceVerifier(BitSliceMatrix(words, w * 32))
        got = ver.counts(idx_list, cand_list)
        want = verify_queries(words, idx_list, cand_list)
        for g, wnt in zip(got, want):
            assert np.array_equal(g, wnt), trial


def test_verified_identical_through_mesh_engine(tmp_path):
    """Two-stage verified search with the SCREEN on a device mesh
    (engine=mesh over the 8 virtual CPU devices): result dicts remain
    identical to the classic oracle."""
    rng = np.random.default_rng(77)
    seqs = _dataset(rng, n=4)
    names = ["g%d" % i for i in range(4)] + ["m%d" % i for i in range(4)]
    cl, vr, classic_cfg, ver_cfg = _build_pair(tmp_path, seqs, names)
    vm = BIGSI(dict(ver_cfg, engine="mesh"))
    assert type(vm.screen_engine).__name__ == "MeshEngine"
    queries = [s[40:260] for s in seqs]
    for t in (1.0, 0.7):
        assert vm.search_batch(queries, threshold=t) == \
            cl.search_batch(queries, threshold=t)
        assert [vm.search(q, t) for q in queries] == \
            [cl.search(q, t) for q in queries]
