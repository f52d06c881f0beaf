"""The all-on-device serving path (search_batch -> counts_batch_seqs):
must actually engage on minimizer/v3 cols indexes, return results
identical to the host-prep path, and fall back cleanly on non-ACGT
bytes and grouped-entry overflow."""

import numpy as np
import pytest

from bigsi_tpu import native
from bigsi_tpu.graph.bigsi import BIGSI
from bigsi_tpu.kmers import seq_to_kmers

BASES = "ACGT"


def _mk_index(tmp_path, window=19, n=6, glen=600, k=31):
    rng = np.random.default_rng(5)
    genomes = [
        "".join(BASES[i] for i in rng.integers(0, 4, glen)) for _ in range(n)
    ]
    cfg = {
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": str(tmp_path / "idx")},
        "k": k, "m": 1 << 18, "h": 3, "engine": "device",
        "layout": "minimizer", "tile-rows": 16, "minimizer-window": window,
    }
    blooms = [BIGSI.bloom(cfg, seq_to_kmers(g, k)) for g in genomes]
    idx = BIGSI.build(cfg, blooms, ["s%d" % i for i in range(n)])
    return idx, genomes, rng


def test_seq_path_engages_and_matches_host_path(tmp_path, monkeypatch):
    idx, genomes, rng = _mk_index(tmp_path)
    assert idx.engine.supports_seq_batch()
    queries = [g[37 : 37 + 200] for g in genomes] + [
        "".join(BASES[i] for i in rng.integers(0, 4, 200)) for _ in range(3)
    ]
    calls = {"n": 0}
    orig = idx.engine.counts_batch_seqs

    def spy(*a, **kw):
        calls["n"] += 1
        out = orig(*a, **kw)
        assert out is not None, "device seq path fell back (overflow?)"
        return out

    monkeypatch.setattr(idx.engine, "counts_batch_seqs", spy)
    got = idx.search_batch(queries, threshold=0.7)
    assert calls["n"] == 1, "device seq path did not engage"

    # host-prep oracle: disable the seq path wholesale
    monkeypatch.setattr(
        idx.engine, "supports_seq_batch", lambda: False, raising=False
    )
    want = idx.search_batch(queries, threshold=0.7)
    assert got == want


def test_seq_path_duplicate_kmers_distinct_semantics(tmp_path, monkeypatch):
    """A query containing a repeated k-mer must report num_kmers =
    DISTINCT count (the reference's set(kmers)) on both paths."""
    idx, genomes, _ = _mk_index(tmp_path)
    dup_query = genomes[0][:100] + genomes[0][:100]  # every kmer twice-ish
    got = idx.search_batch([dup_query, genomes[1][:120]], threshold=0.5)
    monkeypatch.setattr(
        idx.engine, "supports_seq_batch", lambda: False, raising=False
    )
    want = idx.search_batch([dup_query, genomes[1][:120]], threshold=0.5)
    assert got == want
    assert got[0], "self-query must hit"
    # distinct kmers of the doubled query < naive window count
    naive = len(dup_query) - 31 + 1
    assert got[0][0]["num_kmers"] < naive


def test_seq_path_falls_back_on_non_acgt(tmp_path, monkeypatch):
    idx, genomes, _ = _mk_index(tmp_path)
    qs = [genomes[0][:150], genomes[1][:80] + "N" + genomes[1][81:150]]
    calls = {"n": 0}
    orig = idx.engine.counts_batch_seqs

    def spy(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(idx.engine, "counts_batch_seqs", spy)
    got = idx.search_batch(qs, threshold=0.7)
    assert calls["n"] == 0, "non-ACGT batch must use the host path"
    monkeypatch.setattr(
        idx.engine, "supports_seq_batch", lambda: False, raising=False
    )
    assert got == idx.search_batch(qs, threshold=0.7)


def test_seq_path_overflow_falls_back(tmp_path, monkeypatch):
    """Force a tiny grouped-entry budget: the device program reports
    overflow and search_batch silently re-runs on the host path."""
    idx, genomes, _ = _mk_index(tmp_path)
    monkeypatch.setattr(
        type(idx.engine), "_seq_u_cap", staticmethod(lambda nk, w: 2)
    )
    qs = [g[: 200] for g in genomes[:3]]
    got = idx.search_batch(qs, threshold=0.7)
    monkeypatch.setattr(
        idx.engine, "supports_seq_batch", lambda: False, raising=False
    )
    assert got == idx.search_batch(qs, threshold=0.7)


@pytest.mark.skipif(not native.available(), reason="native lib required")
def test_seq_path_short_and_empty_queries(tmp_path):
    idx, genomes, _ = _mk_index(tmp_path)
    qs = [genomes[0][:150], "ACGT", genomes[2][:35]]
    got = idx.search_batch(qs, threshold=1.0)
    assert got[1] == []  # shorter than k
    assert got[0] and got[0][0]["sample_name"] == "s0"


def test_http_serving_drives_seq_path(tmp_path, monkeypatch):
    """End-to-end HTTP: concurrent /search requests coalesce in the
    micro-batcher into ONE search_batch that takes the device seq path
    (minimizer/v3 cols index)."""
    import json
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from bigsi_tpu.http.server import make_server

    idx, genomes, _ = _mk_index(tmp_path)
    calls = {"n": 0}
    orig = type(idx.engine).counts_batch_seqs

    def spy(self, *a, **kw):
        calls["n"] += 1
        out = orig(self, *a, **kw)
        assert out is not None, "device seq path fell back (overflow?)"
        return out

    monkeypatch.setattr(type(idx.engine), "counts_batch_seqs", spy)
    cfg = dict(idx.config)
    cfg["serve_batch_wait_ms"] = 30

    server = make_server(cfg, host="127.0.0.1", port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        def hit(i):
            q = genomes[i % len(genomes)][20:220]
            url = "http://127.0.0.1:%d/search?seq=%s&threshold=0.7" % (
                port, q,
            )
            with urllib.request.urlopen(url) as resp:
                return json.loads(resp.read())
        with ThreadPoolExecutor(max_workers=4) as pool:
            outs = list(pool.map(hit, range(4)))
        assert all(o["results"] for o in outs)
        assert {o["results"][0]["sample_name"] for o in outs} == {
            "s0", "s1", "s2", "s3",
        }
        assert calls["n"] >= 1, "batcher did not reach the seq path"
    finally:
        server.shutdown()


def test_seq_path_tight_budget_escalation(tmp_path, monkeypatch):
    """First-try tight entry budget: when it overflows, the engine
    escalates to the safe budget in the SAME call (results correct)
    and keeps the big budget for that length bucket."""
    idx, genomes, _ = _mk_index(tmp_path, window=3)
    eng = idx.engine
    assert eng.supports_seq_batch()
    # force the tight try to genuinely overflow (real streams usually
    # fit the 1.15x headroom, which is the point of the tight cap)
    monkeypatch.setattr(
        type(eng), "_seq_u_tight", staticmethod(lambda nk, w: 8)
    )
    qs = [g[:180] for g in genomes[:3]]
    got = idx.search_batch(qs, threshold=0.7)
    assert eng._seq_cap_esc, "tight budget should have overflowed"
    monkeypatch.setattr(
        eng, "supports_seq_batch", lambda: False, raising=False
    )
    want = idx.search_batch(qs, threshold=0.7)
    assert got == want


def test_seq_cap_escalation_decays_per_bucket(tmp_path, monkeypatch):
    """VERDICT r4 weak #6: escalation must not be sticky for the
    engine's lifetime.  After SEQ_CAP_DECAY clean big-budget batches
    the tight budget is retried, and only the overflowing LENGTH
    BUCKET is pessimized — other lengths keep the tight cap."""
    import bigsi_tpu.index.device_engine as de

    idx, genomes, _ = _mk_index(tmp_path, window=3)
    eng = idx.engine
    monkeypatch.setattr(eng, "SEQ_CAP_DECAY", 2, raising=False)
    monkeypatch.setattr(
        type(eng), "_seq_u_tight", staticmethod(lambda nk, w: 8)
    )
    seen_caps = []
    orig = de._counts_batch_seqs

    def spy(*a, **kw):
        seen_caps.append(kw["u_cap"])
        return orig(*a, **kw)

    monkeypatch.setattr(de, "_counts_batch_seqs", spy)

    def step(q):
        seqs = np.frombuffer(q.encode(), dtype=np.uint8)[None, :]
        lens = np.asarray([len(q)], dtype=np.int32)
        out = eng.counts_batch_seqs(
            seqs, lens, idx.kmer_size, idx.num_hashes, idx.num_samples
        )
        assert out is not None

    q = genomes[0][:180]
    step(q)  # overflow: tight then big
    assert len(seen_caps) == 2 and seen_caps[0] < seen_caps[1]
    big = seen_caps[1]
    step(q)  # escalated: big only, decay 2 -> 1
    step(q)  # escalated: big only, decay 1 -> 0
    assert seen_caps[2:] == [big, big]
    step(q)  # decayed: tight retried (then big on overflow)
    assert seen_caps[4] < big
    # an unrelated length bucket is NOT pessimized by q's overflow:
    # q pads to lb=192, a 100-byte query pads to lb=128
    assert 192 in eng._seq_cap_esc and 128 not in eng._seq_cap_esc
    q2 = genomes[1][:100]
    del seen_caps[:]
    step(q2)
    # q2's first dispatch was its own tight try, not a shared big cap
    assert len(seen_caps) in (1, 2)
    if len(seen_caps) == 2:
        assert seen_caps[0] < seen_caps[1]


def test_seq_path_long_queries(tmp_path, monkeypatch):
    """VERDICT r4 weak #6: 2-4 kb queries must STAY on the
    bytes-to-counts device path (the old hard cap at ~1 kb silently
    excluded them) and match the host-prep results, including global
    distinct-kmer dedup across prep chunks."""
    idx, genomes, rng = _mk_index(tmp_path, glen=4200)
    assert idx.engine.supports_seq_batch()
    queries = [
        genomes[0][:2200],
        genomes[1][:4000],
        # planted cross-chunk duplicate: kmers of the first 200 bases
        # reappear ~3 kb later (dedup spans PREP_CHUNK boundaries)
        genomes[2][:3000] + genomes[2][:200],
    ]
    calls = {"n": 0}
    orig = idx.engine.counts_batch_seqs

    def spy(*a, **kw):
        calls["n"] += 1
        out = orig(*a, **kw)
        assert out is not None, "device seq path fell back"
        return out

    monkeypatch.setattr(idx.engine, "counts_batch_seqs", spy)
    got = idx.search_batch(queries, threshold=0.7)
    assert calls["n"] == 1, "long-query batch did not take the device path"
    monkeypatch.setattr(
        idx.engine, "supports_seq_batch", lambda: False, raising=False
    )
    want = idx.search_batch(queries, threshold=0.7)
    assert got == want
    assert got[2], "self-query must hit"
    # dup kmers collapsed: distinct count < naive window count
    assert got[2][0]["num_kmers"] < len(queries[2]) - 31 + 1


def test_seq_geometry_guard_bounds_quadratic_work():
    """The guard admits long queries only while B*NK^2 stays within the
    round-4 envelope, and never past SEQ_MAX_NK."""
    from bigsi_tpu.index.device_engine import (
        SEQ_MAX_NK,
        seq_batch_geometry,
    )

    k = 31

    def geom(b, l):
        seqs = np.full((b, l), ord("A"), dtype=np.uint8)
        lens = np.full(b, l, dtype=np.int32)
        return seq_batch_geometry(seqs, lens, k, 19)

    # lengths bucket to multiples of 64, so pick exact bucket tops:
    # lb=1024 -> nk=994 at B=256 is the round-4 worst case
    assert geom(256, 1024) is not None
    assert geom(8, 4096) is not None            # long queries, small B
    assert geom(256, 2048) is None              # too much quadratic work
    assert geom(8, SEQ_MAX_NK + 64) is None     # hard ceiling
