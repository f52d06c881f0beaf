"""Genome-scale queries (10 kb+): the serving facade must handle
queries far past the device-prep geometry guard — falling back to the
host-prep engine paths — with results identical to the numpy oracle
(the reference's long-query story is the same decompose-and-count,
bigsi/graph/bigsi.py:174-230)."""

import numpy as np

from bigsi_tpu.graph.bigsi import BIGSI
from bigsi_tpu.kmers import seq_to_kmers

BASES = "ACGT"


def _mk(tmp_path, engine, layout_extra):
    rng = np.random.default_rng(11)
    genomes = [
        "".join(BASES[i] for i in rng.integers(0, 4, 12_000))
        for _ in range(3)
    ]
    cfg = {
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": str(tmp_path / ("ix-" + engine))},
        "k": 31, "m": 1 << 19, "h": 3, "engine": engine, **layout_extra,
    }
    blooms = [BIGSI.bloom(cfg, seq_to_kmers(g, 31)) for g in genomes]
    return (
        BIGSI.build(cfg, blooms, ["s%d" % i for i in range(3)]),
        genomes,
    )


def test_10kb_query_minimizer_device_engine(tmp_path):
    extra = {"layout": "minimizer", "tile-rows": 16, "minimizer-window": 19}
    dev, genomes = _mk(tmp_path, "device", extra)
    host, _ = _mk(tmp_path, "numpy", extra)
    q = genomes[0][500:10_500]  # 10 kb: past the seq-path NK ceiling
    assert dev.search(q, threshold=0.9) == host.search(q, threshold=0.9)
    got = dev.search_batch([q, genomes[1][:8_000]], threshold=0.9)
    want = host.search_batch([q, genomes[1][:8_000]], threshold=0.9)
    assert got == want
    assert got[0] and got[0][0]["sample_name"] == "s0"
    assert got[0][0]["num_kmers"] <= 9970  # distinct <= window count


def test_10kb_query_classic_engine(tmp_path):
    dev, genomes = _mk(tmp_path, "device", {})
    host, _ = _mk(tmp_path, "numpy", {})
    q = genomes[2][:10_031]
    assert dev.search(q, 1.0) == host.search(q, 1.0)
    assert dev.search_batch([q], threshold=0.7) == host.search_batch(
        [q], threshold=0.7
    )


def test_10kb_query_over_http_post(tmp_path):
    """Long queries ride POST bodies (GET URLs cap near 64 KB in the
    stdlib server); the response must match a direct search."""
    import json
    import threading
    import urllib.request

    from bigsi_tpu.http.server import make_server

    extra = {"layout": "minimizer", "tile-rows": 16, "minimizer-window": 19}
    idx, genomes = _mk(tmp_path, "device", extra)
    server = make_server(dict(idx.config), host="127.0.0.1", port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        q = genomes[1][200:10_200]
        req = urllib.request.Request(
            "http://127.0.0.1:%d/search" % port,
            data=json.dumps({"seq": q, "threshold": 0.9}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        assert out["results"] == idx.search(q, threshold=0.9)
        assert out["results"][0]["sample_name"] == "s1"
    finally:
        server.shutdown()


def test_mixed_length_batch_splits_stragglers(tmp_path, monkeypatch):
    """A batch of short queries + one genome-scale straggler: the short
    majority must STAY on the device seq path (not be dragged to the
    host path by the straggler's geometry), results identical to the
    host oracle."""
    extra = {"layout": "minimizer", "tile-rows": 16, "minimizer-window": 19}
    dev, genomes = _mk(tmp_path, "device", extra)
    host, _ = _mk(tmp_path, "numpy", extra)
    queries = [genomes[i % 3][j * 97 : j * 97 + 300] for i, j in
               enumerate([(x % 20) for x in range(12)])]
    queries.append(genomes[2][:8_000])  # the straggler
    calls = {"dev": 0}
    orig = dev.engine.counts_batch_seqs

    def spy(*a, **kw):
        out = orig(*a, **kw)
        calls["dev"] += out is not None
        return out

    monkeypatch.setattr(dev.engine, "counts_batch_seqs", spy)
    got = dev.search_batch(queries, threshold=0.9)
    assert calls["dev"] >= 1, "short majority left the device path"
    want = host.search_batch(queries, threshold=0.9)
    assert got == want
    assert got[-1] and got[-1][0]["sample_name"] == "s2"


def test_mixed_length_batch_all_paths_and_score(tmp_path):
    """The top-level length bucketing must preserve result parity on
    every dispatch path — classic engine, scoring on, exact and
    inexact thresholds — for a batch mixing 300 b and 10 kb queries."""
    dev, genomes = _mk(tmp_path, "device", {})
    host, _ = _mk(tmp_path, "numpy", {})
    queries = [genomes[i % 3][60:360] for i in range(10)]
    queries.insert(3, genomes[1][:10_000])
    queries.append(genomes[2][:9_000])
    for t in (1.0, 0.8):
        assert dev.search_batch(queries, threshold=t) == \
            host.search_batch(queries, threshold=t)
    got = dev.search_batch(queries[:9] + [queries[3]], 0.8, score=True)
    want = host.search_batch(queries[:9] + [queries[3]], 0.8, score=True)
    assert got == want
