"""search_batch parity: one batched dispatch == N per-query searches.

Covers every engine x layout combination the dispatcher can pick on
CPU (host numpy, device classic/blocked/minimizer), exact + inexact
thresholds, padding (ragged query lengths), empty/short queries, and
deleted-sample filtering.
"""

import numpy as np
import pytest

from bigsi_tpu import BIGSI
from bigsi_tpu.storage import get_storage


def make_config(name, layout="classic", engine="numpy"):
    return {
        "storage-engine": "memory",
        "storage-config": {"filename": name},
        "k": 9,
        "m": 2048,
        "h": 3,
        "layout": layout,
        "engine": engine,
    }


def random_seq(rng, n):
    return "".join(rng.choice(list("ACGT")) for _ in range(n))


@pytest.fixture(autouse=True)
def clean():
    for layout in ("classic", "blocked", "minimizer"):
        for engine in ("numpy", "device"):
            get_storage(make_config("sb-%s-%s" % (layout, engine))).delete_all()
    yield


@pytest.mark.parametrize("engine", ["numpy", "device"])
@pytest.mark.parametrize("layout", ["classic", "blocked", "minimizer"])
@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_search_batch_matches_search(layout, engine, threshold):
    import random

    rng = random.Random(7)
    cfg = make_config("sb-%s-%s" % (layout, engine), layout, engine)
    seqs = [random_seq(rng, n) for n in (40, 60, 25)]
    blooms = [
        BIGSI.bloom(cfg, [s[i : i + 9] for i in range(len(s) - 8)]) for s in seqs
    ]
    bigsi = BIGSI.build(cfg, blooms, ["s0", "s1", "s2"])

    queries = [
        seqs[0],
        seqs[1][:30],
        random_seq(rng, 50),
        seqs[2] + seqs[0][:12],
        seqs[1],
    ]
    want = [bigsi.search(q, threshold) for q in queries]
    got = bigsi.search_batch(queries, threshold)
    assert got == want


def test_search_batch_short_and_empty_queries():
    cfg = make_config("sb-classic-numpy")
    bigsi = BIGSI.build(cfg, [BIGSI.bloom(cfg, ["ACGTACGTA"])], ["s0"])
    got = bigsi.search_batch(["ACGT", "ACGTACGTA", ""], 1.0)
    assert got[0] == []  # shorter than k: no k-mers
    assert got[2] == []
    assert [r["sample_name"] for r in got[1]] == ["s0"]


def test_search_batch_filters_deleted_samples():
    import random

    rng = random.Random(3)
    cfg = make_config("sb-classic-numpy")
    seqs = [random_seq(rng, 40) for _ in range(3)]
    blooms = [
        BIGSI.bloom(cfg, [s[i : i + 9] for i in range(len(s) - 8)]) for s in seqs
    ]
    bigsi = BIGSI.build(cfg, blooms, ["s0", "s1", "s2"])
    bigsi.delete_sample("s1")
    got = bigsi.search_batch([seqs[1], seqs[0]], 0.3)
    assert all(r["sample_name"] != "s1" for r in got[0])
    assert got == [bigsi.search(seqs[1], 0.3), bigsi.search(seqs[0], 0.3)]


def test_search_batch_score_falls_back():
    import random

    rng = random.Random(5)
    cfg = make_config("sb-classic-numpy")
    seq = random_seq(rng, 60)
    bigsi = BIGSI.build(
        cfg, [BIGSI.bloom(cfg, [seq[i : i + 9] for i in range(len(seq) - 8)])], ["s0"]
    )
    got = bigsi.search_batch([seq, seq[:30]], 0.5, score=True)
    want = [bigsi.search(seq, 0.5, True), bigsi.search(seq[:30], 0.5, True)]
    assert got == want
    assert "score" in got[0][0]


@pytest.mark.parametrize("engine", ["numpy", "device"])
@pytest.mark.parametrize("layout", ["classic", "minimizer"])
def test_search_batch_scored_matches_search(layout, engine):
    """Batched scoring (VERDICT r2 item 5): one counts dispatch, then a
    presence/score pass over hit queries only — result dicts (incl.
    score/pident/evalue/kmer-presence keys) identical to search()."""
    import random

    rng = random.Random(21)
    cfg = make_config("sb-%s-%s" % (layout, engine), layout, engine)
    seqs = [random_seq(rng, n) for n in (60, 45, 30)]
    blooms = [
        BIGSI.bloom(cfg, [s[i : i + 9] for i in range(len(s) - 8)]) for s in seqs
    ]
    bigsi = BIGSI.build(cfg, blooms, ["s0", "s1", "s2"])
    # >= 64 queries: substrings (hits), mutants (inexact hits), noise
    queries = []
    for i in range(64):
        base = seqs[i % 3]
        if i % 4 == 0:
            queries.append(base)
        elif i % 4 == 1:
            queries.append(base[5 : 5 + 20 + i % 7])
        elif i % 4 == 2:
            s = list(base)
            s[7] = "ACGT"[(("ACGT".index(s[7]) + 1) % 4)]
            queries.append("".join(s))
        else:
            queries.append(random_seq(rng, 40))
    want = [bigsi.search(q, 0.3, score=True) for q in queries]
    got = bigsi.search_batch(queries, 0.3, score=True)
    assert got == want
