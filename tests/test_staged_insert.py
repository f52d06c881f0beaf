"""Staged insert (SURVEY §7.4 / VERDICT r2 item 7): ``insert`` appends a
side-shard column in O(m/8) — rows.bin is never rewritten — queries AND
the side columns in, and ``compact``/``merge`` folds them into the main
matrix.  Contrast: the reference pokes every row per inserted column
(``bigsi/matrix/bitmatrix.py:67-75``)."""

import os
import random

import numpy as np
import pytest

from bigsi_tpu import BIGSI


def _config(tmp_path, **kw):
    cfg = {
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": str(tmp_path / "idx")},
        "k": 9,
        "m": 4096,
        "h": 3,
    }
    cfg.update(kw)
    return cfg


def _rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _kmers(s, k=9):
    return [s[i : i + k] for i in range(len(s) - k + 1)]


def _build(cfg, n_samples, rng):
    seqs = [_rand_seq(rng, 80) for _ in range(n_samples)]
    blooms = [BIGSI.bloom(cfg, _kmers(s)) for s in seqs]
    names = ["s%d" % i for i in range(n_samples)]
    return BIGSI.build(cfg, blooms, names), seqs


def test_insert_does_not_rewrite_rows_bin(tmp_path):
    rng = random.Random(3)
    cfg = _config(tmp_path)
    bigsi, seqs = _build(cfg, 1000, rng)
    rows_bin = str(tmp_path / "idx" / "rows.bin")
    before = (os.path.getmtime(rows_bin), os.path.getsize(rows_bin))

    new_seq = _rand_seq(rng, 80)
    bigsi.insert(BIGSI.bloom(cfg, _kmers(new_seq)), "inserted-1")

    after = (os.path.getmtime(rows_bin), os.path.getsize(rows_bin))
    assert before == after, "insert rewrote rows.bin"
    assert os.path.exists(str(tmp_path / "idx" / "side.bin"))

    # the inserted sample is immediately searchable — exact, inexact,
    # and scored paths all see the side column
    hits = bigsi.search(new_seq, 1.0)
    assert "inserted-1" in [h["sample_name"] for h in hits]
    hits = bigsi.search(new_seq, 0.5)
    assert hits[0]["sample_name"] == "inserted-1"
    scored = bigsi.search(new_seq, 0.5, score=True)
    ins = next(h for h in scored if h["sample_name"] == "inserted-1")
    assert set(ins["kmer-presence"]) == {"1"}
    # existing samples still hit exactly
    assert "s0" in [h["sample_name"] for h in bigsi.search(seqs[0], 1.0)]


def test_insert_batch_and_lookup_cover_side(tmp_path):
    rng = random.Random(5)
    cfg = _config(tmp_path)
    bigsi, seqs = _build(cfg, 5, rng)
    extra = [_rand_seq(rng, 80) for _ in range(3)]
    for i, s in enumerate(extra):
        bigsi.insert(BIGSI.bloom(cfg, _kmers(s)), "x%d" % i)
    queries = seqs[:2] + extra + [_rand_seq(rng, 60)]
    want = [bigsi.search(q, 0.5) for q in queries]
    got = bigsi.search_batch(queries, 0.5)
    assert got == want
    # public lookup() includes side columns at their colour positions
    d = bigsi.lookup(_kmers(extra[0])[0])
    assert len(next(iter(d.values()))) == 8


def test_compact_folds_side_and_preserves_results(tmp_path):
    rng = random.Random(7)
    cfg = _config(tmp_path)
    bigsi, seqs = _build(cfg, 6, rng)
    extra = [_rand_seq(rng, 80) for _ in range(2)]
    for i, s in enumerate(extra):
        bigsi.insert(BIGSI.bloom(cfg, _kmers(s)), "x%d" % i)
    queries = [seqs[0], extra[0], extra[1], _rand_seq(rng, 50)]
    want = [bigsi.search(q, 0.4) for q in queries]

    bigsi.compact()
    assert bigsi.side is None
    assert not os.path.exists(str(tmp_path / "idx" / "side.bin"))
    assert bigsi.bitmatrix.num_cols == 8
    assert [bigsi.search(q, 0.4) for q in queries] == want

    # a fresh handle reads the compacted index identically
    again = BIGSI(cfg)
    assert [again.search(q, 0.4) for q in queries] == want


def test_side_shard_survives_reopen(tmp_path):
    rng = random.Random(9)
    cfg = _config(tmp_path)
    bigsi, seqs = _build(cfg, 4, rng)
    s = _rand_seq(rng, 80)
    bigsi.insert(BIGSI.bloom(cfg, _kmers(s)), "late")
    reopened = BIGSI(cfg)
    assert reopened.side is not None and reopened.side.num_cols == 1
    assert "late" in [h["sample_name"] for h in reopened.search(s, 1.0)]


@pytest.mark.parametrize("engine", ["numpy", "device"])
def test_staged_insert_engines_agree(tmp_path, engine):
    rng = random.Random(11)
    cfg = _config(tmp_path, layout="minimizer", **{"tile-rows": 16})
    bigsi, seqs = _build(cfg, 4, rng)
    s = _rand_seq(rng, 80)
    bigsi.insert(BIGSI.bloom(cfg, _kmers(s)), "late")
    want = [bigsi.search(q, 0.5) for q in seqs + [s]]
    dev = BIGSI(dict(cfg, engine=engine))
    assert [dev.search(q, 0.5) for q in seqs + [s]] == want
    assert dev.search_batch(seqs + [s], 0.5) == want
