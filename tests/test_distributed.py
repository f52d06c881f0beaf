"""Multi-host distribution test: 2 processes x 2 virtual CPU devices.

Emulates SURVEY §5.8's multi-host story without hardware:
``jax.distributed.initialize`` against a localhost coordinator, the
sample axis of the mesh spanning "hosts", query broadcast from host 0
(``broadcast_one_to_all``), lockstep worker execution, host-0 result
assembly — the same code path a multi-host deployment takes.  Results are
checked against a single-process numpy oracle.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
WORKER = os.path.join(HERE, "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _oracle(words, idx, mask):
    """counts + exact from first principles."""
    m, w = words.shape
    b, k, h = idx.shape
    # bit n of word j = sample 32*j + n (LSB-first within the word)
    cols = np.zeros((m, w * 32), dtype=np.uint8)
    for j in range(w):
        for n in range(32):
            cols[:, 32 * j + n] = (words[:, j] >> n) & 1
    counts = np.zeros((b, w * 32), dtype=np.int64)
    exact = np.ones((b, w * 32), dtype=bool)
    for i in range(b):
        for q in range(k):
            presence = cols[idx[i, q, 0]]
            for j in range(1, h):
                presence = presence & cols[idx[i, q, j]]
            if mask[i, q]:
                counts[i] += presence
                exact[i] &= presence.astype(bool)
    return counts, exact


@pytest.mark.parametrize(
    "row_shards,legacy",
    [(1, False), (2, False), (1, True)],  # legacy = gloo broadcast legs
    ids=["ctrl", "ctrl-rowsharded", "gloo-fallback"],
)
def test_two_process_distributed_query(row_shards, legacy):
    port = _free_port()
    num_processes, local_devices = 2, 2
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    if legacy:
        # the TCP control plane replaced the per-dispatch gloo legs
        # (round 5); this variant keeps the fallback path honest
        env["BIGSI_TPU_NO_CONTROL_PLANE"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(num_processes), str(port),
             str(local_devices), str(row_shards)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        for pid in range(num_processes)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=540)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, "worker failed:\n%s\n%s" % (out, err[-2000:])
        assert "PROC_OK" in out

    results = [
        json.loads(line)
        for line in outs[0][1].splitlines()
        if line.startswith("{")
    ]
    assert len(results) == (5 if row_shards == 1 else 4)
    dispatch = results.pop()
    assert dispatch["dispatch_ms"] > 0  # measured, recorded in SCALE.md
    seq_rec = results.pop() if row_shards == 1 else None
    grouped = results.pop()

    # reproduce the worker's deterministic matrix + queries, oracle-check
    m, n_samples, h = 4096, 96, 3
    w = -(-n_samples // 32)
    rng = np.random.default_rng(42)
    words = rng.integers(0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(
        np.uint32
    )
    qrng = np.random.default_rng(7)
    for rec, (b, k) in zip(results, ((4, 32), (2, 48))):
        idx = qrng.integers(0, m, size=(b, k, h)).astype(np.int32)
        mask = qrng.random((b, k)) < 0.9
        assert rec["idx_digest"] == int(idx.sum())
        assert rec["mask_digest"] == int(mask.sum())
        counts, exact = _oracle(words, idx, mask)
        assert rec["b"] == b and rec["k"] == k
        assert rec["counts_sum"] == int(counts.sum())
        assert rec["counts_head"] == counts[0, :8].tolist()
        # exact words: pack oracle bools LSB-first
        packed0 = 0
        for n in range(32):
            packed0 |= int(exact[0, n]) << n
        packed1 = 0
        for n in range(32):
            packed1 |= int(exact[0, 32 + n]) << n
        assert rec["exact_head"] == [packed0, packed1]

    # grouped (minimizer tile-dedup) dispatch — reproduce the worker's
    # tile-coherent queries and oracle-check the counts
    tr = 16
    grng = np.random.default_rng(11)
    gb, gk = 3, 36
    tile = np.repeat(
        grng.integers(0, m // tr, size=(gb, gk // 3)), 3, axis=1
    )[:, :gk].astype(np.int64)
    slots = grng.integers(0, tr, size=(gb, gk, h)).astype(np.int64)
    gidx = tile[:, :, None] * tr + slots
    gmask_q = grng.random((gb, gk)) < 0.9
    assert grouped["grouped_idx_digest"] == int(gidx.sum())
    assert grouped["row_shards"] == row_shards
    counts, _ = _oracle(words, gidx.astype(np.int32), gmask_q)
    assert grouped["grouped_counts_sum"] == int(counts.sum())
    assert grouped["grouped_head"] == counts[0, :8].tolist()

    if seq_rec is not None:
        # bytes-to-counts dispatch: single-device prep+count oracle
        import jax.numpy as jnp

        from bigsi_tpu.hashing.scheme import (
            MINIMIZER_SEED,
            default_minimizer_s,
        )
        from bigsi_tpu.index.device_engine import DeviceEngine
        from bigsi_tpu.ops.lookup import (
            grouped_counts_cols,
            pack_tile_cols_host,
        )
        from bigsi_tpu.ops.prep_jax import prep_streams_device

        srng = np.random.default_rng(5)
        sb, sl = 4, 80 + 31 - 1
        seqs = np.frombuffer(b"ACGT", dtype=np.uint8)[
            srng.integers(0, 4, size=(sb, sl))
        ]
        lens = np.full(sb, sl, dtype=np.int32)
        assert seq_rec["seq_digest"] == int(seqs.sum())
        k = 31
        tr = 16
        s_mer = default_minimizer_s(k)
        window = k - s_mer + 1
        ut, gm, nv, ok = prep_streams_device(
            seqs, lens, k=k, s=s_mer, num_tiles=m // tr, h=h,
            tile_rows=tr, r=window + 1,
            u_cap=DeviceEngine._seq_u_cap(sl - k + 1, window),
            seed=MINIMIZER_SEED,
        )
        assert bool(ok)
        cols = pack_tile_cols_host(words, tr)
        want = np.asarray(
            grouped_counts_cols(jnp.asarray(cols), ut, gm, nv)
        )
        assert seq_rec["seq_counts_sum"] == int(want.sum())
        assert seq_rec["seq_head"] == want[0, :8].tolist()
        assert seq_rec["seq_nv"] == np.asarray(nv).tolist()


def test_distributed_serving(tmp_path):
    """serve --distributed round-trip: build an index on disk, serve it
    from 2 processes (host 0 HTTP + 1 lockstep worker), search over
    HTTP, and confirm mutating routes are rejected read-only."""
    # build the index single-process (offline build, then restart the
    # fleet — the documented operating model)
    import subprocess as sp

    index_dir = str(tmp_path / "idx")
    ref = (
        "ACGTAGCATCGGATCGTAGCATCGAGCTACGATCGATCGATCGGATTAGCTACGACTAGCTAGCATCGAT"
    )
    alt = ref[:40] + ("C" if ref[40] != "C" else "G") + ref[41:]
    build_src = (
        "import sys; sys.path.insert(0, %r)\n"
        "from bigsi_tpu import BIGSI\n"
        "from bigsi_tpu.kmers import seq_to_kmers\n"
        "cfg = {'storage-engine': 'bigsi-tpu',\n"
        "       'storage-config': {'filename': %r},\n"
        "       'k': 31, 'm': 20000, 'h': 3,\n"
        "       'layout': 'minimizer', 'tile-rows': 16}\n"
        "blooms = [BIGSI.bloom(cfg, seq_to_kmers(s, 31)) for s in (%r, %r)]\n"
        "BIGSI.build(cfg, blooms, ['a', 'b'])\n"
    ) % (os.path.join(HERE, ".."), index_dir, ref, alt)
    sp.run([sys.executable, "-c", build_src], check=True, timeout=300)

    coord_port = _free_port()
    http_port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "distributed_serve_worker.py"),
             str(pid), "2", str(coord_port), "2", str(http_port), index_dir,
             ref],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=540)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, "serve worker failed:\n%s\n%s" % (out, err[-2000:])
        assert "PROC_OK" in out

    host0 = outs[0][1]
    search_line = next(
        line for line in host0.splitlines() if line.startswith("SEARCH:")
    )
    body = json.loads(search_line[len("SEARCH:"):])
    names = [r["sample_name"] for r in body["results"]]
    assert "a" in names  # exact sample always hits
    assert "citation" in body
    # bulk search exercises the multi-process minimizer path (OP_SEQS
    # bytes-broadcast now that v3 is the persisted default; grouped is
    # the fallback)
    bulk_line = next(
        line for line in host0.splitlines() if line.startswith("BULK:")
    )
    bulk = json.loads(bulk_line[len("BULK:"):])
    assert len(bulk) == 3
    for rec in bulk:
        assert "a" in [r["sample_name"] for r in rec["results"]]
    assert "INSERT_STATUS:403" in host0


def test_distribute_words_never_densifies():
    """distribute_words must only allocate this process's column shard
    — the full padded [m, w_pad] matrix must never exist in RAM (the
    450k-sample requirement: 1.4 TB per host if it did)."""
    from unittest import mock

    import jax

    from bigsi_tpu.parallel import distributed as dist
    from bigsi_tpu.parallel.sharding import make_mesh

    s = min(8, len(jax.devices()))
    mesh = make_mesh(axis_sizes=(1, 1, s))
    if s < 2:
        pytest.skip("needs >= 2 virtual devices")
    m, w = 4096, 63  # w NOT divisible by s: exercises shard padding
    shard_w = -(-w // s)
    words = np.random.default_rng(5).integers(
        0, 2 ** 32, size=(m, w), dtype=np.uint64
    ).astype(np.uint32)
    sizes = []
    real_zeros = np.zeros

    def spy_zeros(shape, *a, **kw):
        out = real_zeros(shape, *a, **kw)
        sizes.append(out.nbytes)
        return out

    with mock.patch.object(dist.np, "zeros", side_effect=spy_zeros):
        garr, local = dist.distribute_words(words, mesh, m=m, w=w)
    # every allocation is at most ONE column shard — never the padded
    # full matrix (the regression: np.zeros((m, w_pad)))
    assert sizes, "expected at least the padded boundary shard"
    assert max(sizes) <= m * shard_w * 4
    assert local.shape[0] == m
    assert garr.shape == (m, shard_w * s)
    # values survive the shard round-trip
    np.testing.assert_array_equal(np.asarray(garr)[:, :w], words)


def test_spread_subset_rejects_uneven_split(monkeypatch):
    # regression (round-3 advisor): an uneven need/process split used to
    # fall back silently to devices[:need], concentrating the sub-mesh
    # on the first host(s) and crashing other processes later in
    # _local_word_slice.  It must raise a descriptive error instead.
    import jax

    from bigsi_tpu.parallel.distributed import _spread_subset

    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs >= 4 virtual devices")
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="cannot split them evenly"):
        _spread_subset(devices, 3)
    # even need but devices spanning fewer processes than claimed: the
    # picked-count guard fires rather than returning a short list
    with pytest.raises(ValueError, match="even spread picked"):
        _spread_subset(devices, 2)
    # single-process (the real situation here): even splits succeed
    monkeypatch.setattr(jax, "process_count", lambda: 1)
    assert len(_spread_subset(devices, 2)) == 2


def test_distributed_serving_verified(tmp_path):
    """serve --distributed over a VERIFIED (screen:) index: the screen
    dispatches through the collective engine, the verify pass runs
    host-0 classic — HTTP results identical to a plain classic index."""
    import subprocess as sp

    index_dir = str(tmp_path / "vidx")
    classic_dir = str(tmp_path / "cidx")
    ref = (
        "ACGTAGCATCGGATCGTAGCATCGAGCTACGATCGATCGATCGGATTAGCTACGACTAGCTAGCATCGAT"
    )
    alt = ref[:40] + ("C" if ref[40] != "C" else "G") + ref[41:]
    build_src = (
        "import sys; sys.path.insert(0, %r)\n"
        "from bigsi_tpu import BIGSI\n"
        "from bigsi_tpu.kmers import seq_to_kmers\n"
        "ver = {'storage-engine': 'bigsi-tpu',\n"
        "       'storage-config': {'filename': %r},\n"
        "       'k': 31, 'm': 20000, 'h': 3, 'screen': 'minimizer'}\n"
        "cla = {'storage-engine': 'bigsi-tpu',\n"
        "       'storage-config': {'filename': %r},\n"
        "       'k': 31, 'm': 20000, 'h': 3}\n"
        "for cfg in (ver, cla):\n"
        "    blooms = [BIGSI.bloom(cfg, seq_to_kmers(s, 31))\n"
        "              for s in (%r, %r)]\n"
        "    BIGSI.build(cfg, blooms, ['a', 'b'])\n"
    ) % (os.path.join(HERE, ".."), index_dir, classic_dir, ref, alt)
    sp.run([sys.executable, "-c", build_src], check=True, timeout=300)

    coord_port = _free_port()
    http_port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "distributed_serve_worker.py"),
             str(pid), "2", str(coord_port), "2", str(http_port), index_dir,
             ref],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=540)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, "serve worker failed:\n%s\n%s" % (out, err[-2000:])
        assert "PROC_OK" in out

    host0 = outs[0][1]
    search_line = next(
        line for line in host0.splitlines() if line.startswith("SEARCH:")
    )
    body = json.loads(search_line[len("SEARCH:"):])
    # oracle: direct classic search on the twin index
    sys.path.insert(0, os.path.join(HERE, ".."))
    from bigsi_tpu import BIGSI

    cla = BIGSI({
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": classic_dir},
        "k": 31, "m": 20000, "h": 3,
    })
    assert body["results"] == cla.search(ref, threshold=0.5)
