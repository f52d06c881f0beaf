#!/usr/bin/env python
"""Smoke test of the served search path on the GPU, at a real size.

    python chip_smoke.py [--seed 0]
    python chip_smoke.py --cards 4      # only the sample-sharded path

One card (the default) runs two phases in one process, each on an index
made from ``--seed`` at the reference defaults k=31, m=25e6, h=3 with
N=4096 samples (W=128 words, a 12.8 GB matrix on the card):

A. classic layout, ``engine: device``.  The HTTP server
   (bigsi_tpu.http.server, as ``bigsi-tpu serve`` runs it) answers
   concurrent GET /search requests, which the micro-batcher coalesces,
   and one POST /bulk_search of 256 gene-length queries per threshold
   (1.0 and 0.7); the batches run ``search_batch`` ->
   ``_counts_batch_fat``.
B. minimizer layout (slot scheme 3, tile-rows 16, window 19), the same
   queries through ``BIGSI.search_batch``, which must take the on-device
   bytes-to-counts program (``_counts_batch_seqs``); the cols count
   program (``_counts_batch_cols``) is checked beside it.

Every result dict is compared with ``engine: numpy`` (HostEngine) on the
same index, and phase B's streams with the native host prep.  It prints
each count program's compile time, memory analysis, warm step time
(host clock around blocked calls) and bytes read per step, and the
card's name and power limit.  The last line is ``{"ok": true, "device": {...}}``; any failure exits non-zero
without it.  It refuses to run without a GPU.

``--cards 4`` runs only the sample-sharded engine (``engine: mesh``,
mesh (1,1,4)) on four cards at 4x the samples (each card holds the
one-card share), both layouts, against HostEngine.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import statistics
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
K, M, H = 31, 25_000_000, 3  # the reference defaults (bigsi/constants.py)
SAMPLES_PER_CARD = 4096  # W=128 words: a 12.8 GB matrix per card
N_QUERIES, N_PLANTED = 256, 64
THRESHOLDS = (1.0, 0.7)
MINIMIZER = {
    "layout": "minimizer", "tile-rows": 16, "minimizer-window": 19,
    "slot-scheme": 3,
}


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- data ---------------------------------------------------------------


def make_workload(seed: int, n_queries: int, n_planted: int):
    """Planted genomes and gene-length queries, all from ``seed``.

    Half the queries are exact windows of planted genomes, a quarter are
    windows with 0.5% substitutions (found at 0.7, not at 1.0), and a
    quarter are random.  A quarter of the planted samples share another
    planted sample's genome, so some queries hit two samples.  Lengths
    stay within 1 kb so one batch fits the device prep's length bucket.
    """
    from bigsi_tpu.synth import random_genome

    rng = np.random.default_rng(seed)
    distinct = max(1, n_planted - n_planted // 4)
    genomes = [random_genome(rng, 3000) for _ in range(distinct)]
    planted = {
        "planted%d" % i: genomes[i % distinct] for i in range(n_planted)
    }
    queries = []
    for i in range(n_queries):
        length = int(rng.integers(800, 1001))
        kind = i % 4
        if kind == 3:
            queries.append(random_genome(rng, length))
            continue
        g = genomes[int(rng.integers(0, distinct))]
        start = int(rng.integers(0, len(g) - length + 1))
        q = bytearray(g[start : start + length], "ascii")
        if kind == 2:
            for pos in rng.choice(length, size=max(1, length // 200),
                                  replace=False):
                q[pos] = ord("ACGT"[(("ACGT".index(chr(q[pos]))) + 1) % 4])
        queries.append(q.decode("ascii"))
    return planted, queries


def index_config(workdir: str, name: str, layout: dict, store: str,
                 m: int) -> dict:
    cfg = {"k": K, "m": m, "h": H, **layout}
    if store == "disk":
        cfg["storage-engine"] = "bigsi-tpu"
        cfg["storage-config"] = {"filename": os.path.join(workdir, name)}
    else:
        cfg["storage-engine"] = "memory"
        cfg["storage-config"] = {"filename": "chip-smoke-" + name}
    return cfg


def write_json_config(workdir: str, name: str, config: dict) -> dict:
    """Write the config as a .json file and read it back through the
    CLI's loader, as ``bigsi-tpu serve --config`` would."""
    from bigsi_tpu.config import get_config_from_file

    path = os.path.join(workdir, name + ".json")
    with open(path, "w") as f:
        json.dump(config, f)
    return get_config_from_file(path)


def build_index(config: dict, n: int, planted: dict, seed: int) -> dict:
    from bigsi_tpu.synth import write_index

    t0 = time.perf_counter()
    summary = write_index(config, n, planted, seed=seed)
    summary["seconds"] = time.perf_counter() - t0
    log("set-up: index %s" % json.dumps(summary))
    return summary


def oracle_results(config: dict, queries, threshold: float):
    """HostEngine (engine: numpy), one plain ``search`` per query."""
    from bigsi_tpu.graph import BIGSI

    oracle = BIGSI(dict(config, engine="numpy"))
    return [oracle.search(q, threshold) for q in queries]


def compare(name: str, got, want) -> None:
    # Every count on this path is integer arithmetic (bit gathers, ANDs,
    # popcounts); no float matrix product runs, so TF32 cannot arise and
    # the comparison is exact: tolerance 0.
    check(len(got) == len(want), "%s: %d results, want %d"
          % (name, len(got), len(want)))
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    check(not bad, "%s: %d of %d result lists differ from HostEngine "
          "(first at query %d: %r vs %r)" % (
              name, len(bad), len(want), bad[0] if bad else -1,
              got[bad[0]][:2] if bad else None,
              want[bad[0]][:2] if bad else None))
    hits = sum(1 for w in want if w)
    log("%s: %d result lists identical to HostEngine (%d non-empty)"
        % (name, len(want), hits))


# -- device measurements --------------------------------------------------


def memory_analysis(compiled) -> dict:
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(ma, k, None) for k in keys} if ma else {}


def time_program(name: str, jitted, args, static: dict, bytes_read: int,
                 steps: int = 5) -> None:
    """Compile ``jitted`` at the served shapes, then time warm steps
    (host clock around each blocked call, dispatch included)."""
    import jax

    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **static).compile()
    t_compile = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    log("program %s: compile %.3f s; memory_analysis %s; median of %d "
        "warm steps %.6f ms (all: %s); reads %d bytes per step"
        % (name, t_compile, json.dumps(memory_analysis(compiled)), steps,
           statistics.median(times) * 1e3,
           ", ".join("%.6f" % (t * 1e3) for t in times), bytes_read))


def log_memory(device, what: str) -> None:
    stats = device.memory_stats() or {}
    keep = {k: stats[k] for k in ("bytes_in_use", "peak_bytes_in_use",
                                  "bytes_limit") if k in stats}
    log("device memory after %s: %s" % (what, json.dumps(keep)))


# -- phase A: classic layout behind the HTTP server --------------------------


def _http(url: str, body: dict | None = None, timeout: float = 600.0):
    data = None
    headers = {}
    if body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        check(resp.status == 200, "%s: HTTP %d" % (url, resp.status))
        return json.loads(resp.read())


def phase_classic(workdir, n, m, seed, queries, planted, store, n_get=16):
    from urllib.parse import quote

    import jax

    from bigsi_tpu.http.server import make_server
    from bigsi_tpu.index import device_engine as de
    from bigsi_tpu.utils.devices import device_summary

    log("== phase A: classic layout, engine: device, HTTP server ==")
    cfg = index_config(workdir, "classic", {"layout": "classic"}, store, m)
    build_index(cfg, n, planted, seed)
    config = write_json_config(
        workdir, "classic", dict(cfg, engine="device")
    )
    server = make_server(config, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    log("serving on 127.0.0.1:%d; JAX devices: %s" % (port, device_summary()))
    try:
        t0 = time.perf_counter()
        engine = server.bigsi.engine  # opens the index, stages the matrix
        check(isinstance(engine, de.DeviceEngine), "engine is %r" % engine)
        engine.words.block_until_ready()
        check(engine.device.platform == jax.devices()[0].platform,
              "engine on %s" % engine.device.platform)
        log("set-up: index opened and staged in %.3f s"
            % (time.perf_counter() - t0))
        log_memory(engine.device, "staging the classic matrix")

        b, kb = N_QUERIES, de.bucket_size(1000 - K + 1)
        rng = np.random.default_rng(seed)
        idx = jax.device_put(
            rng.integers(0, m, size=(b, kb, H)).astype(np.int32),
            engine.device,
        )
        mask = jax.device_put(np.ones((b, kb), bool), engine.device)
        time_program(
            "_counts_batch_fat", de._counts_batch_fat,
            (engine.words, idx, mask), {"g": engine.g, "w": engine.w},
            bytes_read=b * kb * H * engine.words.shape[1] * 4
            + idx.nbytes + mask.nbytes,
        )

        base = "http://127.0.0.1:%d" % port
        gets = queries[:n_get]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(gets)) as pool:
            got = list(pool.map(
                lambda q: _http("%s/search?seq=%s&threshold=1.0"
                                % (base, quote(q)))["results"], gets))
        log("GET /search x%d (concurrent) in %.3f s"
            % (len(gets), time.perf_counter() - t0))
        compare("phase A GET /search t=1.0", got,
                oracle_results(config, gets, 1.0))
        fasta = os.path.join(workdir, "queries.fasta")
        with open(fasta, "w") as f:
            for i, q in enumerate(queries):
                f.write(">q%d\n%s\n" % (i, q))
        for t in THRESHOLDS:
            t0 = time.perf_counter()
            resp = _http(base + "/bulk_search",
                         {"fasta": fasta, "threshold": t})
            log("POST /bulk_search %d queries t=%.1f in %.3f s"
                % (len(queries), t, time.perf_counter() - t0))
            check([d["query"] for d in resp] == list(queries),
                  "bulk_search answered other queries")
            want = oracle_results(config, queries, t)
            compare("phase A POST /bulk_search t=%.1f" % t,
                    [d["results"] for d in resp], want)
            # queries 4i and 4i+1 are exact windows of planted genomes
            check(all(want[i] for i in range(len(queries)) if i % 4 < 2),
                  "an exact planted window found no sample")
    finally:
        server.shutdown()
        server.server_close()
        server.invalidate()
        thread.join(timeout=30)
        del server
        gc.collect()


# -- phase B: minimizer layout, on-device bytes-to-counts --------------------


def phase_minimizer(workdir, n, m, seed, queries, planted, store):
    import jax

    from bigsi_tpu.graph import BIGSI
    from bigsi_tpu.hashing.scheme import MINIMIZER_SEED, window_to_s
    from bigsi_tpu.index import device_engine as de
    from bigsi_tpu.index.host_engine import HostEngine, counts_batch_fallback
    from bigsi_tpu.kmers import seq_to_kmer_matrix, unique_rows_with_inverse
    from bigsi_tpu.ops.prep_jax import (
        prep_streams_device,
        prep_streams_host_oracle,
    )

    log("== phase B: minimizer layout, on-device bytes-to-counts ==")
    cfg = index_config(workdir, "minimizer", MINIMIZER, store, m)
    build_index(cfg, n, planted, seed + 1)
    config = write_json_config(
        workdir, "minimizer", dict(cfg, engine="device")
    )
    t0 = time.perf_counter()
    bigsi = BIGSI(config)
    engine = bigsi.engine
    log("set-up: index opened, staged and cols-packed in %.3f s"
        % (time.perf_counter() - t0))
    log_memory(engine.device, "staging the minimizer cols matrix")
    check(isinstance(engine, de.DeviceEngine), "engine is %r" % engine)
    check(engine.supports_seq_batch(),
          "engine does not support the on-device seq path")

    calls = []
    served = engine.counts_batch_seqs

    def recording(seqs, lens, k, h, num_cols):
        out = served(seqs, lens, k, h, num_cols)
        calls.append((seqs, lens, out))
        return out

    engine.counts_batch_seqs = recording
    for t in THRESHOLDS:
        calls.clear()
        t0 = time.perf_counter()
        got = bigsi.search_batch(queries, t)
        log("search_batch %d queries t=%.1f in %.3f s"
            % (len(queries), t, time.perf_counter() - t0))
        check(calls and all(c[2] is not None for c in calls),
              "t=%.1f: the batch left the on-device seq path "
              "(counts_batch_seqs returned %s)"
              % (t, [c[2] is not None for c in calls]))
        log("phase B t=%.1f: on-device seq path served %d dispatch(es)"
            % (t, len(calls)))
        compare("phase B search_batch t=%.1f" % t, got,
                oracle_results(config, queries, t))

    # streams: device prep vs the native host prep on the served bytes
    seqs, lens, _ = calls[0]
    s = window_to_s(K, engine.minimizer_window)
    window = K - s + 1
    padded, lens_b, lb, u_cap = de.seq_batch_geometry(seqs, lens, K, window)
    kw = dict(k=K, s=s, num_tiles=engine.matrix.num_rows // engine.tile_rows,
              h=H, tile_rows=engine.tile_rows, r=engine.run_len,
              seed=MINIMIZER_SEED)
    pd = jax.device_put(padded, engine.device)
    ld = jax.device_put(lens_b, engine.device)
    utile, gmask, n_valid, ok = jax.jit(
        prep_streams_device,
        static_argnames=tuple(kw) + ("u_cap",),
    )(pd, ld, u_cap=u_cap, **kw)
    check(bool(ok), "device prep overflowed its entry budget")
    b = len(lens)
    wu, wg, wn = prep_streams_host_oracle(padded[:b], lens_b[:b], **kw)
    du, dg, dn = (np.asarray(x)[:b] for x in (utile, gmask, n_valid))
    check(np.array_equal(dn, wn), "distinct k-mer counts differ")
    u = wu.shape[1]
    # a query with a repeated k-mer keeps a zeroed slot on the device and
    # skips it natively: streams agree exactly only for repeat-free ones
    nk = lens[:b] - K + 1
    clean = dn == nk
    check(np.array_equal(du[clean, :u], wu[clean])
          and np.array_equal(dg[clean, :u], wg[clean])
          and not du[clean, u:].any() and not dg[clean, u:].any(),
          "device streams differ from the native host prep")
    log("phase B streams: device prep == native host prep for %d of %d "
        "queries (%d repeat a k-mer); distinct counts equal for all"
        % (int(clean.sum()), b, b - int(clean.sum())))

    # the cols count program (host-prep path) against HostEngine
    mats = [unique_rows_with_inverse(seq_to_kmer_matrix(q, K))[0]
            for q in queries[:32]]
    kmax = max(x.shape[0] for x in mats)
    idx = np.zeros((len(mats), kmax, H), dtype=np.int64)
    mask = np.zeros((len(mats), kmax), dtype=bool)
    for i, x in enumerate(mats):
        idx[i, : x.shape[0]] = bigsi.kmer_matrix_to_row_idx(x)
        mask[i, : x.shape[0]] = True
    n_cols = bigsi.bitmatrix.num_cols
    dev_counts = engine.counts_batch(idx, mask, n_cols)
    host_counts = counts_batch_fallback(
        HostEngine(bigsi.bitmatrix), idx, mask, n_cols
    )
    check(np.array_equal(dev_counts, host_counts),
          "cols counts differ from HostEngine")
    log("phase B cols program: counts of %d queries x %d samples "
        "identical to HostEngine" % (len(mats), n_cols))

    itemsize = engine.cols.dtype.itemsize
    bb = padded.shape[0]
    time_program(
        "_counts_batch_cols", de._counts_batch_cols,
        (engine.cols, utile, gmask, n_valid), {},
        bytes_read=bb * u_cap * engine.cols.shape[1] * itemsize
        + utile.nbytes + gmask.nbytes,
    )
    time_program(
        "_counts_batch_seqs", de._counts_batch_seqs,
        (engine.cols, pd, ld), dict(kw, u_cap=u_cap),
        bytes_read=bb * u_cap * engine.cols.shape[1] * itemsize
        + padded.nbytes,
    )
    engine.counts_batch_seqs = served
    del bigsi, engine
    gc.collect()


# -- four cards: the sample-sharded mesh engine ----------------------------


def phase_mesh(workdir, n, m, seed, queries, planted, store, cards=4):
    from bigsi_tpu.graph import BIGSI
    from bigsi_tpu.parallel.sharding import MeshEngine
    from bigsi_tpu.storage import get_storage

    for name, layout in (("classic", {"layout": "classic"}),
                         ("minimizer", MINIMIZER)):
        log("== %d cards: %s layout, engine: mesh (1,1,%d) =="
            % (cards, name, cards))
        cfg = index_config(workdir, "mesh-" + name, layout, store, m)
        build_index(cfg, n, planted, seed + 2)
        config = dict(cfg, engine="mesh", mesh=[1, 1, cards])
        t0 = time.perf_counter()
        bigsi = BIGSI(config)
        engine = bigsi.engine
        check(isinstance(engine, MeshEngine), "engine is %r" % engine)
        engine.words.block_until_ready()
        log("set-up: index opened and sharded in %.3f s"
            % (time.perf_counter() - t0))
        arrays = [("words", engine.words)]
        calls = []
        if name == "minimizer":
            check(engine.supports_seq_batch(),
                  "mesh engine does not support the seq path")
            served = engine.counts_batch_seqs

            def recording(*a, _served=served):
                out = _served(*a)
                calls.append(out is not None)
                return out

            engine.counts_batch_seqs = recording
        for t in THRESHOLDS:
            t0 = time.perf_counter()
            got = bigsi.search_batch(queries, t)
            log("search_batch %d queries t=%.1f in %.3f s"
                % (len(queries), t, time.perf_counter() - t0))
            compare("%d cards %s t=%.1f" % (cards, name, t), got,
                    oracle_results(config, queries, t))
        t0 = time.perf_counter()
        bigsi.search_batch(queries, 1.0)
        log("search_batch %d queries t=1.0, warm repeat: %.3f s"
            % (len(queries), time.perf_counter() - t0))
        if name == "minimizer":
            check(calls and all(calls),
                  "the mesh batch left the on-device seq path")
            arrays.append(("cols", engine._cols))
        for label, arr in arrays:
            devs = arr.sharding.device_set
            check(len(devs) == cards, "%s on %d devices, want %d"
                  % (label, len(devs), cards))
            per = sorted(s.data.nbytes for s in arr.addressable_shards)
            log("%s sharded over %d devices (%s), %s bytes per shard"
                % (label, len(devs),
                   ", ".join(sorted(str(d) for d in devs)), per))
        for d in sorted(devs, key=lambda d: d.id):
            log_memory(d, "sharding (%s, device %d)" % (name, d.id))
        del bigsi, engine, arrays
        get_storage(config).delete_all()
        gc.collect()


# -- main -----------------------------------------------------------------


def fit_samples(n: int, m: int, cards: int, store: str, workdir: str) -> int:
    """Largest sample count <= n whose matrix fits the host (memory
    store: 0.6 of RAM) or the disk (0.8 of the free space), in whole
    multiples of 32 * cards; prints the cut and why."""
    if store == "disk":
        budget = int(0.8 * shutil.disk_usage(workdir).free)
        what = "free disk"
    else:
        ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        budget, what = int(0.6 * ram), "RAM"
    # one unit = one uint32 word per row on each card
    fit = budget // (m * 4 * cards) * 32 * cards
    if fit < n:
        log("cut: N=%d -> %d: a %d-sample matrix at m=%d needs %d bytes "
            "and the %s budget is %d bytes" % (
                n, fit, n, m, n // 32 * m * 4, what, budget))
        return fit
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        log("chip_smoke: JAX found %s devices and no GPU; refusing to run"
            % platform)
        return 2
    if len(devices) < args.cards:
        log("chip_smoke: --cards %d but JAX sees %d GPU(s)"
            % (args.cards, len(devices)))
        return 2

    from bigsi_tpu import native
    from bigsi_tpu.utils.devices import card_info, enable_compile_cache

    card = card_info()
    log(card)
    log("jax %s; devices: %s %s x%d" % (
        jax.__version__, platform, devices[0].device_kind, len(devices)))
    log("compile cache: %s" % (enable_compile_cache()
                               or os.environ["JAX_COMPILATION_CACHE_DIR"]))
    t0 = time.perf_counter()
    check(native.available(), "the native library did not build or load")
    log("set-up: native library ready in %.3f s" % (time.perf_counter() - t0))

    workdir = os.path.join(HERE, ".chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    store = "disk" if args.cards == 1 else "memory"
    n = fit_samples(SAMPLES_PER_CARD * args.cards, M, args.cards, store,
                    workdir)
    planted, queries = make_workload(args.seed, N_QUERIES, N_PLANTED)
    log("workload: N=%d samples, m=%d, k=%d, h=%d, %d queries of %d-%d bp,"
        " %d planted samples; store %s" % (
            n, M, K, H, len(queries), min(map(len, queries)),
            max(map(len, queries)), len(planted), store))
    t_start = time.perf_counter()
    try:
        if args.cards == 1:
            phase_classic(workdir, n, M, args.seed, queries, planted, store)
            shutil.rmtree(os.path.join(workdir, "classic"),
                          ignore_errors=True)
            phase_minimizer(workdir, n, M, args.seed, queries, planted,
                            store)
        else:
            phase_mesh(workdir, n, M, args.seed, queries, planted, store,
                       cards=args.cards)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("all phases passed in %.3f s" % (time.perf_counter() - t_start))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": args.cards,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
