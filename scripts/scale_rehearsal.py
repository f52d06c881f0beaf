#!/usr/bin/env python
"""Scale rehearsal: streamed build + query at >=100k samples.

BASELINE.md's 100k/450k configs need builds where the matrix never fits
in RAM as a dense array.  This script rehearses the full path at a
sliced m (VERDICT r1 item 3):

1. writes N .bloom files (a few *planted* from known sequences, the
   rest random bytes at the real Bloom load factor),
2. streamed build (``low_mem_build``): transpose chunks append straight
   to rows.bin (bigsi_tpu/matrix/bitmatrix.py:transpose_blooms_to_file),
   recording wall time and peak RSS,
3. reopens the index (mmap) and verifies every planted sequence is
   found exactly, and that a foreign sequence is not.

Query speed on the card at a deployment's width is chip_smoke.py's
job, not this script's.

Usage:
  python scripts/scale_rehearsal.py OUTDIR --samples 100000 --m 1000000
"""

import argparse
import json
import os
import resource
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bigsi_tpu.graph import BIGSI
from bigsi_tpu.kmers import seq_to_kmers


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--samples", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=1_000_000)
    ap.add_argument("--h", type=int, default=3)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--planted", type=int, default=4)
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    n, m = args.samples, args.m
    out = {"samples": n, "m": m, "h": args.h}
    blooms_dir = os.path.join(args.outdir, "blooms")
    os.makedirs(blooms_dir, exist_ok=True)

    cfg = {
        "k": args.k, "m": m, "h": args.h,
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": os.path.join(args.outdir, "index")},
        "low_mem_build": True,
    }

    # -- 1. bloom files ---------------------------------------------------
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    planted = {}
    paths, names = [], []
    from bigsi_tpu.matrix.packing import bools_to_bloom_bytes

    nbytes = (m + 7) // 8
    for i in range(n):
        p = os.path.join(blooms_dir, "s%06d.bloom" % i)
        if i < args.planted:
            seq = "".join(rng.choice(list("ACGT"), size=200))
            planted["s%06d" % i] = seq
            bits = np.asarray(BIGSI.bloom(cfg, seq_to_kmers(seq, args.k)))
            with open(p, "wb") as f:
                f.write(bools_to_bloom_bytes(bits))
        elif args.density == 0.5:
            # fast path: uniform random bytes (density 0.5) — the
            # build-path cost is identical to real blooms
            with open(p, "wb") as f:
                f.write(rng.bytes(nbytes))
        else:
            raw = rng.random(nbytes * 8) < args.density
            with open(p, "wb") as f:
                f.write(np.packbits(raw[: nbytes * 8]).tobytes())
        paths.append(p)
        names.append("s%06d" % i)
    out["bloom_write_s"] = round(time.perf_counter() - t0, 1)
    out["bloom_bytes_total"] = nbytes * n
    print("blooms written: %.1fs, %.1f GB" % (
        out["bloom_write_s"], nbytes * n / 1e9), file=sys.stderr, flush=True)

    # -- 2. streamed build --------------------------------------------------
    from bigsi_tpu.cmds import build as build_cmd

    rss_before = rss_gb()
    t0 = time.perf_counter()
    build_cmd(cfg, paths, names)
    out["build_s"] = round(time.perf_counter() - t0, 1)
    out["peak_rss_gb"] = round(rss_gb(), 2)
    out["rows_bin_gb"] = round(
        os.path.getsize(os.path.join(args.outdir, "index", "rows.bin")) / 1e9, 2
    )
    print("streamed build: %.1fs, peak RSS %.2f GB (before: %.2f), rows.bin %.2f GB"
          % (out["build_s"], out["peak_rss_gb"], rss_before,
             out["rows_bin_gb"]), file=sys.stderr, flush=True)

    # -- 3. search parity ---------------------------------------------------
    idx = BIGSI(cfg)
    t0 = time.perf_counter()
    ok = True
    for name, seq in planted.items():
        hits = {r["sample_name"] for r in idx.search(seq)}
        ok &= name in hits
    foreign = "".join(np.random.default_rng(99).choice(list("ACGT"), size=200))
    foreign_hits = idx.search(foreign)
    out["planted_found"] = bool(ok)
    out["foreign_hits"] = len(foreign_hits)
    out["search_s_per_query"] = round(
        (time.perf_counter() - t0) / max(1, len(planted) + 1), 2
    )
    print("planted found: %s, foreign hits: %d, %.2f s/query (numpy engine, mmap)"
          % (ok, len(foreign_hits), out["search_s_per_query"]),
          file=sys.stderr, flush=True)

    print(json.dumps(out))
    if not args.keep:
        shutil.rmtree(blooms_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
