#!/usr/bin/env python
"""Synthetic index generator for the BASELINE scale configs.

Builds an on-disk bigsi-tpu index (manifest + rows.bin) with N samples
and m bloom bits WITHOUT materializing per-sample blooms: bitslice rows
are drawn at the Bloom-filter load factor (see bigsi_tpu/synth.py), and
a handful of *planted* samples carry the real blooms of known random
genomes so queries have ground truth to hit.

Usage:
  python scripts/synth_index.py OUTDIR --samples 1024 --m 25000000 \
      [--h 3] [--kmers-per-sample 3900000] [--planted 4] \
      [--layout classic] [--seed 0]

Writes OUTDIR/{manifest.json,rows.bin} plus OUTDIR/planted.json with
the planted sample names and their genomes.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bigsi_tpu.synth import random_genome, write_index  # noqa: E402

PLANTED_GENOME_LENGTH = 2000  # bp; room for gene-length query windows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--m", type=int, default=25_000_000)
    ap.add_argument("--h", type=int, default=3)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--kmers-per-sample", type=int, default=3_900_000)
    ap.add_argument("--planted", type=int, default=4)
    ap.add_argument("--layout", default="classic",
                    choices=["classic", "blocked", "minimizer"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    density = 1.0 - np.exp(-args.h * args.kmers_per_sample / args.m)
    rng = np.random.default_rng(args.seed)
    planted = {
        "planted%d" % i: random_genome(rng, PLANTED_GENOME_LENGTH)
        for i in range(min(args.planted, args.samples))
    }
    config = {
        "storage-engine": "bigsi-tpu",
        "storage-config": {"filename": args.outdir},
        "k": args.k, "m": args.m, "h": args.h, "layout": args.layout,
    }
    summary = write_index(
        config, args.samples, planted, seed=args.seed, density=density
    )
    with open(os.path.join(args.outdir, "planted.json"), "w") as f:
        json.dump(planted, f, indent=2)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
