"""Emulated distributed-serving saturation benchmark.

Drives the production distributed query path (DistributedEngine over a
jax.distributed gloo mesh, the same code a multi-host fleet runs) at saturation
from host 0 and records queries/s at 1, 2 and 4 processes, plus a
WEAK-SCALING efficiency figure: each process holds an equal column
shard (samples scale with the fleet), so perfect scaling keeps
queries/s flat while total indexed samples grow linearly.

EMULATION CAVEATS (read before quoting the numbers): processes run on
ONE host, collectives go through the gloo CPU backend, and "devices"
are virtual CPU devices — so the absolute qps is meaningless and the
efficiency figure is a LOWER BOUND methodology anchor: on a fleet of
cards the per-dispatch overhead rides NVLink or network collectives
instead of loopback gloo while the per-shard compute runs on the cards.
The BASELINE >= 0.8 scaling-efficiency target needs real hardware; this
script pins the measurement method.

Run: python scripts/distributed_serving_bench.py [--batches 12]
Writes a JSON summary line; record results in docs/SCALE.md.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER_TPL = r"""
import os, sys, time, json
import numpy as np

process_id = int(sys.argv[1]); num_processes = int(sys.argv[2])
coord = sys.argv[3]; local_devices = int(sys.argv[4])
batches = int(sys.argv[5]); b, k, h = 64, 128, 3
m, n_per_proc = 200_000, 64

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=%d" % local_devices)
os.environ["BIGSI_TPU_COORDINATOR"] = coord
os.environ["BIGSI_TPU_NUM_PROCESSES"] = str(num_processes)
os.environ["BIGSI_TPU_PROCESS_ID"] = str(process_id)
sys.path.insert(0, "@REPO@")
import jax
jax.config.update("jax_platforms", "cpu")

from bigsi_tpu.parallel import distributed as D

D.initialize()
mesh = D.make_global_mesh()
n_total = n_per_proc * num_processes
w = (n_total + 31) // 32
rng = np.random.default_rng(0)
# every process passes the matrix source (deterministic here; in
# production it is the shared rows.bin mmap) — distribute_words copies
# out only this process's column shard
words = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint32)
svc = D.DistributedQueryService(words, mesh, m=m, num_samples=n_total,
                                bucket=(b, k))
if process_id != 0:
    svc.run_worker_loop()
    sys.exit(0)

idx = rng.integers(0, m, size=(b, k, h)).astype(np.int64)
mask = np.ones((b, k), dtype=bool)
svc.query(idx, mask)  # warm/compile
t0 = time.perf_counter()
for i in range(batches):
    svc.query((idx + i) % m, mask)
dt = time.perf_counter() - t0
svc.stop()
print(json.dumps({"qps": batches * b / dt,
                  "ms_per_batch": dt / batches * 1e3,
                  "n_total": n_total}))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def run_fleet(nproc: int, batches: int):
    coord = "127.0.0.1:%d" % _free_port()
    script = WORKER_TPL.replace("@REPO@", REPO)
    procs = []
    for pid in range(nproc):
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", script, str(pid), str(nproc),
                 coord, "2", str(batches)],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    out0, err0 = procs[0].communicate(timeout=600)
    for p in procs[1:]:
        p.communicate(timeout=120)
    if procs[0].returncode != 0:
        sys.stderr.write(err0[-2000:])
        raise RuntimeError("fleet of %d failed" % nproc)
    line = [ln for ln in out0.splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=12)
    args = ap.parse_args()
    results = {}
    for nproc in (1, 2, 4):
        t0 = time.time()
        r = run_fleet(nproc, args.batches)
        r["wall_s"] = round(time.time() - t0, 1)
        results[nproc] = r
        print(
            "%d proc: %.0f q/s (%.1f ms/batch, %d samples indexed, "
            "%.0fs wall)"
            % (nproc, r["qps"], r["ms_per_batch"], r["n_total"],
               r["wall_s"]),
            file=sys.stderr,
        )
    eff2 = results[2]["qps"] / results[1]["qps"]
    eff4 = results[4]["qps"] / results[1]["qps"]
    print(
        json.dumps(
            {
                "metric": "distributed_serving_weak_scaling",
                "mode": "CPU gloo emulation (one 2-vCPU host)",
                "qps": {str(n): round(r["qps"], 1)
                        for n, r in results.items()},
                "weak_scaling_efficiency": {
                    "2": round(eff2, 3),
                    "4": round(eff4, 3),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
