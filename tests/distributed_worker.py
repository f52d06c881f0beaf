"""Subprocess entry for the multi-process distributed test.

Each process (host) runs this symmetric program:
  * initialize jax.distributed against a localhost coordinator,
  * build its column shard of a deterministic matrix,
  * host 0 dispatches query batches and prints results as JSON;
    workers run the lockstep loop.

Invoked by tests/test_distributed.py; also a usage model for real
multi-host deployment (swap the CPU emulation env for GPU hosts).
"""

import json
import os
import sys


def main():
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    port = sys.argv[3]
    local_devices = int(sys.argv[4])
    row_shards = int(sys.argv[5]) if len(sys.argv) > 5 else 1

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=%d" % local_devices
    )
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from bigsi_tpu.parallel.distributed import (
        DistributedQueryService,
        initialize,
        make_global_mesh,
    )

    initialize(
        coordinator_address="127.0.0.1:%s" % port,
        num_processes=num_processes,
        process_id=process_id,
    )
    n_global = len(jax.devices())
    assert n_global == num_processes * local_devices

    # deterministic matrix: every process derives the same full matrix
    # and contributes only its own columns
    m, n_samples, h = 4096, 96, 3
    w = -(-n_samples // 32)
    rng = np.random.default_rng(42)
    words = rng.integers(0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(
        np.uint32
    )

    # base mesh: with row shards the grouped row mesh needs d*k x r x s
    # devices, so shrink the batch axis accordingly
    d_axis = 2 if row_shards == 1 else 1
    mesh = make_global_mesh(axis_sizes=(d_axis, 1, n_global // 2))
    service = DistributedQueryService(
        words, mesh, m=m, h=h, num_samples=n_samples,
        layout="minimizer", tile_rows=16, row_shards=row_shards,
        slot_scheme=3,
    )

    if process_id == 0:
        qrng = np.random.default_rng(7)
        for b, k in ((4, 32), (2, 48)):
            idx = qrng.integers(0, m, size=(b, k, h)).astype(np.int32)
            mask = qrng.random((b, k)) < 0.9
            counts, exact = service.query(idx, mask)
            print(
                json.dumps(
                    {
                        "b": b,
                        "k": k,
                        "counts_sum": int(counts.sum()),
                        "counts_head": counts[0, :8].tolist(),
                        "exact_head": exact[0, :2].tolist(),
                        "idx_digest": int(idx.sum()),
                        "mask_digest": int(mask.sum()),
                    }
                ),
                flush=True,
            )
        # grouped (minimizer tile-dedup) dispatch, row-shard aware:
        # tile-coherent row indices (runs of 3 k-mers share a 16-row
        # tile), streams built exactly as DistributedEngine.counts_batch
        from bigsi_tpu.ops.lookup import build_grouped_streams

        tr = 16
        grng = np.random.default_rng(11)
        gb, gk = 3, 36
        tile = np.repeat(
            grng.integers(0, m // tr, size=(gb, gk // 3)), 3, axis=1
        )[:, :gk].astype(np.int64)
        slots = grng.integers(0, tr, size=(gb, gk, h)).astype(np.int64)
        gidx = tile[:, :, None] * tr + slots
        gmask_q = grng.random((gb, gk)) < 0.9
        sm = np.where(
            gmask_q,
            np.bitwise_or.reduce(
                np.uint32(1) << slots.astype(np.uint32), axis=2
            ),
            np.uint32(0),
        )
        utile, gm = build_grouped_streams(tile.astype(np.int32), sm)
        counts = service.query_grouped(utile, gm)
        print(
            json.dumps(
                {
                    "grouped_counts_sum": int(counts.sum()),
                    "grouped_head": counts[0, :8].tolist(),
                    "grouped_idx_digest": int(gidx.sum()),
                    "row_shards": row_shards,
                }
            ),
            flush=True,
        )
        # bytes-to-counts dispatch (OP_SEQS, round 4): broadcast RAW
        # query bytes; prep runs on device in lockstep on every process
        if row_shards == 1:
            assert service.supports_seq_batch()
            srng = np.random.default_rng(5)
            sb, sl = 4, 80 + 31 - 1
            seqs = np.frombuffer(b"ACGT", dtype=np.uint8)[
                srng.integers(0, 4, size=(sb, sl))
            ]
            lens = np.full(sb, sl, dtype=np.int32)
            out = service.query_seqs(seqs, lens, 31, h)
            assert out is not None, "seq-step entry budget overflow"
            scounts, snv = out
            print(
                json.dumps(
                    {
                        "seq_counts_sum": int(scounts.sum()),
                        "seq_head": scounts[0, :8].tolist(),
                        "seq_nv": snv.tolist(),
                        "seq_digest": int(seqs.sum()),
                    }
                ),
                flush=True,
            )

        # dispatch-overhead measurement (VERDICT r2 weak 8): steady-state
        # ms per broadcast-conversation round trip at a cached shape —
        # the per-query DCN cost the docs cite (CPU/gloo emulation)
        import time

        idx = qrng.integers(0, m, size=(4, 32, h)).astype(np.int32)
        msk = np.ones((4, 32), dtype=bool)
        service.query(idx, msk)  # warm the compiled step
        t0 = time.perf_counter()
        reps = 10
        for _ in range(reps):
            service.query(idx, msk)
        per = (time.perf_counter() - t0) / reps * 1e3
        print(json.dumps({"dispatch_ms": round(per, 2)}), flush=True)
        service.stop()
    else:
        service.run_worker_loop()
    print("PROC_OK %d" % process_id, flush=True)


if __name__ == "__main__":
    main()
