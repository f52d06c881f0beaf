"""Multi-host distribution: jax.distributed init, query broadcast,
host-0 assembly.

The reference's multi-machine story is a shared Redis server that many
stateless query processes hit over TCP (``bigsi/storage/redis.py:8-49``
— the index lives in one place, clients bring queries to it).  The
accelerator inversion (SURVEY §5.8): the index column-shards across the
memory of every host's devices (one global ``samples`` axis), queries
enter at host 0, broadcast to all hosts over the network
(``multihost_utils.broadcast_one_to_all``), every host executes the
same sharded query step (collectives ride NVLink within a host, the
network across), and the replicated result is read off host 0.

Emulation without hardware: ``initialize()`` with a localhost
coordinator + ``JAX_PLATFORMS=cpu`` + gloo collectives gives N
processes x M virtual CPU devices — the same code path a multi-host
fleet runs (tests/test_distributed.py runs 2x2).

Worker protocol (host 0 = frontend, others = workers running
``run_worker_loop``): each dispatch broadcasts a small int32 header
``(op, rows)`` then the padded query arrays; OP_STOP ends the loop.
Compiled steps are cached per padded shape bucket, so workers and host
0 stay in lockstep executing identical programs.
"""

from __future__ import annotations

import logging
import os

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bigsi_tpu.parallel.sharding import (
    AXIS_BATCH,
    AXIS_KMERS,
    AXIS_ROWS,
    AXIS_SAMPLES,
    factor_devices,
    make_mesh,
    make_rowsharded_grouped_step,
    make_sharded_grouped_step,
    make_sharded_query_step,
)

logger = logging.getLogger(__name__)

OP_QUERY = 1
OP_STOP = 0
OP_PRESENCE = 2
OP_GROUPED = 3
OP_SEQS = 4  # raw query bytes; prep runs ON DEVICE (ops/prep_jax.py)


_COORDINATOR = None  # "host:port" captured by initialize()


def _send_msg(sock, obj) -> None:
    import pickle
    import struct

    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(data)) + data)


def _recv_msg(sock):
    import pickle
    import struct

    def recvn(n):
        buf = bytearray()
        while len(buf) < n:
            part = sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("control-plane peer closed")
            buf.extend(part)
        return bytes(buf)

    (n,) = struct.unpack("<Q", recvn(8))
    return pickle.loads(recvn(n))


def _control_endpoint():
    """(host, port) of the TCP control plane, derived from the
    coordinator address (port + 1000) unless overridden via
    BIGSI_TPU_CONTROL_PORT.  None disables (BIGSI_TPU_NO_CONTROL_PLANE
    or no known coordinator)."""
    if os.environ.get("BIGSI_TPU_NO_CONTROL_PLANE"):
        return None
    coord = _COORDINATOR or os.environ.get("BIGSI_TPU_COORDINATOR")
    if not coord or ":" not in coord:
        return None
    host, port = coord.rsplit(":", 1)
    try:
        port = int(os.environ.get("BIGSI_TPU_CONTROL_PORT", int(port) + 1000))
    except ValueError:
        return None
    return host, port


class _ControlPlane:
    """Host-0 side of the TCP control plane (VERDICT r4 next-6, second
    round): pushes each dispatch's header+payload to every worker and
    receives their result shards back over plain sockets, so the only
    collective left per dispatch is the compiled step's own in-program
    one.  This is the shape real pod frontends take — RPC for
    control/data distribution, XLA collectives inside the program —
    and on the gloo loopback emulation it removes the 3 x ~3.4 ms
    host-level legs entirely."""

    def __init__(self, endpoint, n_workers: int):
        import socket
        import threading

        self.n_workers = n_workers
        self.socks = []
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("0.0.0.0", endpoint[1]))
        self._srv.listen(n_workers)

        def accept_loop():
            while len(self.socks) < n_workers:
                try:
                    sock, _ = self._srv.accept()
                except OSError:
                    return
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
                hello = _recv_msg(sock)
                assert hello.get("hello") is not None
                with self._lock:
                    self.socks.append(sock)

        t = threading.Thread(target=accept_loop, daemon=True)
        t.start()

    def wait_ready(self, timeout: float = 60.0) -> bool:
        import time as _t

        deadline = _t.monotonic() + timeout
        while _t.monotonic() < deadline:
            if len(self.socks) >= self.n_workers:
                return True
            _t.sleep(0.01)
        return False

    def send_all(self, msg) -> None:
        for sock in self.socks:
            _send_msg(sock, msg)

    def close(self) -> None:
        for sock in self.socks:
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._srv.close()
        except OSError:
            pass


def _connect_control(endpoint, retry_s: float = 15.0):
    """Worker side: connect to host 0's control plane, or None."""
    import socket
    import time as _t

    deadline = _t.monotonic() + retry_s
    while _t.monotonic() < deadline:
        try:
            sock = socket.create_connection(endpoint, timeout=2.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_msg(sock, {"hello": jax.process_index()})
            return sock
        except OSError:
            _t.sleep(0.2)
    return None


def _split_buffer(buf: np.ndarray, specs):
    """Slice one uint8 buffer back into arrays of ``specs``
    [(shape, dtype), ...]."""
    outs, off = [], 0
    for sh, dt in specs:
        nb = int(np.prod(sh)) * np.dtype(dt).itemsize
        outs.append(buf[off : off + nb].view(dt).reshape(sh))
        off += nb
    return outs


def _bcast_arrays(arrays):
    """Host 0: broadcast several arrays as ONE uint8 buffer.

    Each ``broadcast_one_to_all`` is a full collective round trip, so a
    dispatch that sent header + index + mask as three legs paid the
    conversation cost three times; one coalesced payload pays it once
    (scripts/distributed_serving_bench.py measures the dispatch).
    """
    from jax.experimental import multihost_utils

    buf = np.concatenate(
        [
            np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            for a in arrays
        ]
    )
    out = np.asarray(multihost_utils.broadcast_one_to_all(buf))
    return _split_buffer(out, [(a.shape, a.dtype) for a in arrays])


def _recv_arrays(specs):
    """Worker side of :func:`_bcast_arrays`: same buffer shape, zeros."""
    from jax.experimental import multihost_utils

    total = sum(
        int(np.prod(sh)) * np.dtype(dt).itemsize for sh, dt in specs
    )
    out = np.asarray(
        multihost_utils.broadcast_one_to_all(np.zeros(total, np.uint8))
    )
    return _split_buffer(out, specs)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """``jax.distributed.initialize`` with env fallbacks.

    Env: ``BIGSI_TPU_COORDINATOR``, ``BIGSI_TPU_NUM_PROCESSES``,
    ``BIGSI_TPU_PROCESS_ID``.  On the CPU backend the gloo collectives
    implementation is selected automatically (required for
    cross-process CPU collectives).  Several processes on one host each
    take their own local card (:func:`local_device_ids`): a JAX process
    otherwise reserves most of EVERY card's memory at start, and the
    second process on the host fails for want of it.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "BIGSI_TPU_COORDINATOR"
    )
    if num_processes is None and os.environ.get("BIGSI_TPU_NUM_PROCESSES"):
        num_processes = int(os.environ["BIGSI_TPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("BIGSI_TPU_PROCESS_ID"):
        process_id = int(os.environ["BIGSI_TPU_PROCESS_ID"])
    global _COORDINATOR
    _COORDINATOR = coordinator_address
    if jax.config.jax_platforms == "cpu" or (
        os.environ.get("JAX_PLATFORMS") == "cpu"
    ):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids(
            coordinator_address, num_processes, process_id
        ),
    )
    logger.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        len(jax.local_devices()),
        len(jax.devices()),
    )


def local_device_ids(coordinator_address, num_processes, process_id):
    """The local card a process pins itself to, or None for all.

    A loopback coordinator means every process runs on this host, so
    process ``i`` takes card ``i``.  Other fleets (one process per host)
    keep every local card.  ``JAX_LOCAL_DEVICE_IDS``, which JAX reads
    itself, wins; so does the CPU backend, whose virtual devices are
    not cards.
    """
    if os.environ.get("JAX_LOCAL_DEVICE_IDS"):
        return None
    if not num_processes or num_processes < 2 or process_id is None:
        return None
    from bigsi_tpu.utils.devices import cpu_requested

    if cpu_requested():
        return None
    host = (coordinator_address or "").rsplit(":", 1)[0].strip("[]")
    if host in ("localhost", "::1") or host.startswith("127."):
        return [int(process_id)]
    return None


def make_global_mesh(axis_sizes=None):
    """Mesh over ALL processes' devices.  The sample axis spans hosts
    (each host's HBM holds a column shard of the matrix); query-batch
    and k-mer axes stay host-local by putting ``s`` outermost."""
    devices = jax.devices()
    n = len(devices)
    if axis_sizes is None:
        d, k, s = factor_devices(n)
    else:
        d, k, s = axis_sizes
    devices = _spread_subset(devices, d * k * s)
    # s outermost: consecutive (host-ordered) devices differ along d/k
    # first, so d/k collectives stay intra-host where possible
    arr = np.array(devices).reshape(s, d, k).transpose(1, 2, 0)
    return make_mesh(axis_sizes=(d, k, s), devices=arr.reshape(-1))


def _spread_subset(devices, need: int):
    """Pick ``need`` devices spread evenly over processes (a mesh using
    a device subset must still span every host, or its shards would
    concentrate on one process)."""
    if need >= len(devices):
        return devices
    nproc = jax.process_count()
    if need % nproc != 0:
        # A silent devices[:need] fallback concentrates the sub-mesh on
        # the first host(s); processes left without mesh devices then
        # crash in _local_word_slice.  Make the impossibility loud.
        raise ValueError(
            "mesh needs %d devices but %d processes cannot split them "
            "evenly (%d %% %d != 0); pick axis sizes whose product is a "
            "multiple of the process count" % (need, nproc, need, nproc)
        )
    per = need // nproc
    by_proc = {}
    for dev in devices:
        by_proc.setdefault(dev.process_index, []).append(dev)
    picked = []
    for p in sorted(by_proc):
        if len(by_proc[p]) < per:
            raise ValueError(
                "process %d holds %d devices but an even spread needs %d "
                "per process" % (p, len(by_proc[p]), per)
            )
        picked.extend(by_proc[p][:per])
    if len(picked) != need:
        raise ValueError(
            "even spread picked %d devices (need %d): devices span %d "
            "process(es) but process_count() is %d"
            % (len(picked), need, len(by_proc), nproc)
        )
    return picked


def make_global_row_mesh(axis_sizes):
    """Global (d, r, s) mesh for ROW-sharded tile indexes: the sample
    axis spans hosts first, then the tile-slab axis ``r`` — so indexes
    larger than one HOST's memory split across hosts by rows as well as
    samples (SURVEY §7.4's 450k x m=2.5e7 = 313 GB case)."""
    from bigsi_tpu.parallel.sharding import make_row_mesh

    devices = _spread_subset(jax.devices(), axis_sizes[0] * axis_sizes[1] * axis_sizes[2])
    d, r, s = axis_sizes
    # r outermost across the (process-ordered) device list: each host
    # holds a contiguous TILE SLAB (x its sample columns), so the
    # per-host footprint is m/r x W/s words
    arr = np.array(devices).reshape(r, s, d).transpose(2, 0, 1)
    return make_row_mesh((d, r, s), devices=arr.reshape(-1))


def distribute_words(words_global: np.ndarray | None, mesh, *, m: int, w: int):
    """Place the packed matrix P(None, s) across processes.

    Each process contributes ONLY its own column shard
    (``jax.make_array_from_process_local_data``), so no host ever holds
    the full matrix in RAM — the requirement for 450k-sample indexes.
    ``words_global`` may be the full matrix (typically an mmap of
    rows.bin: each process copies out ONLY its own columns — the dense
    ``[m, w_pad]`` array is never allocated) or already just the local
    shard (shape ``[m, local_w]``).  Returns (global jax.Array,
    local host shard) — the local shard feeds the tile-layout paths.
    """
    sharding = NamedSharding(mesh, P(None, AXIS_SAMPLES))
    s = mesh.shape[AXIS_SAMPLES]
    w_pad = -(-w // s) * s
    shard_w = w_pad // s
    if words_global is not None and words_global.shape[1] == w:
        local = _local_word_slice(words_global, mesh, shard_w, w)
    else:
        local = np.ascontiguousarray(words_global, dtype=np.uint32)
    garr = jax.make_array_from_process_local_data(
        sharding, local, global_shape=(m, w_pad)
    )
    return garr, local


def _local_word_slice(words, mesh, shard_w, w):
    """Copy out the word columns owned by this process's devices —
    zero-padding only the (at most one) shard that crosses the true
    width ``w``.  Never materializes the padded full matrix."""
    mine = []
    seen = set()
    m = words.shape[0]
    for idx, dev in np.ndenumerate(mesh.devices):
        if dev.process_index != jax.process_index():
            continue
        s_coord = idx[_axis_pos(mesh, AXIS_SAMPLES)]
        if s_coord in seen:
            continue  # replicated across d/k: contribute each shard once
        seen.add(s_coord)
        c0, c1 = s_coord * shard_w, (s_coord + 1) * shard_w
        if c1 <= w:
            mine.append(np.ascontiguousarray(words[:, c0:c1]))
        else:
            block = np.zeros((m, shard_w), dtype=np.uint32)
            if c0 < w:
                block[:, : w - c0] = words[:, c0:w]
            mine.append(block)
    if not mine:
        raise RuntimeError(
            "process %d owns no devices in this mesh — the mesh must "
            "span every participating host (see _spread_subset)"
            % jax.process_index()
        )
    return np.concatenate(mine, axis=1)


class DistributedQueryService:
    """Host-0 dispatch + worker lockstep execution of the sharded step.

    All processes construct it identically (matrix, mesh, buckets);
    host 0 then calls :meth:`query`, workers run :meth:`run_worker_loop`.
    The per-dispatch header carries (op, B, K, h) so workers compile the
    same step for the same shapes without knowing h up front.
    """

    def __init__(self, words, mesh, *, m: int, num_samples: int,
                 bucket=(8, 64), h: int | None = None, layout="classic",
                 tile_rows: int = 32, run_len: int | None = None,
                 row_shards: int = 1, minimizer_window: int | None = None,
                 slot_scheme: int = 1):
        self.mesh = mesh
        self.m = m
        self.h = h  # optional hint; steps are cached per h regardless
        self.num_samples = num_samples
        self.bucket = bucket
        self.layout = layout
        self.tile_rows = tile_rows
        self.run_len = run_len
        self.row_shards = row_shards
        self.minimizer_window = minimizer_window
        self.slot_scheme = slot_scheme
        self._seqs = None  # lazy (cols3, gmesh, db); steps in _seq_steps
        self._seq_steps = {}
        if words is None:
            raise ValueError(
                "DistributedQueryService needs the matrix source on "
                "EVERY process (typically the rows.bin mmap — "
                "distribute_words copies out only this process's "
                "column shard); workers cannot pass None"
            )
        self._words_src = words  # matrix source (mmap ok; row slabs)
        self.words, self._local_words = distribute_words(
            np.asarray(words), mesh, m=m, w=words.shape[1],
        )
        self._steps = {}
        self._presence_steps = {}
        self._put_cache = {}
        self._grouped = None  # lazy (step, tiles3, batch_axis) triple
        # HTTP serving is threaded; one broadcast conversation at a time
        import threading

        self._lock = threading.Lock()
        # TCP control plane (host 0 binds now; workers connect when
        # run_worker_loop starts; dispatches fall back to the gloo legs
        # if it never comes up)
        self._ctrl = None
        self._ctrl_ready = False
        self._wsock = None
        endpoint = _control_endpoint()
        if endpoint is not None and jax.process_count() > 1:
            if jax.process_index() == 0:
                try:
                    self._ctrl = _ControlPlane(
                        endpoint, jax.process_count() - 1
                    )
                except OSError as e:
                    logger.warning("control plane bind failed: %s", e)
                    self._ctrl = None

    def _ctrl_ok(self) -> bool:
        """True when every worker is connected to the control plane
        (first dispatch waits for the fleet; later calls are free)."""
        if self._ctrl is None:
            return False
        if not self._ctrl_ready:
            self._ctrl_ready = self._ctrl.wait_ready()
            if not self._ctrl_ready:
                logger.warning(
                    "control plane: workers never connected; using the "
                    "gloo broadcast legs"
                )
                self._ctrl.close()
                self._ctrl = None
                return False
        return True

    def _finish(self, arr):
        """Assemble a sharded step output as a full numpy array on
        host 0.  Control-plane mode: host fills its own addressable
        shards and receives the workers' (index, data) shard lists —
        one socket message per worker per dispatch; workers send theirs
        and return None.  Legacy mode: replicating process_allgather on
        every process."""
        if self._wsock is not None:
            _send_msg(
                self._wsock,
                [
                    (s.index, np.asarray(s.data))
                    for s in arr.addressable_shards
                ],
            )
            return None
        if self._ctrl is not None and self._ctrl_ready:
            full = np.empty(arr.shape, dtype=arr.dtype)
            for s in arr.addressable_shards:
                full[s.index] = np.asarray(s.data)
            for sock in self._ctrl.socks:
                for idx, data in _recv_msg(sock):
                    full[idx] = data
            return full
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))

    def _step(self, h: int):
        if h not in self._steps:
            base = make_sharded_query_step(self.mesh, h)

            # pack (counts int[B, W*32], exact uint32[B, W]) into ONE
            # [B, W*32 + W] array: result assembly becomes a single
            # process_allgather leg (the exact words bitcast losslessly
            # into the count dtype)
            def packed(words, idx, mask):
                counts, exact = base(words, idx, mask)
                ex = jax.lax.bitcast_convert_type(exact, counts.dtype)
                return jnp.concatenate([counts, ex], axis=1)

            self._steps[h] = jax.jit(packed)
        return self._steps[h]

    def _presence_step(self, h: int):
        """Sharded per-kmer presence rows (scoring path): idx int32[K, h]
        replicated -> packed uint32[K, W] (gather+AND on each device's
        column shard, all_gather over ``s``)."""
        if h not in self._presence_steps:
            from bigsi_tpu.ops.lookup import and_rows_jnp

            def local(words_l, idx_l):
                packed = and_rows_jnp(words_l, idx_l)
                return jax.lax.all_gather(
                    packed, AXIS_SAMPLES, axis=1, tiled=True
                )

            step = jax.shard_map(
                local,
                mesh=self.mesh,
                in_specs=(P(None, AXIS_SAMPLES), P(None, None)),
                out_specs=P(None, None),
                check_vma=False,
            )
            self._presence_steps[h] = jax.jit(step)
        return self._presence_steps[h]

    # -- grouped (minimizer tile-dedup) path -------------------------------

    def _grouped_setup(self):
        """Lazy tile-major matrix + grouped step over all processes.

        row_shards == 1: (d*k, 1, s) mesh, each process contributes the
        tile-major view of its COLUMN shard (derived from the local
        words — the full matrix is never assembled).  row_shards > 1:
        (d*k, r, s) mesh with r outermost across hosts — each process
        cuts its tile SLAB rows straight from the matrix source (mmap
        row slices), so per-host residency is m/r x W/s words.
        """
        if self._grouped is not None:
            return self._grouped
        d, k, s = (
            self.mesh.shape[AXIS_BATCH],
            self.mesh.shape[AXIS_KMERS],
            self.mesh.shape[AXIS_SAMPLES],
        )
        tr = self.tile_rows
        t = -(-self.m // tr)
        w_pad = self.words.shape[1]
        if self.row_shards > 1:
            rmesh = make_global_row_mesh((d * k, self.row_shards, s))
            rr = self.row_shards
            tp = -(-t // rr) * rr
            slab = tp // rr
            shard_w = w_pad // s
            my = [
                idx
                for idx, dev in np.ndenumerate(rmesh.devices)
                if dev.process_index == jax.process_index()
            ]
            r_coords = sorted({idx[1] for idx in my})
            s_coords = sorted({idx[2] for idx in my})
            blocks = []
            for c in r_coords:
                m0 = c * slab * tr
                m1 = min((c + 1) * slab * tr, self.m)
                block = np.zeros((slab * tr, w_pad), dtype=np.uint32)
                if m1 > m0:
                    rows = np.asarray(
                        self._words_src[m0:m1], dtype=np.uint32
                    )
                    block[: m1 - m0, : rows.shape[1]] = rows
                cols = np.concatenate(
                    [
                        block[:, sc * shard_w : (sc + 1) * shard_w]
                        for sc in s_coords
                    ],
                    axis=1,
                )
                blocks.append(
                    cols.reshape(slab, tr, len(s_coords) * shard_w)
                )
            local = np.ascontiguousarray(np.concatenate(blocks, axis=0))
            sharding = NamedSharding(
                rmesh, P(AXIS_ROWS, None, AXIS_SAMPLES)
            )
            tiles3 = jax.make_array_from_process_local_data(
                sharding, local, global_shape=(tp, tr, w_pad)
            )
            step = make_rowsharded_grouped_step(rmesh, tr)
            self._grouped = (step, tiles3, rmesh.shape[AXIS_BATCH])
        else:
            gmesh = make_global_mesh((d * k, 1, s))
            lw = self._local_words
            m_pad = t * tr
            if m_pad != self.m:
                grown = np.zeros((m_pad, lw.shape[1]), dtype=np.uint32)
                grown[: self.m] = lw
                lw = grown
            local = np.ascontiguousarray(
                lw.reshape(t, tr, lw.shape[1])
            )
            sharding = NamedSharding(gmesh, P(None, None, AXIS_SAMPLES))
            tiles3 = jax.make_array_from_process_local_data(
                sharding, local, global_shape=(t, tr, w_pad)
            )
            step = make_sharded_grouped_step(gmesh, tr)
            self._grouped = (step, tiles3, gmesh.shape[AXIS_BATCH])
        return self._grouped

    def _run_grouped(self, utile: np.ndarray, gmask: np.ndarray):
        step, tiles3, db = self._grouped_setup()
        mesh = tiles3.sharding.mesh
        sh_u = NamedSharding(mesh, P(AXIS_BATCH, None))
        sh_g = NamedSharding(mesh, P(AXIS_BATCH, None, None))
        u_g = jax.make_array_from_process_local_data(
            sh_u, _slice_for_process(utile, mesh, (AXIS_BATCH,))
        )
        g_g = jax.make_array_from_process_local_data(
            sh_g, _slice_for_process(gmask, mesh, (AXIS_BATCH,))
        )
        return self._finish(step(tiles3, u_g, g_g))

    def query_grouped(self, utile: np.ndarray, gmask: np.ndarray):
        """Host-0 dispatch of a grouped (minimizer) batch: utile
        int32[B, U], gmask uint32[B, U, R] -> counts int64[B, N_pad].
        U must already be bucketed (build_grouped_streams does)."""
        from jax.experimental import multihost_utils

        b, u = utile.shape
        r = gmask.shape[2]
        _, _, db = self._grouped_setup()
        bb = max(self.bucket[0], db)
        while bb < b:
            bb *= 2
        bb = -(-bb // db) * db
        pu = np.zeros((bb, u), dtype=np.int32)
        pg = np.zeros((bb, u, r), dtype=np.uint32)
        pu[:b] = utile
        pg[:b] = gmask
        with self._lock:
            if self._ctrl_ok():
                self._ctrl.send_all({"op": OP_GROUPED, "arrays": [pu, pg]})
            else:
                hdr = np.array([OP_GROUPED, bb, u, r], np.int32)
                multihost_utils.broadcast_one_to_all(hdr)
                pu, pg = _bcast_arrays([pu, pg])
            counts = self._run_grouped(pu, pg)
        return counts[:b]

    # -- bytes-to-counts (on-device prep) path ----------------------------

    def supports_seq_batch(self) -> bool:
        """The OP_SEQS path: minimizer/v3 cols layout, single row
        shard, power-of-two tile height, device-mod-able tile count."""
        from bigsi_tpu.ops.lookup import cols_dtype

        num_tiles = max(1, self.m // self.tile_rows)
        return (
            self.layout == "minimizer"
            and self.slot_scheme == 3
            and self.row_shards == 1
            and self.tile_rows & (self.tile_rows - 1) == 0
            and cols_dtype(self.tile_rows) is not None
            and num_tiles < (1 << 28)
        )

    def _seqs_setup(self):
        """Lazy sample-sharded cols layout for the seq step: each
        process packs ONLY its local column shard (pack_tile_cols_host
        of the words it already holds — the dense cols matrix is never
        assembled on any host)."""
        if self._seqs is not None:
            return self._seqs
        from bigsi_tpu.ops.lookup import pack_tile_cols_host

        d, k, s = (
            self.mesh.shape[AXIS_BATCH],
            self.mesh.shape[AXIS_KMERS],
            self.mesh.shape[AXIS_SAMPLES],
        )
        gmesh = make_global_mesh((d * k, 1, s))
        local_cols = pack_tile_cols_host(self._local_words, self.tile_rows)
        t = local_cols.shape[0]
        n_pad = self.words.shape[1] * 32
        sharding = NamedSharding(gmesh, P(None, AXIS_SAMPLES))
        cols3 = jax.make_array_from_process_local_data(
            sharding, local_cols, global_shape=(t, n_pad)
        )
        self._seqs = (cols3, gmesh, gmesh.shape[AXIS_BATCH])
        return self._seqs

    def _seq_step(self, k: int, h: int, lb: int):
        key = (k, h, lb)
        if key not in self._seq_steps:
            from bigsi_tpu.hashing.scheme import (
                MINIMIZER_SEED,
                default_minimizer_s,
                window_to_s,
            )
            from bigsi_tpu.index.device_engine import DeviceEngine
            from bigsi_tpu.ops.lookup import GROUP_R
            from bigsi_tpu.parallel.sharding import make_sharded_seq_step

            _, gmesh, _ = self._seqs_setup()
            s_mer = (
                window_to_s(k, self.minimizer_window)
                or default_minimizer_s(k)
            )
            window = k - s_mer + 1
            base = make_sharded_seq_step(
                gmesh,
                k=k, s=s_mer, num_tiles=max(1, self.m // self.tile_rows),
                h=h, tile_rows=self.tile_rows,
                r=self.run_len or GROUP_R,
                u_cap=DeviceEngine._seq_u_cap(lb - k + 1, window),
                seed=MINIMIZER_SEED,
            )

            # pack (counts, n_valid, ok) into ONE [B, N+2] array so the
            # host-level result assembly is a single process_allgather
            # leg instead of three (n_valid <= NK < 2^15 fits any count
            # dtype; ok reduces on device)
            def packed(cols, q, l):
                counts, n_valid, ok = base(cols, q, l)
                okcol = jnp.broadcast_to(
                    jnp.all(ok).astype(counts.dtype),
                    (counts.shape[0], 1),
                )
                return jnp.concatenate(
                    [counts, n_valid[:, None].astype(counts.dtype), okcol],
                    axis=1,
                )

            self._seq_steps[key] = jax.jit(packed)
        return self._seq_steps[key]

    def _run_seqs(self, seqs: np.ndarray, lens: np.ndarray, k: int, h: int):
        cols3, gmesh, db = self._seqs_setup()
        step = self._seq_step(k, h, seqs.shape[1])
        sh_q = NamedSharding(gmesh, P(AXIS_BATCH, None))
        sh_l = NamedSharding(gmesh, P(AXIS_BATCH))
        q_g = jax.make_array_from_process_local_data(
            sh_q, _slice_for_process(seqs, gmesh, (AXIS_BATCH,))
        )
        l_g = jax.make_array_from_process_local_data(
            sh_l, _slice_for_process(lens, gmesh, (AXIS_BATCH,))
        )
        out = self._finish(step(cols3, q_g, l_g))
        if out is None:
            return None  # worker: result shards already sent
        return (
            np.ascontiguousarray(out[:, :-2]),
            out[:, -2].astype(np.int32),
            bool(out[:, -1].all()),
        )

    def query_seqs(self, seqs: np.ndarray, lens: np.ndarray, k: int, h: int):
        """Host-0 dispatch: padded query BYTES uint8[B, L] + lens ->
        (counts int64[B, N_pad], n_valid int32[B]) or None on device
        entry-budget overflow (caller re-runs via a host-prep path —
        workers stay in lockstep either way).  The broadcast payload is
        B*L bytes (~60 KB at the serving config) instead of the grouped
        streams' ~7 MB."""
        from jax.experimental import multihost_utils

        b, l = seqs.shape
        _, _, db = self._seqs_setup()
        bb = max(self.bucket[0], db)
        while bb < b:
            bb *= 2
        bb = -(-bb // db) * db
        pq = np.full((bb, l), ord("A"), dtype=np.uint8)
        pq[:b] = seqs
        pl = np.zeros(bb, dtype=np.int32)
        pl[:b] = lens
        with self._lock:
            if self._ctrl_ok():
                self._ctrl.send_all(
                    {"op": OP_SEQS, "k": k, "h": h, "arrays": [pq, pl]}
                )
            else:
                hdr = np.array([OP_SEQS, bb, l, (k << 8) | h], np.int32)
                multihost_utils.broadcast_one_to_all(hdr)
                pq, pl = _bcast_arrays([pq, pl])
            counts, n_valid, ok = self._run_seqs(pq, pl, k, h)
        if not ok:
            return None
        return counts[:b].astype(np.int64), n_valid[:b]

    # -- shape bucketing -------------------------------------------------

    def _pad(self, idx: np.ndarray, mask: np.ndarray):
        b, k, h = idx.shape
        d = self.mesh.shape[AXIS_BATCH]
        kk = self.mesh.shape[AXIS_KMERS]
        bb = max(self.bucket[0], -(-b // d) * d)
        kb = max(self.bucket[1], -(-k // kk) * kk)
        pidx = np.zeros((bb, kb, h), dtype=np.int32)
        pmask = np.zeros((bb, kb), dtype=bool)
        pidx[:b, :k] = idx
        pmask[:b, :k] = mask
        return pidx, pmask

    def _run(self, pidx: np.ndarray, pmask: np.ndarray):
        from jax.experimental import multihost_utils

        sh_idx = NamedSharding(self.mesh, P(AXIS_BATCH, AXIS_KMERS, None))
        sh_mask = NamedSharding(self.mesh, P(AXIS_BATCH, AXIS_KMERS))
        idx_g = jax.make_array_from_process_local_data(
            sh_idx, _slice_for_process(pidx, self.mesh, (AXIS_BATCH, AXIS_KMERS))
        )
        mask_g = jax.make_array_from_process_local_data(
            sh_mask, _slice_for_process(pmask, self.mesh, (AXIS_BATCH, AXIS_KMERS))
        )
        out = self._finish(self._step(pidx.shape[2])(self.words, idx_g, mask_g))
        if out is None:
            return None, None  # worker: result shards already sent
        w = self.words.shape[1]
        counts = np.ascontiguousarray(out[:, : w * 32])
        exact = np.ascontiguousarray(out[:, w * 32 :]).view(np.uint32)
        return counts, exact

    # -- host 0 ----------------------------------------------------------

    def query(self, idx: np.ndarray, mask: np.ndarray):
        """Dispatch one padded query batch from host 0: broadcast the
        shapes + arrays, run the step everywhere, assemble locally."""
        from jax.experimental import multihost_utils

        b, k, h = idx.shape
        with self._lock:
            pidx, pmask = self._pad(idx, mask)
            if self._ctrl_ok():
                self._ctrl.send_all(
                    {"op": OP_QUERY, "arrays": [pidx, pmask]}
                )
            else:
                hdr = np.array(
                    [OP_QUERY, pidx.shape[0], pidx.shape[1], h], np.int32
                )
                multihost_utils.broadcast_one_to_all(hdr)
                pidx, pmask = _bcast_arrays([pidx, pmask])
            counts, exact = self._run(pidx, pmask)
        return counts[:b], exact[:b]

    def presence(self, idx: np.ndarray) -> np.ndarray:
        """Per-kmer packed presence rows from host 0 (scoring path):
        idx int [K, h] -> uint32 [K, W]."""
        from jax.experimental import multihost_utils

        k, h = idx.shape
        # pow2 buckets so distinct query lengths reuse a handful of
        # compiled sharded programs (matches _pad's behavior)
        kb = self.bucket[1]
        while kb < k:
            kb *= 2
        pidx = np.zeros((kb, h), dtype=np.int32)
        pidx[:k] = idx
        with self._lock:
            if self._ctrl_ok():
                self._ctrl.send_all({"op": OP_PRESENCE, "arrays": [pidx]})
            else:
                hdr = np.array([OP_PRESENCE, kb, 0, h], np.int32)
                multihost_utils.broadcast_one_to_all(hdr)
                pidx = np.asarray(
                    multihost_utils.broadcast_one_to_all(pidx)
                )
            rows = self._run_presence(pidx)
        return rows[:k]

    def _run_presence(self, pidx: np.ndarray) -> np.ndarray:
        sh = NamedSharding(self.mesh, P(None, None))
        idx_g = jax.make_array_from_process_local_data(sh, pidx)
        rows = self._presence_step(pidx.shape[1])(self.words, idx_g)
        # out_specs P(None, None): fully replicated — every process can
        # read the whole result locally
        return np.asarray(rows)

    def stop(self) -> None:
        # _ctrl_ok (not _ctrl_ready) so a stop BEFORE any dispatch
        # still routes over the sockets the workers are listening on —
        # a gloo stop would strand connected workers in _recv_msg
        if self._ctrl is not None and self._ctrl_ok():
            self._ctrl.send_all({"op": OP_STOP})
            self._ctrl.close()
            return
        from jax.experimental import multihost_utils

        multihost_utils.broadcast_one_to_all(
            np.array([OP_STOP, 0, 0, 0], np.int32)
        )

    # -- workers -----------------------------------------------------------

    def run_worker_loop(self) -> None:
        """Lockstep execution on processes > 0: receive each dispatch
        from host 0 (TCP control plane when available, gloo broadcast
        legs otherwise), run the identical step, repeat until OP_STOP."""
        endpoint = _control_endpoint()
        if endpoint is not None:
            sock = _connect_control(endpoint)
            if sock is not None:
                self._wsock = sock
                try:
                    self._worker_loop_ctrl(sock)
                finally:
                    self._wsock = None
                    try:
                        sock.close()
                    except OSError:
                        pass
                return
            logger.warning(
                "control plane: could not reach host 0 at %s:%d; "
                "falling back to the gloo broadcast legs", *endpoint
            )
        self._worker_loop_gloo()

    def _worker_loop_ctrl(self, sock) -> None:
        while True:
            msg = _recv_msg(sock)
            op = msg["op"]
            if op == OP_STOP:
                return
            a = msg["arrays"]
            if op == OP_GROUPED:
                self._run_grouped(a[0], a[1])
            elif op == OP_SEQS:
                self._run_seqs(a[0], a[1], msg["k"], msg["h"])
            elif op == OP_PRESENCE:
                self._run_presence(a[0])
            else:
                self._run(a[0], a[1])

    def _worker_loop_gloo(self) -> None:
        from jax.experimental import multihost_utils

        while True:
            hdr = np.asarray(
                multihost_utils.broadcast_one_to_all(
                    np.zeros(4, np.int32)
                )
            )
            if hdr[0] == OP_STOP:
                return
            bb, kb, h = int(hdr[1]), int(hdr[2]), int(hdr[3])
            if hdr[0] == OP_GROUPED:
                pu, pg = _recv_arrays(
                    [((bb, kb), np.int32), ((bb, kb, h), np.uint32)]
                )
                self._run_grouped(pu, pg)
                continue
            if hdr[0] == OP_SEQS:
                # bb, kb=L, h packs (k << 8) | h
                kk, hh = int(hdr[3]) >> 8, int(hdr[3]) & 0xFF
                pq, pl = _recv_arrays(
                    [((bb, kb), np.uint8), ((bb,), np.int32)]
                )
                self._run_seqs(pq, pl, kk, hh)
                continue
            if hdr[0] == OP_PRESENCE:
                pidx = np.asarray(
                    multihost_utils.broadcast_one_to_all(
                        np.zeros((bb, h), np.int32)
                    )
                )
                self._run_presence(pidx)
                continue
            pidx, pmask = _recv_arrays(
                [((bb, kb, h), np.int32), ((bb, kb), bool)]
            )
            self._run(pidx, pmask)


def _slice_for_process(arr: np.ndarray, mesh, axes) -> np.ndarray:
    """This process's block of an array sharded over ``axes`` (leading
    dims of ``arr`` in order)."""
    out = arr
    for dim, axis in enumerate(axes):
        n = mesh.shape[axis]
        coords = sorted(
            {
                idx[_axis_pos(mesh, axis)]
                for idx, dev in np.ndenumerate(mesh.devices)
                if dev.process_index == jax.process_index()
            }
        )
        size = arr.shape[dim] // n
        blocks = [
            np.take(out, range(c * size, (c + 1) * size), axis=dim)
            for c in coords
        ]
        out = np.concatenate(blocks, axis=dim)
    return out


def _axis_pos(mesh, axis) -> int:
    return list(mesh.axis_names).index(axis)


class DistributedEngine:
    """Engine with the HostEngine surface, backed by the multi-process
    :class:`DistributedQueryService` — the ``engine: distributed`` story
    (``serve --distributed``).

    Every process constructs it identically when opening the index
    (collective: distributes the matrix across all hosts' devices).
    Host 0 then serves queries; other processes call
    :meth:`run_worker_loop` and execute the same programs in lockstep.
    Maps the reference's Redis shared-index role
    (``bigsi/storage/redis.py:8-15``) with the index IN the accelerator
    fleet instead of a KV server.
    """

    def __init__(self, matrix, axis_sizes=None, bucket=(8, 64),
                 layout="classic", tile_rows: int = 32,
                 minimizer_window: int | None = None, row_shards: int = 1,
                 run_len: int | None = None, slot_scheme: int = 1):
        words = np.asarray(matrix.words)  # mmap passes through un-copied
        self.num_cols = matrix.num_cols
        self.layout = layout
        self.tile_rows = tile_rows
        if run_len is None and layout == "minimizer":
            from bigsi_tpu.hashing.scheme import default_run_len

            run_len = default_run_len(minimizer_window)
        mesh = make_global_mesh(axis_sizes)
        self.service = DistributedQueryService(
            words, mesh, m=words.shape[0], num_samples=matrix.num_cols,
            bucket=bucket, layout=layout, tile_rows=tile_rows,
            run_len=run_len,
            row_shards=row_shards, minimizer_window=minimizer_window,
            slot_scheme=slot_scheme,
        )

    # -- serving lifecycle -------------------------------------------------

    def run_worker_loop(self) -> None:
        self.service.run_worker_loop()

    def stop(self) -> None:
        self.service.stop()

    # -- batched surface (search_batch / bulk_search) -----------------------

    def counts_batch(
        self, row_idx: np.ndarray, mask: np.ndarray, num_cols: int
    ) -> np.ndarray:
        b, k = row_idx.shape[:2]
        if b == 0 or k == 0:
            return np.zeros((b, num_cols), dtype=np.int64)
        if self.layout in ("blocked", "minimizer"):
            # tile-dedup path (mirrors MeshEngine.counts_batch): each
            # distinct tile gathered once; row shards supported
            from bigsi_tpu.ops.lookup import GROUP_R, build_grouped_streams

            tr = self.tile_rows
            tile = (row_idx[:, :, 0] // tr).astype(np.int32)
            sm = np.where(
                mask,
                np.bitwise_or.reduce(
                    np.uint32(1) << (row_idx % tr).astype(np.uint32), axis=2
                ),
                np.uint32(0),
            )
            utile, gmask = build_grouped_streams(
                tile, sm, r=self.service.run_len or GROUP_R
            )
            counts = self.service.query_grouped(utile, gmask)
            return counts[:, :num_cols].astype(np.int64)
        counts, _ = self.service.query(row_idx.astype(np.int32), mask)
        return counts[:, :num_cols].astype(np.int64)

    def supports_seq_batch(self) -> bool:
        return self.service.supports_seq_batch()

    def counts_batch_seqs(
        self, seqs: np.ndarray, lens: np.ndarray, k: int, h: int,
        num_cols: int,
    ):
        """Bytes-to-counts over the fleet (OP_SEQS): hosts broadcast
        padded query bytes, every process runs the on-device prep +
        sample-sharded count in lockstep.  Same contract as
        DeviceEngine.counts_batch_seqs (None = fall back)."""
        b, l = seqs.shape
        if b == 0:
            return (
                np.zeros((0, num_cols), dtype=np.int64),
                np.zeros(0, dtype=np.int32),
            )
        from bigsi_tpu.hashing.scheme import (
            default_minimizer_s,
            window_to_s,
        )
        from bigsi_tpu.index.device_engine import seq_batch_geometry

        s_mer = (
            window_to_s(k, self.service.minimizer_window)
            or default_minimizer_s(k)
        )
        # shared bucketing/guards (every engine uses the same rules —
        # a fresh padded length here is a fleet-wide XLA compile);
        # query_seqs rounds the batch to the mesh's own multiple
        geom = seq_batch_geometry(seqs, lens, k, k - s_mer + 1)
        if geom is None:
            return None
        padded, lens_b, _lb, _u_cap = geom
        out = self.service.query_seqs(padded, lens_b, k, h)
        if out is None:
            return None
        counts, n_valid = out
        return counts[:, :num_cols], n_valid

    # -- HostEngine-compatible single-query surface --------------------------

    def and_rows(self, row_idx: np.ndarray):
        return _DistributedQuery(self, row_idx)

    def exact_colours(self, packed) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty(0, dtype=np.int64)
        _, exact = packed.result()
        bits = np.unpackbits(exact[0].view(np.uint8), bitorder="little")
        return np.flatnonzero(bits).astype(np.int64)

    def counts(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.zeros(num_cols, dtype=np.int64)
        counts, _ = packed.result()
        return counts[0, :num_cols].astype(np.int64)

    def presence_matrix(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty((0, num_cols), dtype=np.uint8)
        rows = self.service.presence(np.asarray(packed.row_idx))
        bits = np.unpackbits(rows.view(np.uint8), axis=-1, bitorder="little")
        return bits[:, :num_cols]


class _DistributedQuery:
    def __init__(self, engine: DistributedEngine, row_idx: np.ndarray):
        self.engine = engine
        self.row_idx = row_idx
        self._result = None

    def result(self):
        if self._result is None:
            idx = np.asarray(self.row_idx, dtype=np.int32)[None]
            mask = np.ones((1, idx.shape[1]), dtype=bool)
            self._result = self.engine.service.query(idx, mask)
        return self._result
