"""Multi-chip sharding of the signature index.

The reference's only scale-out story is a network KV store shared by
stateless clients (Redis, ``bigsi/storage/redis.py``) plus per-process
``multiprocessing`` bulk search (``bigsi/__main__.py:276-283``).  Here
scale-out is a ``jax.sharding.Mesh`` with three axes (SURVEY.md §2.3):

* ``d`` — **query-batch data parallel**: queries split across devices;
* ``k`` — **k-mer parallel** (the sequence/context-parallel analogue,
  SURVEY.md §5.7): one query's k-mer set splits across devices, partial
  hit counts merge with ``psum``;
* ``s`` — **sample parallel** (the tensor-parallel analogue): the
  packed matrix column-shards over devices, each holding
  ``uint32[m, W/|s|]`` in HBM; per-shard counts concatenate with
  ``all_gather``.

All collectives are XLA-native and ride ICI.  The query step is one
``shard_map``-ed jitted function; the same code runs on the 8-device
CPU test mesh and on pod slices.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bigsi_tpu.ops.lookup import and_rows_jnp

AXIS_BATCH = "d"
AXIS_KMERS = "k"
AXIS_SAMPLES = "s"


def factor_devices(n: int) -> tuple[int, int, int]:
    """Factor n devices into (d, k, s) mesh axis sizes.

    Sample sharding gets the largest factor (the matrix is the big
    operand), then batch, then k-mer parallelism.
    """
    best = (1, 1, n)
    # enumerate factorizations d*k*s = n, prefer s >= d >= k
    for d in range(1, n + 1):
        if n % d:
            continue
        rest = n // d
        for k in range(1, rest + 1):
            if rest % k:
                continue
            s = rest // k
            cand = (d, k, s)
            # score: maximize s, then d
            if (s, d, k) > (best[2], best[0], best[1]):
                best = cand
    return best


def make_mesh(n_devices: int | None = None, axis_sizes=None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_devices or len(devices)
    if axis_sizes is None:
        axis_sizes = factor_devices(n)
    d, k, s = axis_sizes
    if d * k * s > n:
        raise ValueError(
            "mesh axes %r need %d devices but only %d are available"
            % (axis_sizes, d * k * s, n)
        )
    # axes may multiply to FEWER than available: a config pinning a
    # small mesh (e.g. [1, 1, 2] on an 8-chip host) uses a device subset
    arr = np.array(devices[: d * k * s]).reshape(d, k, s)
    return Mesh(arr, (AXIS_BATCH, AXIS_KMERS, AXIS_SAMPLES))


def pad_words_for_mesh(words: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Zero-pad the word axis so it splits evenly over the sample axis.

    Padding columns are the zero phantom samples the layout already
    carries (lane padding) — they never produce hits.
    """
    s = mesh.shape[AXIS_SAMPLES]
    w = words.shape[1]
    target = math.ceil(w / s) * s
    if target == w:
        return words
    out = np.zeros((words.shape[0], target), dtype=np.uint32)
    out[:, :w] = words
    return out


def shard_matrix(words: np.ndarray, mesh: Mesh) -> jax.Array:
    """Place the packed matrix with rows replicated over (d, k) and the
    word axis sharded over ``s`` — each device holds its column shard
    in HBM."""
    words = pad_words_for_mesh(words, mesh)
    sharding = NamedSharding(mesh, P(None, AXIS_SAMPLES))
    return jax.device_put(words, sharding)


def make_sharded_query_step(mesh: Mesh, h: int):
    """Build the jitted multi-chip batched query step.

    step(words, row_idx, mask) with:
      words   uint32[m, W]      sharded P(None, s)
      row_idx int32[B, K, h]    sharded P(d, k, None)
      mask    bool[B, K]        sharded P(d, k)
    returns (counts int32[B, W*32], exact uint32[B, W]) sharded P(d, None).

    Per device: gather+AND over its column shard for its query and
    k-mer slice; counts psum over ``k`` and all_gather over ``s``;
    exact filter all_gathers the (small) per-kmer-shard AND vectors
    over ``k`` (AND has no ring collective) then concatenates over
    ``s``.
    """

    def local_step(words_l, idx_l, mask_l):
        b, kk, _ = idx_l.shape
        packed = and_rows_jnp(words_l, idx_l.reshape(b * kk, h))
        packed = packed.reshape(b, kk, -1)  # [B_l, K_l, W_l]

        # hit counts: masked carry-save popcount over local kmers
        from bigsi_tpu.ops.lookup import csa_counts

        masked_rows = jnp.where(mask_l[:, :, None], packed, jnp.uint32(0))
        counts_l = csa_counts(masked_rows, axis=1)  # [B_l, W_l*32]
        counts_l = jax.lax.psum(counts_l, AXIS_KMERS)
        counts = jax.lax.all_gather(
            counts_l, AXIS_SAMPLES, axis=1, tiled=True
        )  # [B_l, W*32]

        # exact filter: AND over local kmers, combine over the k axis by
        # gathering the per-shard AND vectors (W_l words are small)
        ones = jnp.uint32(0xFFFFFFFF)
        masked = jnp.where(mask_l[:, :, None], packed, ones)
        exact_l = jax.lax.reduce(masked, ones, jax.lax.bitwise_and, (1,))  # [B_l, W_l]
        exact_k = jax.lax.all_gather(exact_l, AXIS_KMERS, axis=0)  # [|k|, B_l, W_l]
        exact_l = jax.lax.reduce(exact_k, ones, jax.lax.bitwise_and, (0,))
        exact = jax.lax.all_gather(exact_l, AXIS_SAMPLES, axis=1, tiled=True)
        return counts, exact

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(None, AXIS_SAMPLES),
            P(AXIS_BATCH, AXIS_KMERS, None),
            P(AXIS_BATCH, AXIS_KMERS),
        ),
        out_specs=(P(AXIS_BATCH, None), P(AXIS_BATCH, None)),
        check_vma=False,
    )
    return jax.jit(step)


def shard_tiles(tiles: np.ndarray, mesh: Mesh, tile_rows: int = 32) -> jax.Array:
    """Place a tile-major matrix uint32[T, tile_rows*W] with the WORD
    axis sharded over ``s``: reshaped to [T, tile_rows, W] so each
    device holds its sample-column shard of every tile."""
    t, fat = tiles.shape
    w = fat // tile_rows
    arr = tiles.reshape(t, tile_rows, w)
    s = mesh.shape[AXIS_SAMPLES]
    if w % s:
        target = math.ceil(w / s) * s
        grown = np.zeros((t, tile_rows, target), dtype=np.uint32)
        grown[:, :, :w] = arr
        arr = grown
    return jax.device_put(arr, NamedSharding(mesh, P(None, None, AXIS_SAMPLES)))


def make_sharded_grouped_step(mesh: Mesh, tile_rows: int = 32):
    """Multi-chip grouped (minimizer tile-dedup) batched counts.

    step(tiles3, utile, gmask) with tiles3 uint32[T, 32, W] sharded
    P(None, None, s), utile int32[B, U] / gmask uint32[B, U, R] sharded
    P(d, None(, None)) -> counts int32[B, W*32] sharded P(d, None).

    Each device gathers each distinct tile's LOCAL sample columns once,
    expands to per-kmer presence with dense masked ANDs, reduces with
    the carry-save popcount, and all_gathers counts over ``s``.  The
    ``k`` axis is unused (grouped streams don't split along k-mers);
    build meshes as (d, 1, s) for this step.
    """
    if mesh.shape[AXIS_KMERS] != 1:
        raise ValueError("grouped step requires a (d, 1, s) mesh")

    from bigsi_tpu.ops.lookup import grouped_counts

    def local_step(tiles_l, utile_l, gmask_l):
        t, tr, w_l = tiles_l.shape
        counts_l = grouped_counts(
            tiles_l.reshape(t, tr * w_l), utile_l, gmask_l, tile_rows
        )
        return jax.lax.all_gather(counts_l, AXIS_SAMPLES, axis=1, tiled=True)

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(None, None, AXIS_SAMPLES),
            P(AXIS_BATCH, None),
            P(AXIS_BATCH, None, None),
        ),
        out_specs=P(AXIS_BATCH, None),
        check_vma=False,
    )
    return jax.jit(step)


def shard_cols(cols: np.ndarray, mesh: Mesh) -> jax.Array:
    """Place a column-major tile matrix uintX[T, N] with the SAMPLE axis
    sharded over ``s`` (each device holds its samples' tile columns).
    N is zero-padded to a multiple of |s| (phantom samples never hit)."""
    t, n = cols.shape
    s = mesh.shape[AXIS_SAMPLES]
    n_pad = math.ceil(n / s) * s
    if n_pad != n:
        grown = np.zeros((t, n_pad), dtype=cols.dtype)
        grown[:, :n] = cols
        cols = grown
    return jax.device_put(cols, NamedSharding(mesh, P(None, AXIS_SAMPLES)))


def pack_cols_sharded(words: jax.Array, mesh: Mesh, tile_rows: int):
    """Sample-sharded cols layout derived ON the devices.

    ``words`` is the row-major matrix sharded by :func:`shard_matrix`
    (word axis over ``s``).  A device's words hold exactly its samples'
    bits, so each packs its own tile columns (ops/lookup.py:
    pack_tile_cols) and nothing crosses devices.  The result is
    ``shard_cols(pack_tile_cols_host(...))`` without the host pass, which
    at a deployment's size is tens of GB of numpy bit shuffling.
    """
    from bigsi_tpu.ops.lookup import pack_tile_cols

    def local(w):
        m, wl = w.shape
        t = -(-m // tile_rows)
        if t * tile_rows != m:
            w = jnp.pad(w, ((0, t * tile_rows - m), (0, 0)))
        return pack_tile_cols(w.reshape(t, tile_rows * wl), tile_rows)

    return jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=P(None, AXIS_SAMPLES),
            out_specs=P(None, AXIS_SAMPLES), check_vma=False,
        )
    )(words)


def make_sharded_cols_step(mesh: Mesh):
    """Multi-chip column-major (cols) minimizer counts — the fastest
    single-chip formulation (ops/lookup.py:grouped_counts_cols), sample
    axis sharded.

    step(cols, utile, gmask, n_valid) with cols uintX[T, N] sharded
    P(None, s); utile int32[B, U] / gmask [B, U, R] / n_valid int32[B]
    sharded P(d, ...) -> counts int32[B, N] sharded P(d, None).  Each
    device compares against its own sample columns and the per-shard
    counts concatenate with all_gather over ``s`` — no cross-device
    reduction is needed (samples partition cleanly).
    """
    if mesh.shape[AXIS_KMERS] != 1:
        raise ValueError("cols step requires a (d, 1, s) mesh")

    from bigsi_tpu.ops.lookup import grouped_counts_cols

    def local_step(cols_l, utile_l, gmask_l, n_valid_l):
        counts_l = grouped_counts_cols(cols_l, utile_l, gmask_l, n_valid_l)
        return jax.lax.all_gather(counts_l, AXIS_SAMPLES, axis=1, tiled=True)

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(None, AXIS_SAMPLES),
            P(AXIS_BATCH, None),
            P(AXIS_BATCH, None, None),
            P(AXIS_BATCH),
        ),
        out_specs=P(AXIS_BATCH, None),
        check_vma=False,
    )
    return jax.jit(step)


def make_sharded_seq_step(
    mesh: Mesh, *, k: int, s: int, num_tiles: int, h: int,
    tile_rows: int, r: int, u_cap: int, seed: int = 0x5EED5EED,
):
    """Multi-chip ONE-program serving: raw query bytes -> counts.

    The round-4 serving design on a mesh: the on-device prep
    (ops/prep_jax.py — packing, splitmix64 minimizers, distinct-kmer
    dedup, run grouping) runs once per batch shard (replicated across
    the sample axis: it is O(B*K) VPU work, ~free next to the count
    kernel), each device counts against its own sample columns, and the
    per-shard counts concatenate with all_gather over ``s``.  Hosts
    ship ONLY padded bytes — the multi-chip story needs no host prep
    and no cross-host stream distribution.

    step(cols, seqs, lens) with cols uintX[T, N] sharded P(None, s),
    seqs uint8[B, L] / lens int32[B] sharded P(d, ...) ->
    (counts int32[B, N] P(d, None), n_valid int32[B] P(d),
    ok bool[n_d] — all() it on the host; False = entry-budget
    overflow, re-run the batch on a host path).
    """
    if mesh.shape[AXIS_KMERS] != 1:
        raise ValueError("seq step requires a (d, 1, s) mesh")

    from bigsi_tpu.ops.lookup import grouped_counts_cols
    from bigsi_tpu.ops.prep_jax import prep_streams_device

    def local_step(cols_l, seqs_l, lens_l):
        utile, gmask, n_valid, ok = prep_streams_device(
            seqs_l, lens_l, k=k, s=s, num_tiles=num_tiles, h=h,
            tile_rows=tile_rows, r=r, u_cap=u_cap, seed=seed,
        )
        counts_l = grouped_counts_cols(cols_l, utile, gmask, n_valid)
        gathered = jax.lax.all_gather(
            counts_l, AXIS_SAMPLES, axis=1, tiled=True
        )
        return gathered, n_valid, ok.reshape(1)

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(None, AXIS_SAMPLES),
            P(AXIS_BATCH, None),
            P(AXIS_BATCH),
        ),
        out_specs=(P(AXIS_BATCH, None), P(AXIS_BATCH), P(AXIS_BATCH)),
        check_vma=False,
    )
    return jax.jit(step)


AXIS_ROWS = "r"


def make_row_mesh(axis_sizes, devices=None) -> Mesh:
    """Mesh with axes (d, r, s) for ROW-sharded tile indexes.

    ``r`` shards the tile axis: each device holds a contiguous slab of
    tiles, so indexes larger than one chip's HBM span devices by rows
    as well as samples (an N-sample, m-bit index is uint32[m, W] ≈
    m·W/8·r·s per device).  Only the blocked/minimizer layouts support
    this: they colocate a k-mer's h rows in ONE tile by construction,
    so a k-mer's whole lookup lands on a single row shard and partial
    counts merge with one ``psum``.  (Classic spreads a k-mer's rows
    anywhere in [0, m) — its scale-out axes remain d/k/s.)
    """
    devices = devices if devices is not None else jax.devices()
    d, r, s = axis_sizes
    if d * r * s > len(devices):
        raise ValueError(
            "mesh axes %r need %d devices but only %d are available"
            % (axis_sizes, d * r * s, len(devices))
        )
    arr = np.array(devices[: d * r * s]).reshape(d, r, s)
    return Mesh(arr, (AXIS_BATCH, AXIS_ROWS, AXIS_SAMPLES))


def shard_tiles_rows(
    tiles: np.ndarray, mesh: Mesh, tile_rows: int = 32
) -> jax.Array:
    """Place a tile-major matrix uint32[T, tile_rows*W] with the TILE
    axis sharded over ``r`` and the word axis over ``s`` — each device
    holds a contiguous tile slab of its sample-column shard.  T is
    zero-padded to a multiple of |r| (phantom tiles are never probed:
    utile ids stay < T)."""
    t, fat = tiles.shape
    w = fat // tile_rows
    arr = tiles.reshape(t, tile_rows, w)
    r = mesh.shape[AXIS_ROWS]
    s = mesh.shape[AXIS_SAMPLES]
    tp = math.ceil(t / r) * r
    wp = math.ceil(w / s) * s
    if (tp, wp) != (t, w):
        grown = np.zeros((tp, tile_rows, wp), dtype=np.uint32)
        grown[:t, :, :w] = arr
        arr = grown
    return jax.device_put(
        arr, NamedSharding(mesh, P(AXIS_ROWS, None, AXIS_SAMPLES))
    )


def make_rowsharded_grouped_step(mesh: Mesh, tile_rows: int = 32):
    """Grouped (minimizer tile-dedup) batched counts over a ROW-sharded
    tile matrix.

    step(tiles3, utile, gmask) with tiles3 uint32[T_pad, tile_rows, W]
    sharded P(r, None, s); utile int32[B, U] / gmask uint32[B, U, R]
    sharded P(d, None(, None)) -> counts int32[B, W*32] sharded
    P(d, None).

    Each device keeps only the slot entries whose tile falls in its
    slab (the rest contribute zero rows to the carry-save popcount),
    gathers locally, and the per-slab partial counts ``psum`` over
    ``r`` then ``all_gather`` over ``s``.  The reference's analogue is
    splitting the row key-space over storage shards
    (``bigsi/storage/redis.py`` sharded-server deployments).
    """
    from bigsi_tpu.ops.lookup import grouped_counts

    def local_step(tiles_l, utile_l, gmask_l):
        t_loc, tr, w_l = tiles_l.shape
        lo = jax.lax.axis_index(AXIS_ROWS) * t_loc
        local = utile_l - lo
        in_slab = (local >= 0) & (local < t_loc)
        # masked-out entries point at tile 0 with an empty slot mask ->
        # zero contribution to the counts
        local = jnp.where(in_slab, local, 0)
        gm = jnp.where(in_slab[..., None], gmask_l, jnp.uint32(0))
        counts_l = grouped_counts(
            tiles_l.reshape(t_loc, tr * w_l), local, gm, tr
        )
        counts_l = jax.lax.psum(counts_l, AXIS_ROWS)
        return jax.lax.all_gather(counts_l, AXIS_SAMPLES, axis=1, tiled=True)

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(AXIS_ROWS, None, AXIS_SAMPLES),
            P(AXIS_BATCH, None),
            P(AXIS_BATCH, None, None),
        ),
        out_specs=P(AXIS_BATCH, None),
        check_vma=False,
    )
    return jax.jit(step)


class MeshEngine:
    """Engine with the HostEngine surface, backed by a sharded mesh.

    Single queries are a batch of one; ``bulk`` paths feed full
    batches.  Constructed via ``config["mesh"]`` (axis sizes) or
    ``MeshEngine(matrix, mesh=...)``.
    """

    def __init__(
        self, matrix, mesh: Mesh | None = None, h: int | None = None,
        layout: str = "classic", tile_rows: int = 32, row_shards: int = 1,
        minimizer_window: int | None = None, run_len: int | None = None,
        slot_scheme: int = 1,
    ):
        from bigsi_tpu.utils.devices import default_device

        default_device()  # refuses a CPU nobody asked for
        self.matrix = matrix
        self.mesh = mesh or make_mesh()
        self.layout = layout
        self.tile_rows = tile_rows
        if run_len is None and layout == "minimizer":
            from bigsi_tpu.hashing.scheme import default_run_len

            run_len = default_run_len(minimizer_window)
        self.run_len = run_len
        self.row_shards = row_shards
        self.minimizer_window = minimizer_window
        self.slot_scheme = slot_scheme
        self._seq_steps = {}
        if row_shards > 1 and layout not in ("blocked", "minimizer"):
            raise ValueError(
                "row sharding needs a tile layout (blocked/minimizer): "
                "classic spreads a k-mer's rows over the whole index"
            )
        self.words = shard_matrix(np.asarray(matrix.words), self.mesh)
        self._steps = {}
        self._grouped_step = None
        self._grouped_db = None
        self._tiles3 = None
        self._cols_step = None
        self._cols = None
        self._cols_db = None
        self._h = h

    def _grouped(self):
        """Lazy grouped step + tile-major sharded matrix.

        (d, 1, s) mesh by default; with ``row_shards`` > 1 a
        (d*k, r, s) ROW mesh — the tile axis shards over ``r`` so the
        matrix can exceed one device's HBM (see make_row_mesh).

        Returns (step, tiles3, batch_axis_size) — callers must pad the
        query batch to a multiple of the GROUPED mesh's batch axis
        (d*k when the base mesh has a k axis), not the base mesh's d.
        """
        if self._grouped_step is None:
            d, k, s = (
                self.mesh.shape[AXIS_BATCH],
                self.mesh.shape[AXIS_KMERS],
                self.mesh.shape[AXIS_SAMPLES],
            )
            from bigsi_tpu.index.device_engine import tile_pack

            tiles = tile_pack(np.asarray(self.matrix.words), self.tile_rows)
            if self.row_shards > 1:
                mesh = make_row_mesh((d * k, self.row_shards, s))
                self._tiles3 = shard_tiles_rows(tiles, mesh, self.tile_rows)
                self._grouped_step = make_rowsharded_grouped_step(
                    mesh, self.tile_rows
                )
            else:
                mesh = (
                    self.mesh
                    if k == 1
                    else make_mesh(d * k * s, (d * k, 1, s))
                )
                self._tiles3 = shard_tiles(tiles, mesh, self.tile_rows)
                self._grouped_step = make_sharded_grouped_step(
                    mesh, self.tile_rows
                )
            self._grouped_db = mesh.shape[AXIS_BATCH]
        return self._grouped_step, self._tiles3, self._grouped_db

    def _cols_setup(self):
        """Lazy sharded cols layout: sample axis sharded over ``s``, one
        compare per LOCAL sample per slot.  Used when the mesh has no
        row shards and tile_rows fits a machine word; row-sharded
        indexes keep the grouped path.  Each device packs its own
        columns from its shard of the row-major words
        (:func:`pack_cols_sharded`)."""
        if self._cols_step is None:
            d, k, s = (
                self.mesh.shape[AXIS_BATCH],
                self.mesh.shape[AXIS_KMERS],
                self.mesh.shape[AXIS_SAMPLES],
            )
            if k == 1:
                mesh, words = self.mesh, self.words
            else:
                mesh = make_mesh(d * k * s, (d * k, 1, s))
                words = shard_matrix(np.asarray(self.matrix.words), mesh)
            self._cols = pack_cols_sharded(words, mesh, self.tile_rows)
            self._cols_step = make_sharded_cols_step(mesh)
            self._cols_db = mesh.shape[AXIS_BATCH]
        return self._cols_step, self._cols, self._cols_db

    def _use_cols(self) -> bool:
        from bigsi_tpu.ops.lookup import cols_dtype

        return (
            self.layout == "minimizer"
            and self.row_shards == 1
            and cols_dtype(self.tile_rows) is not None
        )

    # -- bytes-to-counts (on-device prep) over the mesh ----------------

    def supports_seq_batch(self) -> bool:
        num_tiles = max(1, self.matrix.num_rows // self.tile_rows)
        return (
            self._use_cols()
            and self.slot_scheme == 3
            and self.tile_rows & (self.tile_rows - 1) == 0
            and num_tiles < (1 << 28)
        )

    def counts_batch_seqs(
        self, seqs: np.ndarray, lens: np.ndarray, k: int, h: int,
        num_cols: int,
    ):
        """Bytes-to-counts over the mesh: on-device prep replicated per
        batch shard + sample-sharded cols count (make_sharded_seq_step).
        Same contract as DeviceEngine.counts_batch_seqs (None = caller
        falls back to the host-prep path)."""
        from bigsi_tpu.hashing.scheme import (
            MINIMIZER_SEED,
            default_minimizer_s,
            window_to_s,
        )
        from bigsi_tpu.index.device_engine import seq_batch_geometry
        from bigsi_tpu.ops.lookup import GROUP_R

        b, l = seqs.shape
        if b == 0:
            return (
                np.zeros((0, num_cols), dtype=np.int64),
                np.zeros(0, dtype=np.int32),
            )
        s_mer = (
            window_to_s(k, self.minimizer_window)
            or default_minimizer_s(k)
        )
        window = k - s_mer + 1
        _, cols, db = self._cols_setup()
        geom = seq_batch_geometry(seqs, lens, k, window, db=db)
        if geom is None:
            return None
        padded, lens_b, lb, u_cap = geom
        key = (k, h, lb)
        if key not in self._seq_steps:
            self._seq_steps[key] = make_sharded_seq_step(
                cols.sharding.mesh,
                k=k, s=s_mer,
                num_tiles=max(1, self.matrix.num_rows // self.tile_rows),
                h=h, tile_rows=self.tile_rows,
                r=self.run_len or GROUP_R,
                u_cap=u_cap,
                seed=MINIMIZER_SEED,
            )
        counts, n_valid, ok = self._seq_steps[key](cols, padded, lens_b)
        if not bool(np.asarray(ok).all()):
            return None
        return (
            np.asarray(counts)[:b, :num_cols].astype(np.int64),
            np.asarray(n_valid)[:b],
        )

    def _step(self, h: int):
        if h not in self._steps:
            self._steps[h] = make_sharded_query_step(self.mesh, h)
        return self._steps[h]

    def _pad_sizes(self, b: int, k: int) -> tuple[int, int]:
        """Pow2 buckets (aligned to the mesh axes) so varying serving
        batch/query sizes reuse a handful of compiled shapes."""
        db = self.mesh.shape[AXIS_BATCH]
        dk = self.mesh.shape[AXIS_KMERS]
        bucket_k = max(64, dk)
        while bucket_k < k:
            bucket_k *= 2
        bucket_k = math.ceil(bucket_k / dk) * dk
        bucket_b = db
        while bucket_b < b:
            bucket_b *= 2
        return bucket_b, bucket_k

    def query_batch(self, row_idx_list):
        """List of int [K_i, h] -> (counts int64 [B, N_pad], exact uint32 [B, W])."""
        b = len(row_idx_list)
        h = row_idx_list[0].shape[1]
        kmax = max(r.shape[0] for r in row_idx_list)
        bb, kk = self._pad_sizes(b, kmax)
        idx = np.zeros((bb, kk, h), dtype=np.int32)
        mask = np.zeros((bb, kk), dtype=bool)
        for i, r in enumerate(row_idx_list):
            idx[i, : r.shape[0]] = r
            mask[i, : r.shape[0]] = True
        counts, exact = self._step(h)(self.words, idx, mask)
        return (
            np.asarray(counts)[:b].astype(np.int64),
            np.asarray(exact)[:b],
        )

    def counts_batch(
        self, row_idx: np.ndarray, mask: np.ndarray, num_cols: int
    ) -> np.ndarray:
        """Batched per-query hit counts over the mesh in one dispatch.

        row_idx int [B, K, h], mask bool [B, K] -> int64 [B, num_cols].
        Same contract as ``DeviceEngine.counts_batch`` — this is what
        ``BIGSI.search_batch`` calls when the index is mesh-sharded.
        """
        b, k, h = row_idx.shape
        if b == 0 or k == 0:
            return np.zeros((b, num_cols), dtype=np.int64)
        if self.layout == "minimizer":
            from bigsi_tpu.ops.lookup import GROUP_R, build_grouped_streams

            use_cols = self._use_cols()
            if use_cols:
                step, matrix_d, db = self._cols_setup()
            else:
                step, matrix_d, db = self._grouped()
            tr = self.tile_rows
            # pow2 batch bucket (multiple of the grouped mesh's batch
            # axis) so serving batch sizes hit a few compiled shapes
            bb = db
            while bb < b:
                bb *= 2
            tile = np.zeros((bb, k), dtype=np.int32)
            tile[:b] = row_idx[:, :, 0] // tr
            sm = np.zeros((bb, k), dtype=np.uint32)
            sm[:b] = np.where(
                mask,
                np.bitwise_or.reduce(
                    np.uint32(1) << (row_idx % tr).astype(np.uint32), axis=2
                ),
                np.uint32(0),
            )
            utile, gmask = build_grouped_streams(
                tile, sm, r=self.run_len or GROUP_R
            )
            if use_cols:
                n_valid = np.zeros(bb, dtype=np.int32)
                n_valid[:b] = mask.sum(axis=1)
                counts = step(matrix_d, utile, gmask, n_valid)
            else:
                counts = step(matrix_d, utile, gmask)
            return np.asarray(counts)[:b, :num_cols].astype(np.int64)
        bb, kk = self._pad_sizes(b, k)
        idx = np.zeros((bb, kk, h), dtype=np.int32)
        idx[:b, :k] = row_idx
        mfull = np.zeros((bb, kk), dtype=bool)
        mfull[:b, :k] = mask
        counts, _ = self._step(h)(self.words, idx, mfull)
        return np.asarray(counts)[:b, :num_cols].astype(np.int64)

    # -- HostEngine-compatible single-query surface --------------------

    def and_rows(self, row_idx: np.ndarray):
        # For the mesh engine the packed presence rows stay implicit;
        # we keep the row indices and lazily run the fused step.
        return _MeshQuery(self, row_idx)

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
        return counts[0, :num_cols]

    def presence_matrix(self, packed, num_cols: int) -> np.ndarray:
        if isinstance(packed, np.ndarray):
            return np.empty((0, num_cols), dtype=np.uint8)
        # scoring needs per-kmer presence; run the plain gather+AND on
        # the sharded matrix (small K; result fetched to host)
        rows = np.asarray(
            jax.jit(and_rows_jnp)(self.words, jnp.asarray(packed.row_idx))
        )
        bits = np.unpackbits(rows.view(np.uint8), axis=-1, bitorder="little")
        return bits[:, :num_cols]


class _MeshQuery:
    def __init__(self, engine: MeshEngine, row_idx: np.ndarray):
        self.engine = engine
        self.row_idx = row_idx
        self._result = None

    def result(self):
        if self._result is None:
            self._result = self.engine.query_batch([self.row_idx])
        return self._result
