"""Synthetic indexes at a deployment's size, made from a seed.

Builds an index (manifest + ``rows.bin`` on disk, or the in-process
memory store) with N samples and m bloom bits WITHOUT materializing
per-sample blooms: bitslice rows are drawn directly at the Bloom-filter
load factor

    p = 1 - (1 - 1/m)^(h * n_kmers)  ~=  1 - exp(-h * n_kmers / m)

which is the bit density a real build at those parameters converges to
(``scripts/bigsi-param-calculation.R`` in the reference).  A handful of
*planted* samples get the real blooms of known genomes OR-ed into their
columns, so queries have ground truth to hit.

The random words are drawn on JAX's default device, one block of rows
at a time, and copied to the host: at m=25e6 and thousands of samples
that is tens of GB, which a host RNG would take minutes to draw.
"""

from __future__ import annotations

import numpy as np

from bigsi_tpu.matrix.bitmatrix import _padded_words

# Bloom density of a sample with ~3.9e6 distinct k-mers (a bacterial
# genome) at the reference defaults m=25e6, h=3: 1 - exp(-3*3.9e6/25e6)
# = 0.374.  0.375 = 0b0.011 costs three random words per output word.
DEFAULT_DENSITY = 0.375
CHUNK_ROWS = 1 << 18


def density_bits(density: float, places: int = 8) -> list[int]:
    """Binary digits of ``density`` after the point, most significant
    first, cut at its last 1 (``density`` is rounded to ``places``)."""
    q = int(round(density * (1 << places)))
    if not 0 < q < (1 << places):
        raise ValueError("density must lie strictly between 0 and 1")
    bits = [(q >> (places - 1 - i)) & 1 for i in range(places)]
    while bits[-1] == 0:
        bits.pop()
    return bits


def random_words(key, shape, density: float):
    """uint32 words whose bits are independently 1 with ``density``
    (rounded to 8 binary places).  Folding fair random words from the
    least significant digit up — OR for a 1, AND for a 0 — yields
    exactly the binary fraction."""
    import jax
    import jax.numpy as jnp

    bits = density_bits(density)
    keys = jax.random.split(key, len(bits))
    acc = None
    for b, k in zip(reversed(bits), keys):
        r = jax.random.bits(k, shape, jnp.uint32)
        if acc is None:
            acc = r if b else jnp.zeros(shape, jnp.uint32)
        else:
            acc = (acc | r) if b else (acc & r)
    return acc


def planted_rows(config: dict, genome: str) -> np.ndarray:
    """Bloom rows set by every k-mer of ``genome`` under ``config``'s
    layout (through :meth:`BIGSI.bloom`, the build entry point)."""
    from bigsi_tpu.graph.bigsi import BIGSI
    from bigsi_tpu.kmers import seq_to_kmers

    bits = BIGSI.bloom(config, seq_to_kmers(genome, config["k"]))
    return np.flatnonzero(np.asarray(bits)[: config["m"]])


def write_index(
    config: dict,
    num_samples: int,
    planted: dict,
    seed: int = 0,
    density: float = DEFAULT_DENSITY,
    chunk_rows: int = CHUNK_ROWS,
) -> dict:
    """Write a synthetic index where ``config`` says.

    ``planted`` maps sample name -> genome; those samples take the first
    colours and hold their genome's k-mers on top of the background.
    The remaining samples are named ``synth<i>``.  Supports the on-disk
    store and the memory store.  Returns a summary dict.
    """
    import jax

    from bigsi_tpu.graph.metadata import SampleMetadata
    from bigsi_tpu.hashing.scheme import default_slot_scheme
    from bigsi_tpu.index.signature import persist_index_params
    from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix
    from bigsi_tpu.storage import get_storage
    from bigsi_tpu.storage.index_store import IndexStore

    n, m, h = num_samples, config["m"], config["h"]
    if len(planted) > n:
        raise ValueError("more planted genomes than samples")
    w = _padded_words(n)
    layout = config.get("layout", "classic")
    plant = [planted_rows(config, g) for g in planted.values()]

    storage = get_storage(config)
    storage.delete_all()
    on_disk = isinstance(storage, IndexStore)
    if on_disk:
        out = open(storage.rows_path(), "wb")
    else:
        words = np.empty((m, w), dtype=np.uint32)
    # phantom lane-padding samples past n must stay zero
    tail = np.full(w, 0xFFFFFFFF, dtype=np.uint32)
    tail[n // 32 :] = 0
    if n % 32:
        tail[n // 32] = (1 << (n % 32)) - 1
    draw = jax.jit(
        lambda key: random_words(key, (chunk_rows, w), density)
    )
    key = jax.random.PRNGKey(seed)
    try:
        for r0 in range(0, m, chunk_rows):
            r1 = min(m, r0 + chunk_rows)
            block = np.array(draw(jax.random.fold_in(key, r0 // chunk_rows)))
            block = block[: r1 - r0]
            block &= tail
            for c, rows in enumerate(plant):
                sel = rows[(rows >= r0) & (rows < r1)] - r0
                block[sel, c // 32] |= np.uint32(1 << (c % 32))
            if on_disk:
                block.tofile(out)
            else:
                words[r0:r1] = block
    finally:
        if on_disk:
            out.close()

    persist_index_params(
        storage.kv, m, h, layout=layout,
        tile_rows=config.get("tile-rows", 32),
        minimizer_window=config.get("minimizer-window"),
        slot_scheme=default_slot_scheme(layout, config),
        run_len=config.get("run-len"),
    )
    names = list(planted) + [
        "synth%d" % i for i in range(len(planted), n)
    ]
    SampleMetadata(storage.kv).add_samples(names)
    if on_disk:
        storage.adopt_rows(num_rows=m, num_words=w, num_cols=n)
    else:
        storage.save_matrix(BitSliceMatrix(words, n))
    storage.close()
    return {
        "samples": n, "m": m, "h": h, "layout": layout,
        "words_per_row": w, "density": density,
        "planted": len(planted),
        "rows_bytes": m * w * 4,
        "store": "disk" if on_disk else "memory",
        "path": getattr(storage, "directory", None),
    }


def random_genome(rng: np.random.Generator, length: int) -> str:
    return np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=length)
    ].tobytes().decode("ascii")

