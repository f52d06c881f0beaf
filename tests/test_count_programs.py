"""The device count programs against HostEngine, across row widths.

``_counts_batch_fat`` (classic layout) and ``_counts_batch_cols``
(minimizer layout, column-major tiles) at W = 1, 4, 32, 128 and 129
words per row (32 .. 4128 samples) and tile heights 8, 16 and 32.  On
the CPU backend here; ``tests/test_gpu.py`` repeats them on the GPU.
"""

import numpy as np
import pytest

from bigsi_tpu.index.device_engine import DeviceEngine
from bigsi_tpu.index.host_engine import HostEngine, counts_batch_fallback
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix

WIDTHS = [1, 4, 32, 128, 129]
TILE_ROWS = [8, 16, 32]
M, B, K, H = 256, 3, 40, 3


def _matrix(rng, w):
    words = rng.integers(0, 2 ** 32, size=(M, w), dtype=np.uint32)
    words &= rng.integers(0, 2 ** 32, size=(M, w), dtype=np.uint32)
    return BitSliceMatrix(words, w * 32)


def _queries(rng, tile_rows=None):
    """row_idx [B, K, H] (the h rows of a k-mer share a tile when
    ``tile_rows`` is given, as the minimizer layout guarantees) and a
    ragged validity mask."""
    if tile_rows is None:
        idx = rng.integers(0, M, size=(B, K, H))
    else:
        tiles = rng.integers(0, M // tile_rows, size=(B, K, 1))
        idx = tiles * tile_rows + rng.integers(0, tile_rows, size=(B, K, H))
    mask = np.zeros((B, K), dtype=bool)
    for i, n in enumerate(rng.integers(1, K + 1, size=B)):
        mask[i, :n] = True
    return idx, mask


@pytest.mark.parametrize("w", WIDTHS)
def test_counts_batch_fat_matches_host(w):
    rng = np.random.default_rng(w)
    mat = _matrix(rng, w)
    idx, mask = _queries(rng)
    dev = DeviceEngine(mat)
    assert dev.cols is None and dev.g is not None
    got = dev.counts_batch(idx, mask, mat.num_cols)
    want = counts_batch_fallback(HostEngine(mat), idx, mask, mat.num_cols)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("tile_rows", TILE_ROWS)
@pytest.mark.parametrize("w", WIDTHS)
def test_cols_counts_match_host(w, tile_rows):
    rng = np.random.default_rng(1000 * w + tile_rows)
    mat = _matrix(rng, w)
    idx, mask = _queries(rng, tile_rows)
    dev = DeviceEngine(mat, layout="minimizer", tile_rows=tile_rows,
                       minimizer_window=19, slot_scheme=3)
    assert dev.cols is not None and dev.words is None
    got = dev.counts_batch(idx, mask, mat.num_cols)
    want = counts_batch_fallback(HostEngine(mat), idx, mask, mat.num_cols)
    assert np.array_equal(got, want)
