"""Tests that need the GPU: the count programs compiled for the card,
and chip_smoke.py's phases at a mid size.  They skip elsewhere; run
them on a GPU host with

    BIGSI_TEST_DEVICE=1 python -m pytest tests/ -m gpu
"""

import os
import sys

import numpy as np
import pytest

from bigsi_tpu.index.device_engine import DeviceEngine
from bigsi_tpu.index.host_engine import HostEngine, counts_batch_fallback
from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("layout", ["classic", "minimizer"])
def test_count_programs_on_gpu(gpu, layout):
    rng = np.random.default_rng(7)
    m, w, b, k, h, tr = 1 << 16, 128, 8, 512, 3, 16
    words = rng.integers(0, 2 ** 32, size=(m, w), dtype=np.uint32)
    mat = BitSliceMatrix(words & words[::-1], w * 32)
    if layout == "classic":
        dev = DeviceEngine(mat, device=gpu)
        idx = rng.integers(0, m, size=(b, k, h))
    else:
        dev = DeviceEngine(mat, device=gpu, layout="minimizer", tile_rows=tr,
                           minimizer_window=19, slot_scheme=3)
        tiles = rng.integers(0, m // tr, size=(b, k, 1))
        idx = tiles * tr + rng.integers(0, tr, size=(b, k, h))
    mask = np.ones((b, k), dtype=bool)
    mask[0, k // 2:] = False
    got = dev.counts_batch(idx, mask, mat.num_cols)
    want = counts_batch_fallback(HostEngine(mat), idx, mask, mat.num_cols)
    assert np.array_equal(got, want)


def test_chip_smoke_phases_on_gpu(gpu, tmp_path):
    planted, queries = chip_smoke.make_workload(0, 64, 16)
    chip_smoke.phase_classic(str(tmp_path), 1024, 1 << 20, 0, queries,
                             planted, "disk", n_get=8)
    chip_smoke.phase_minimizer(str(tmp_path), 1024, 1 << 20, 0, queries,
                               planted, "disk")
