"""Running on the GPU: device checks, compile cache, config loading, the
synthetic index and chip_smoke.py's phases at a tiny size on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bigsi_tpu.utils import devices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(code, env_extra=None, args=None):
    """A fresh interpreter at the repo root, JAX_PLATFORMS unset unless
    ``env_extra`` sets it."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(env_extra or {})
    cmd = [sys.executable] + (args if args is not None else ["-c", code])
    return subprocess.run(
        cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )


# -- compile cache ----------------------------------------------------------


def _record_updates(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: calls.append((name, value))
    )
    return calls


def test_compile_cache_env_set_overrides_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert devices.compile_cache_dir() is None
    assert devices.enable_compile_cache() is None
    assert calls == []


def test_compile_cache_env_unset_uses_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    want = os.path.join(REPO, ".jax_cache")
    assert devices.compile_cache_dir() == want
    assert devices.enable_compile_cache() == want
    assert devices.enable_compile_cache() == want  # no pid/time in it
    assert ("jax_compilation_cache_dir", want) in calls


# -- engine names and the device check ---------------------------------------


@pytest.mark.parametrize("name", ["device", "tpu"])
def test_device_engine_name_and_older_spelling(name):
    from bigsi_tpu import BIGSI
    from bigsi_tpu.config import engine_name, validate_config
    from bigsi_tpu.index.device_engine import DeviceEngine
    from bigsi_tpu.kmers import seq_to_kmers
    from bigsi_tpu.storage import get_storage

    cfg = {
        "storage-engine": "memory",
        "storage-config": {"filename": "engine-name-%s" % name},
        "k": 3, "m": 1000, "h": 3, "engine": name,
    }
    assert validate_config(dict(cfg)) == cfg
    assert engine_name(cfg) == "device"
    get_storage(cfg).delete_all()
    BIGSI.build(cfg, [BIGSI.bloom(cfg, seq_to_kmers("ATACACAAT", 3))], ["a"])
    idx = BIGSI(cfg)
    assert isinstance(idx.engine, DeviceEngine)
    assert [r["sample_name"] for r in idx.search("ATACACAAT")] == ["a"]
    idx.delete()


def test_unknown_engine_rejected():
    from bigsi_tpu.config import validate_config

    with pytest.raises(ValueError, match="unknown engine"):
        validate_config({"k": 3, "m": 10, "h": 1, "engine": "gpu0"})


@pytest.mark.parametrize("engine", ["DeviceEngine", "MeshEngine"])
def test_engine_refuses_cpu_nobody_asked_for(engine):
    code = (
        "import numpy as np\n"
        "import jax\n"
        "from bigsi_tpu.matrix.bitmatrix import BitSliceMatrix\n"
        "from bigsi_tpu.index.device_engine import DeviceEngine\n"
        "from bigsi_tpu.parallel.sharding import MeshEngine\n"
        "print('platform', jax.devices()[0].platform)\n"
        "m = BitSliceMatrix(np.zeros((64, 8), np.uint32), 200)\n"
        "try:\n"
        "    %s(m)\n"
        "    print('served')\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n" % engine
    )
    out = _run(code).stdout
    if "platform gpu" in out:
        pytest.skip("an accelerator is present: nothing to refuse")
    assert "refused: JAX found no accelerator" in out, out
    asked = _run(code, env_extra={"JAX_PLATFORMS": "cpu"}).stdout
    assert "served" in asked, asked


def test_local_device_ids_pin_one_card_per_local_process(monkeypatch):
    from bigsi_tpu.parallel import distributed as dist

    monkeypatch.setattr(devices, "cpu_requested", lambda: False)
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    assert dist.local_device_ids("localhost:1234", 4, 2) == [2]
    assert dist.local_device_ids("127.0.0.1:1234", 2, 1) == [1]
    assert dist.local_device_ids("host0:1234", 2, 1) is None
    assert dist.local_device_ids("localhost:1234", 1, 0) is None
    monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", "0")
    assert dist.local_device_ids("localhost:1234", 4, 2) is None
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS")
    monkeypatch.setattr(devices, "cpu_requested", lambda: True)
    assert dist.local_device_ids("localhost:1234", 4, 2) is None


# -- config files and imports -------------------------------------------------


def test_json_config_loads_with_the_stdlib(tmp_path):
    from bigsi_tpu.config import get_config_from_file

    cfg = {"k": 31, "m": 1000, "h": 3, "engine": "device",
           "layout": "minimizer", "tile-rows": 16}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    assert get_config_from_file(str(path)) == cfg
    path.write_text(json.dumps(dict(cfg, k=0)))
    with pytest.raises(ValueError, match="positive integer"):
        get_config_from_file(str(path))


def test_cli_import_leaves_yaml_out():
    out = _run(
        "import sys, bigsi_tpu.__main__, bigsi_tpu.http.server\n"
        "print('yaml' in sys.modules)",
        env_extra={"JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# -- synthetic index -----------------------------------------------------------


def test_density_bits_and_random_words():
    import jax

    from bigsi_tpu.synth import density_bits, random_words

    assert density_bits(0.375) == [0, 1, 1]
    assert density_bits(0.5) == [1]
    with pytest.raises(ValueError):
        density_bits(1.0)
    words = np.asarray(random_words(jax.random.PRNGKey(0), (512, 64), 0.375))
    frac = np.unpackbits(words.view(np.uint8)).mean()
    assert abs(frac - 0.375) < 0.01


@pytest.mark.parametrize("layout", ["classic", "minimizer"])
def test_synthetic_index_disk_equals_memory(tmp_path, layout):
    from bigsi_tpu import BIGSI
    from bigsi_tpu.synth import random_genome, write_index

    lay = {"layout": "classic"} if layout == "classic" else chip_smoke.MINIMIZER
    rng = np.random.default_rng(1)
    planted = {"p0": random_genome(rng, 400), "p1": random_genome(rng, 400)}
    mats = []
    for store in ("disk", "memory"):
        cfg = chip_smoke.index_config(str(tmp_path), "s" + layout, lay,
                                      store, 1 << 14)
        summary = write_index(cfg, 70, planted, seed=5, chunk_rows=1 << 12)
        assert summary["store"] == store and summary["words_per_row"] == 8
        idx = BIGSI(cfg)
        words = np.array(idx.bitmatrix.words)
        # samples 70.. are lane padding: bits 6.. of word 2, words 3..
        assert not (words[:, 2] >> np.uint32(6)).any()
        assert not words[:, 3:].any()
        hits = idx.search(planted["p1"][100:200])
        assert [r["sample_name"] for r in hits] == ["p1"]
        assert idx.num_samples == 70
        mats.append(words)
    assert np.array_equal(mats[0], mats[1])


# -- chip_smoke.py ------------------------------------------------------------------


def test_chip_smoke_refuses_the_cpu():
    out = _run(None, env_extra={"JAX_PLATFORMS": "cpu"},
               args=["chip_smoke.py"])
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert lines and '"ok": true' not in lines[-1]
    assert "no GPU" in out.stdout


def test_chip_smoke_workload_is_seeded():
    a = chip_smoke.make_workload(3, 16, 8)
    b = chip_smoke.make_workload(3, 16, 8)
    assert a == b
    planted, queries = a
    assert len(planted) == 8 and len(set(planted.values())) == 6
    assert all(800 <= len(q) <= 1000 for q in queries)
    # exact windows come from planted genomes
    assert all(any(q in g for g in planted.values())
               for i, q in enumerate(queries) if i % 4 < 2)


def test_chip_smoke_fit_samples_cuts_to_budget(tmp_path, capsys):
    assert chip_smoke.fit_samples(4096, 1000, 1, "disk", str(tmp_path)) == 4096
    cut = chip_smoke.fit_samples(4096, 10 ** 15, 1, "memory", str(tmp_path))
    assert cut < 4096 and cut % 32 == 0
    assert "cut: N=4096" in capsys.readouterr().out


def test_chip_smoke_phase_classic_on_cpu(tmp_path):
    planted, queries = chip_smoke.make_workload(0, 16, 8)
    chip_smoke.phase_classic(
        str(tmp_path), 96, 1 << 16, 0, queries, planted, "disk", n_get=4
    )


def test_chip_smoke_phase_minimizer_on_cpu(tmp_path):
    planted, queries = chip_smoke.make_workload(0, 16, 8)
    chip_smoke.phase_minimizer(
        str(tmp_path), 96, 1 << 16, 0, queries, planted, "disk"
    )


def test_chip_smoke_phase_mesh_on_four_virtual_devices(tmp_path):
    import jax

    assert len(jax.devices()) >= 4
    planted, queries = chip_smoke.make_workload(0, 16, 8)
    chip_smoke.phase_mesh(
        str(tmp_path), 256, 1 << 16, 0, queries, planted, "memory",
        cards=4
    )


def test_chip_smoke_phase_detects_a_wrong_answer(tmp_path, monkeypatch):
    """The oracle comparison is live: a flipped count fails the phase."""
    from bigsi_tpu.graph import BIGSI

    planted, queries = chip_smoke.make_workload(0, 8, 4)
    real = BIGSI.search_batch

    def off_by_one(self, seqs, threshold=1.0, score=False):
        out = real(self, seqs, threshold, score)
        for res in out:
            for r in res:
                r["num_kmers_found"] += 1
        return out

    monkeypatch.setattr(BIGSI, "search_batch", off_by_one)
    with pytest.raises(chip_smoke.SmokeFailure, match="differ"):
        chip_smoke.phase_minimizer(
            str(tmp_path), 64, 1 << 15, 0, queries, planted, "disk"
        )
