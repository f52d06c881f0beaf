"""Which device the engines run on, and where compiled programs are kept.

Two rules live here so every entry point (CLI, ``serve``, bench.py,
chip_smoke.py) applies them the same way:

* an engine that asks for "the accelerator" never gets the CPU by
  accident: when JAX finds only its CPU backend and ``JAX_PLATFORMS``
  did not ask for it, :func:`default_device` raises instead of serving
  from the CPU without a word (a GPU host whose CUDA plugin failed to
  load looks exactly like that);
* the persistent compile cache goes where ``JAX_COMPILATION_CACHE_DIR``
  says, and otherwise to ``<checkout>/.jax_cache`` — a fixed path, so a
  later process finds what an earlier one compiled.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

# bigsi_tpu/utils/devices.py -> the checkout (or site-packages) root
CHECKOUT_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str | None:
    """The directory this package sets for JAX's persistent compile
    cache: None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads the
    variable itself), else ``<checkout>/.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT_DIR, ".jax_cache")


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    and cache every program.  Sets nothing when the environment already
    names a cache.  Returns the directory set, or None."""
    path = compile_cache_dir()
    if path is None:
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def cpu_requested() -> bool:
    """True when the process asked JAX for its CPU backend, through
    ``JAX_PLATFORMS`` or the ``jax_platforms`` config option."""
    names = os.environ.get("JAX_PLATFORMS", "")
    try:
        import jax

        names += "," + (jax.config.jax_platforms or "")
    except Exception:  # noqa: BLE001 — an unreadable option asks nothing
        pass
    return "cpu" in {n.strip().lower() for n in names.split(",")}


def default_device():
    """``jax.devices()[0]``, refusing a CPU nobody asked for."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu" and not cpu_requested():
        raise RuntimeError(
            "JAX found no accelerator (only the CPU backend). Set "
            "JAX_PLATFORMS=cpu to run the device engine on the CPU on "
            "purpose, or check the accelerator's JAX plugin."
        )
    return dev


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (one line per card, verbatim), or a note saying why there is
    none."""
    import subprocess

    try:
        out = subprocess.run(
            [
                "nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return "nvidia-smi unavailable (%s)" % e
    return out


def device_summary() -> str:
    """``platform device_kind xcount`` of JAX's default backend."""
    import jax

    devs = jax.devices()
    return "%s %s x%d" % (devs[0].platform, devs[0].device_kind, len(devs))
