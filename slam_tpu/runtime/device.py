"""Device checks and the persistent compile cache for the entry points.

The CLI, bench.py and chip_smoke.py share these. A measurement on the
card must never fall back to the CPU: JAX only warns when its CUDA plugin
does not load, so ``require_gpu`` makes the check explicit.
"""

from __future__ import annotations

import os
import shutil
import subprocess

REPO_ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__),
                                          os.pardir, os.pardir))
# A fixed path (listed in .gitignore): the cache key includes the
# directory, so a cache that moves never hits.
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and return that directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def require_gpu():
    """Return ``jax.devices()`` if JAX runs on a GPU; raise otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devices[0].platform} "
            f"({devices[0].device_kind}); this entry point measures the "
            "card and does not fall back to another device")
    return devices


def card_description() -> str:
    """``name, power.limit`` of every card as nvidia-smi reports them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return " | ".join(line.strip() for line in out.splitlines()
                      if line.strip())
