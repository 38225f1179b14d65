"""Where the program runs: one decision for every module.

- :func:`gpu_kernels` — whether the hand-written GPU kernels
  (``ops/block0_kernel.py``) can run: JAX's default backend is a CUDA GPU.
  Callers take the plain XLA path otherwise; a kernel is never run in
  interpret mode except from tests.
- :func:`is_accelerator` — any backend but the host CPU (data parallelism
  engages automatically there).
- :func:`enable_compile_cache` — JAX's persistent compilation cache at a
  fixed path, unless ``JAX_COMPILATION_CACHE_DIR`` already names one.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def platform() -> str:
    return jax.default_backend()


def gpu_kernels() -> bool:
    return platform() == "gpu"


def is_accelerator() -> bool:
    return platform() != "cpu"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and nothing
    is changed. Otherwise the cache goes to ``<repo>/.jax_cache`` — a fixed
    path, since the path is part of what makes a later process hit.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``), or a note saying why there is none."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or out.stderr.strip()


def device_info() -> dict:
    """What JAX reports about the devices: platform, kind and count."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> dict:
    """Fail unless JAX runs on a GPU; returns :func:`device_info`. Device
    measurements never fall back to the CPU."""
    if platform() != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is {platform()!r}")
    return device_info()
