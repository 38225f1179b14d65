"""The one backend decision (voicemap/backend.py) and the compile cache."""

import os
import subprocess
import sys

import jax
import pytest

from voicemap import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_backend_has_no_gpu_kernels():
    assert backend.platform() == "cpu"
    assert backend.gpu_kernels() is False
    assert backend.is_accelerator() is False


def test_gpu_backend_enables_kernels(monkeypatch):
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert backend.gpu_kernels() is True
    assert backend.is_accelerator() is True


def test_device_info_reports_jax_devices():
    info = backend.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        backend.require_gpu()


def test_nvidia_smi_line_is_text():
    assert isinstance(backend.nvidia_smi_line(), str)


def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax; from voicemap import backend; "
            "print(backend.enable_compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-400:]
    return out.stdout.split()


def test_compile_cache_defaults_to_repo_dir():
    returned, configured = _cache_dir_in_child(None)
    assert returned == configured == os.path.join(REPO, ".jax_cache")


def test_compile_cache_respects_environment(tmp_path):
    returned, configured = _cache_dir_in_child(str(tmp_path))
    assert returned == configured == str(tmp_path)


def test_compile_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "/.jax_cache/" in f.read().split()
