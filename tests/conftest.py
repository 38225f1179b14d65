"""Test harness configuration.

By default the tests run on a **faked 8-device CPU mesh** (SURVEY.md §4.5:
JAX's ``--xla_force_host_platform_device_count``), so every shard_map /
collective path runs without an accelerator. With ``JAX_PLATFORMS`` naming
an accelerator (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``) the
suite runs on that device instead.

Tests that need the card carry the ``gpu`` marker; the ``_gpu_only``
fixture below skips them elsewhere. The decision is made inside the
fixture, never at import time, so every xdist worker collects the same
tests.

This must run before any test module touches a jax backend.
"""

import os
import tempfile

ON_CPU_MESH = os.environ.get("JAX_PLATFORMS", "cpu").strip() in ("", "cpu")

if ON_CPU_MESH:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    # Persistent XLA compilation cache: the suite is compile-bound on the
    # CPU mesh, and test programs are identical across runs. Keyed by
    # HLO+flags, so code changes re-compile exactly what they touch.
    # JAX_COMPILATION_CACHE_DIR wins when set; otherwise VOICEMAP_TEST_CACHE
    # (empty disables it), by default under the temporary directory (TMPDIR).
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _cache = os.environ.get(
            "VOICEMAP_TEST_CACHE",
            os.path.join(tempfile.gettempdir(), "voicemap_xla_cache"))
        if _cache:
            jax.config.update("jax_compilation_cache_dir", _cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
else:
    import jax

import numpy as np
import pytest

from voicemap.data import synthetic


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU. On the card, f32
    parity tests compare against numpy at full float32 matmul precision
    (not TF32); tests of bf16 behaviour ask for bf16 dtypes explicitly."""
    if request.node.get_closest_marker("gpu") is None:
        yield
        return
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX's default backend is "
                    f"{jax.default_backend()!r})")
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="session")
def corpus_root(tmp_path_factory):
    """Small synthetic LibriSpeech-shaped corpus shared across the session."""
    root = tmp_path_factory.mktemp("corpus")
    spec = synthetic.SyntheticSpec(
        n_speakers=8,
        utterances_per_speaker=6,
        min_seconds=2.0,
        max_seconds=4.5,
        seed=42,
    )
    synthetic.generate_corpus(str(root), subsets=("dev-clean",), spec=spec)
    return str(root)


@pytest.fixture(scope="session")
def dataset(corpus_root):
    from voicemap.data.dataset import SpeakerDataset

    return SpeakerDataset(
        subsets=("dev-clean",),
        seconds=1.5,
        data_root=corpus_root,
        seed=7,
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_collection_modifyitems(config, items):
    """Fast-tier marking: node IDs listed in tests/slow_tests.txt get the
    ``slow`` marker (in addition to any inline ``@pytest.mark.slow``), so
    the inner dev loop can run ``-m "not slow"`` in ≤5 min while the full
    suite stays the pre-commit bar. See slow_tests.txt for the criterion."""
    listed = set()
    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    if not os.path.exists(path):
        return  # no fast-tier list — every test simply stays unmarked
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                listed.add(line)
    matched = set()
    for item in items:
        nid = item.nodeid.replace(os.sep, "/")
        if nid in listed:
            item.add_marker(pytest.mark.slow)
            matched.add(nid)
    # Stale-entry guard (r4 advice): a renamed/re-parametrized slow test
    # silently falls back into the fast tier unless someone notices. Only
    # meaningful on full collection — a path/keyword-restricted run
    # legitimately collects a subset.
    stale = listed - matched
    if stale:
        collected = {i.nodeid.replace(os.sep, "/") for i in items}
        # Heuristic for "full collection": the majority of listed files are
        # present among collected files.
        listed_files = {e.split("::")[0] for e in listed}
        collected_files = {n.split("::")[0] for n in collected}
        if len(listed_files & collected_files) >= max(1, len(listed_files) // 2):
            import warnings

            warnings.warn(
                "tests/slow_tests.txt entries matched no collected test "
                "(renamed or re-parametrized? they now run in the fast "
                f"tier): {sorted(stale)}",
                stacklevel=1,
            )
