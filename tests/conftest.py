"""Test harness config: run everything on an 8-device virtual CPU mesh so the
multi-device sharding paths compile and execute without an accelerator.

Tests that need a real GPU are marked ``gpu`` and take the ``gpu_only``
fixture, which skips them unless JAX's default backend is a GPU (decided
inside the fixture, never at import).  On a machine with a GPU run them
with ``QMPS_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu``, which leaves
JAX on its default platform."""
import os

ON_GPU = os.environ.get("QMPS_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"  # correctness suite runs on CPU x64
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    # the suite is compile-bound on one CPU core; cheap codegen cuts its
    # wall time ~25% with every tolerance unchanged (correctness comes
    # from x64, not LLVM optimization level)
    if "backend_optimization_level" not in flags:
        flags += (
            " --xla_backend_optimization_level=0"
            " --xla_llvm_disable_expensive_passes=true"
        )
    os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

if not ON_GPU:
    # pin the platform in the config too, in case jax was imported before
    # conftest set the environment variable
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# The suite is compile-bound on one CPU core.  A persistent compilation
# cache makes every run after the first start warm; correctness is
# unaffected — XLA keys the cache on the full HLO + flags.  Where
# JAX_COMPILATION_CACHE_DIR is set JAX uses it and nothing is set here;
# otherwise override the location with JAX_TEST_CACHE_DIR, or disable with
# JAX_TEST_CACHE_DIR=off.
def _host_tag():
    """CPU-feature fingerprint folded into the cache path: XLA:CPU AOT
    entries are microarch-specific, and loading an entry compiled on a
    host with different vector extensions risks SIGILL.  A new host gets
    a fresh (empty) cache instead of a dangerous one."""
    import hashlib
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            # x86 Linux: 'flags'; aarch64 Linux: 'Features'; elsewhere
            # (e.g. macOS, no /proc) fall back to the machine arch alone
            # so different architectures still get distinct caches
            line = next(
                (l for l in f if l.startswith(("flags", "Features"))), ""
            )
    except Exception:
        line = ""
    return hashlib.sha1((platform.machine() + line).encode()).hexdigest()[:10]


_cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.environ.get(
    "JAX_TEST_CACHE_DIR",
    os.path.expanduser(f"~/.cache/qmps_tpu_test_xla_{_host_tag()}"),
)
if _cache_dir != "off" and not ON_GPU:
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def gpu_only():
    """Skip unless JAX's default backend is a GPU (see the module doc)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled Triton kernel "
                    "(QMPS_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu)")
