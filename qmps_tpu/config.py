"""Global numerics / device policy.

The reference gets 1e-10 agreement by running float64 scipy/numpy on CPU.  We
keep complex128 as the *correctness* dtype (tests, parity checks) and
complex64 as the *speed* dtype for accelerator hot loops; every hot-path entry point
takes an explicit ``dtype=`` so callers choose.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp

#: correctness dtype — all tests and parity checks run in this.  When the
#: package was imported with QMPS_TPU_X64=0 (32-bit accelerator runs),
#: requests for 64-bit dtypes would be silently truncated anyway, so point
#: the aliases at the 32-bit types to keep dtype handling explicit and
#: warning-free.
if jax.config.jax_enable_x64:
    CDTYPE = jnp.complex128
    RDTYPE = jnp.float64
else:
    CDTYPE = jnp.complex64
    RDTYPE = jnp.float32

# numpy twins for module-level constants (host arrays embed into a jitted
# program as literals)
import numpy as _np  # noqa: E402

NP_CDTYPE = _np.complex128 if jax.config.jax_enable_x64 else _np.complex64
NP_RDTYPE = _np.float64 if jax.config.jax_enable_x64 else _np.float32

#: accelerator hot-path dtype.
FAST_CDTYPE = jnp.complex64
FAST_RDTYPE = jnp.float32


def _enable_compile_cache():
    """Persistent compilation cache for accelerator runs.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and this sets
    nothing.  Otherwise the cache lives at a fixed ``<checkout>/.jax_cache``
    (a fixed path: the directory is part of the cache key).  A process
    pinned to the CPU keeps no cache: XLA:CPU entries depend on the host's
    microarchitecture, and loading one compiled elsewhere risks SIGILL.
    The platform check reads the config, so no backend is initialized at
    import time."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or jax.config.jax_platforms == "cpu":
        return
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_compilation_cache_dir", os.path.join(checkout, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


_enable_compile_cache()


@dataclasses.dataclass(frozen=True)
class Precision:
    """Bundle of dtypes threaded through hot paths."""

    cdtype: jnp.dtype = CDTYPE
    rdtype: jnp.dtype = RDTYPE

    @classmethod
    def fast(cls) -> "Precision":
        return cls(cdtype=FAST_CDTYPE, rdtype=FAST_RDTYPE)


DEFAULT = Precision()
FAST = Precision.fast()
