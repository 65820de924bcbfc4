"""Exact-physics oracles for validation (reference L7 layer).

- ``tfim_gs_energy(g)``: free-fermion TFIM ground-state energy per site
  (scripts/ground_state_finding.py:70-72).
- ``loschmidt_rate(t, g0, g1)``: exact quench rate function
  (qmps/exact_loschmidt.py:7-21).

Both are Gauss-Legendre quadratures in jnp so they jit/vmap, with enough
nodes for ~1e-12 accuracy (the integrands are smooth on (0, pi)).
"""
from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def _gl_nodes(n: int = 256):
    # cached as numpy (never cache jnp arrays created under a jit trace)
    x, w = np.polynomial.legendre.leggauss(n)
    # map [-1, 1] -> [0, pi]
    k = (x + 1) * (np.pi / 2)
    w = w * (np.pi / 2)
    return k, w


import jax


@jax.jit
def tfim_gs_energy(g) -> jnp.ndarray:
    """E0 per site of H = -ZZ + g X:  -(1/pi) Int_0^pi sqrt(1+g^2-2g cos k) dk.

    jitted: one compiled program instead of per-op eager dispatch."""
    k, w = (jnp.asarray(x) for x in _gl_nodes())
    g = jnp.asarray(g)
    eps = jnp.sqrt(1.0 + g[..., None] ** 2 - 2.0 * g[..., None] * jnp.cos(k))
    return -(eps * w).sum(-1) / jnp.pi


def tfim_gs_energy_f64(g) -> np.ndarray:
    """Host numpy float64 twin of ``tfim_gs_energy`` — same quadrature.

    The jitted version computes in the SESSION dtype: under the benches'
    f32 sessions (QMPS_TPU_X64=0) the 256-node weighted sum carries a
    ~1e-6 accumulation floor, which poisons SIGNED error columns — it
    surfaced as sweep min_error = -4.5e-6, energies apparently below the
    variational bound, with the state readout already f64-exact.  Use
    this twin wherever the oracle anchors an error column."""
    k, w = _gl_nodes()
    g = np.asarray(g, np.float64)[..., None]
    eps = np.sqrt(1.0 + g ** 2 - 2.0 * g * np.cos(k))
    return -(eps * w).sum(-1) / np.pi


def xy_gs_energy() -> float:
    """E0 per site of the XY chain H = sum (XX + YY): free fermions at half
    filling, E = -(1/pi) Int_{-pi/2}^{pi/2} 2|2 cos k| dk / 2 = -4/pi.
    The oracle for the reference's bond-dimension scaling experiment
    (scripts/bond_dimension.py:18), which published no anchor."""
    import math

    return -4.0 / math.pi


def _f(z, g0, g1) -> jnp.ndarray:
    """The boundary partition-function exponent f(z) of the TFIM quench.

    Uses a denser grid than the energy integral: near dynamical phase
    transitions the integrand develops an (integrable) log singularity.
    """
    k, w = _gl_nodes(4096)

    def theta(k, g):
        return jnp.arctan2(jnp.sin(k), g - jnp.cos(k)) / 2

    phi = theta(k, g0) - theta(k, g1)
    eps = -2 * jnp.sqrt((g1 - jnp.cos(k)) ** 2 + jnp.sin(k) ** 2)
    integrand = -1 / (2 * jnp.pi) * jnp.log(
        jnp.cos(phi) ** 2 + jnp.sin(phi) ** 2 * jnp.exp(-2 * z * eps)
    )
    return (integrand * w).sum(-1)


@jax.jit
def loschmidt_rate(t, g0, g1) -> jnp.ndarray:
    """Exact rate function lambda(t) = f(it) + f(-it) of the Loschmidt echo
    after a g0 -> g1 quench."""
    from ..config import CDTYPE

    t = jnp.asarray(t, CDTYPE)  # c128 in x64 mode, c64 in 32-bit sessions
    return jnp.real(_f(1j * t, g0, g1) + _f(-1j * t, g0, g1))


def xxz_gs_energy(delta: float) -> float:
    """Exact ground energy per site of H = sum (XX + YY + delta ZZ) in
    the gapped Neel phase delta > 1 (Yang-Yang 1966; Orbach-Walker sum):
    with lam = arccosh(delta),

        e = delta - 4 sinh(lam) [ 1/2 + 2 sum_{n>=1} 1/(1 + e^{2 n lam}) ]

    (the Pauli-convention x4 of the S.S form delta/4 - sinh(lam)(...)).
    The lam -> 0 limit recovers the Heisenberg value 1 - 4 ln 2.
    Validated here against cell-blocked VUMPS at D=16 to 1e-6
    (tests/test_tdvp_classical.py)."""
    import numpy as np

    if delta <= 1.0:
        raise ValueError("xxz_gs_energy covers the gapped phase delta > 1")
    lam = float(np.arccosh(delta))
    # the summand decays like e^{-2 n lam}: ~40/lam terms reach 1e-16
    # (a FIXED count silently truncates the lam -> 0 tail and the
    # Heisenberg limit comes out wrong by O(1))
    n_max = int(min(max(200.0, 40.0 / lam), 2e7))
    n = np.arange(1, n_max + 1)
    s = float(np.sum(1.0 / (1.0 + np.exp(np.minimum(2 * n * lam, 700.0)))))
    return delta - 4.0 * np.sinh(lam) * (0.5 + 2.0 * s)


def xxz_staggered_magnetization(delta: float) -> float:
    """Baxter's spontaneous staggered magnetization of the XXZ chain
    (delta > 1), in sigma^z units:

        m_s = prod_{n>=1} [ (1 - q^{2n}) / (1 + q^{2n}) ]^2,  q = e^{-lam}.

    The order parameter of the Neel phase: |<Z_even>| = |<Z_odd>| = m_s
    with opposite signs on the two sublattices (measured from the
    cell-blocked VUMPS state to 5e-4 at D=8)."""
    import numpy as np

    if delta <= 1.0:
        raise ValueError(
            "xxz_staggered_magnetization covers the gapped phase delta > 1"
        )
    lam = float(np.arccosh(delta))
    q = float(np.exp(-lam))
    n_max = int(min(max(400.0, 20.0 / lam), 2e7))
    q2n = q ** (2 * np.arange(1, n_max + 1))
    return float(np.prod(((1.0 - q2n) / (1.0 + q2n)) ** 2))
