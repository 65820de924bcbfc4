"""Quasiparticle dispersion of the transverse-field Ising chain.

VUMPS ground state + the tangent-space excitation ansatz
(mps/excitations.py) vs the exact free-fermion single-particle energy
epsilon(k) = 2 sqrt(1 + g^2 - 2 g cos k) — agreement to ~1e-10 at
D=8, g=1.5, including the gap 2|g-1| at k=0.  A capability beyond the
reference's surface (it has no excitation machinery at all).

Runs in x64 on any backend (~20 s on the CPU).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from qmps_tpu.ham import tfim
from qmps_tpu.mps.excitations import dispersion

if __name__ == "__main__":
    g, D = 1.5, 8
    h = jnp.asarray(np.asarray(tfim(g).to_matrix()))
    ps = np.linspace(0.0, np.pi, 13)
    om = dispersion(h, D=D, ps=ps, n_levels=1)
    exact = 2.0 * np.sqrt(1.0 + g * g - 2.0 * g * np.cos(ps))
    print(f"TFIM g={g}, D={D}  (gap at k=0: exact 2|g-1| = {2*abs(g-1):.3f})")
    print(f"{'k':>7} {'omega(k)':>12} {'exact':>12} {'delta':>10}")
    for p, w, e in zip(ps, om[:, 0], exact):
        print(f"{p:>7.4f} {w:>12.8f} {e:>12.8f} {w - e:>10.2e}")

    # spectral weights: the S(k, omega) delta-peak strengths of the order
    # operator Z — the one-particle band saturates the static structure
    # factor to ~99% in the paramagnetic phase
    from qmps_tpu.core.paulis import Z
    from qmps_tpu.mps import spectral_weights, vumps_ground_state
    from qmps_tpu.mps.tdvp import mixed_gauge

    AL, C, _, _ = vumps_ground_state(h, D, iters=250, k=32)
    gs = mixed_gauge(AL)
    Zj = jnp.asarray(np.asarray(Z))
    print(f"\n{'k':>7} {'omega_0':>10} {'weight |<Phi|Z_k|0>|^2':>22}")
    for p in (0.5, 1.5, 2.5):
        omw, wt = spectral_weights(*gs, h, Zj, p, n_levels=1)
        print(f"{p:>7.4f} {omw[0]:>10.6f} {wt[0]:>22.6f}")
