"""Finite-entanglement scaling at criticality: extract the central charge.

At the TFIM critical point (g = 1) an iMPS at bond dimension D cannot
capture the diverging correlation length; instead it realizes an
effective length xi(D) and a half-chain entropy S(D), tied by the
finite-entanglement-scaling relation (Tagliacozzo et al., PRB 78,
024410; Pollmann et al., PRL 102, 255701)

    S = (c / 6) log xi + const,        c = 1/2 for the Ising CFT.

This study is BEYOND the reference's capability surface: it needs the
Schmidt spectrum, the subdominant transfer eigenvalue, and D-OPTIMAL
ground states, none of which gen-1/gen-2 expose (the reference caps at
D = 2-4 and never computes xi).  Each row here is a VUMPS solve
(mps.tdvp.vumps_ground_state — ground eigenvectors of the effective
Hamiltonians, converging where gradient descent stalls on the flat
entanglement-tail directions), warm-started by embedding the previous
D's solution (bond growth: random starts at large D leave the state in
a short-xi metastable plateau).

Run on the accelerator or on the CPU (~1 min for D <= 16); both in x64.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from qmps_tpu.ham import tfim, tfim_gs_energy
from qmps_tpu.mps.imps import iMPS
from qmps_tpu.mps.tdvp import vumps_ground_state


def grow(AL, D_new: int, key, eps: float = 1e-3) -> jnp.ndarray:
    """Embed a (d, D, D) tensor in the corner of a (d, D_new, D_new) one,
    plus eps noise so the new directions are optimizable (the D -> 2D
    warm start of scripts/bond_dimension.py, tensor-side).

    Everything happens inside one jit (AL enters as a runtime arg, the
    noise as float draws)."""
    d, D, _ = AL.shape
    ftype = jnp.float32 if AL.dtype == jnp.complex64 else jnp.float64
    k1, k2 = jax.random.split(key)

    def _embed(A, nre, nim):
        out = jnp.zeros((d, D_new, D_new), A.dtype).at[:, :D, :D].set(A)
        return out + eps * jax.lax.complex(nre, nim).astype(A.dtype)

    return jax.jit(_embed)(
        AL,
        jax.random.normal(k1, (d, D_new, D_new), ftype),
        jax.random.normal(k2, (d, D_new, D_new), ftype),
    )


def scaling_table(Ds=(4, 8, 12, 16), iters=300, g=1.0, key=None,
                  h=None, e_exact=None):
    """[(D, energy_error, S, xi, seconds)] rows at a critical point.

    Defaults to the critical TFIM (Ising CFT, c = 1/2); pass an explicit
    two-site ``h`` and its exact energy for other critical chains — e.g.
    the sublattice-rotated XY chain (free compact boson, c = 1)."""
    if h is None:
        h = jnp.asarray(np.asarray(tfim(g).to_matrix()))
        e_exact = float(tfim_gs_energy(g))
    else:
        h = jnp.asarray(np.asarray(h))
        e_exact = 0.0 if e_exact is None else float(e_exact)
    key = jax.random.PRNGKey(7) if key is None else key
    rows, prev = [], None
    for D in Ds:
        t0 = time.perf_counter()
        A0 = None if prev is None else grow(prev, D, key)
        AL, C, e, info = vumps_ground_state(h, D, iters=iters, k=32, A0=A0)
        st = iMPS([AL])
        rows.append((
            D,
            e - e_exact,
            float(st.entanglement_entropy()),
            float(st.correlation_length()),
            time.perf_counter() - t0,
        ))
        prev = AL
    return rows


def fit_central_charge(rows):
    """Least-squares slope of S vs log xi, scaled by 6."""
    S = np.array([r[2] for r in rows])
    xi = np.array([r[3] for r in rows])
    return 6.0 * np.polyfit(np.log(xi), S, 1)[0]


if __name__ == "__main__":
    # x64 throughout: float32 resolves the entanglement tail only up to
    # xi ~ 34 (the tail Schmidt weights s^2 drop below f32 eps), while
    # D=16 in x64 reaches xi ~ 103
    rows = scaling_table(Ds=(4, 8, 12, 16))
    print(f"{'D':>3} {'e_err':>10} {'S':>8} {'xi':>9} {'s':>7}")
    for D, err, S, xi, dt in rows:
        print(f"{D:>3} {err:>10.2e} {S:>8.4f} {xi:>9.3f} {dt:>7.1f}")
    c = fit_central_charge(rows)
    print(f"fitted central charge c = {c:.3f}   (Ising CFT: 0.5)")

    # second CFT: the critical XY chain (free compact boson, c = 1) —
    # the fit cleanly separates the two universality classes.  The D=4
    # row is excluded: XY's near-degenerate finite-D optima make it
    # basin-fragile (S/xi swing with XLA codegen details), while the
    # D=8..16 rows are reproducible; they give c = 0.90-0.94 — biased
    # below 1 by the marginal operator's log corrections, the known
    # slow FES convergence of c = 1 chains, and still 2x the Ising fit
    from qmps_tpu.ham import sublattice_rotate, xy
    from qmps_tpu.ham.exact import xy_gs_energy

    rows_xy = scaling_table(
        Ds=(8, 12, 16), iters=400,
        h=sublattice_rotate(xy()), e_exact=xy_gs_energy(),
    )
    print(f"XY chain: c = {fit_central_charge(rows_xy):.3f}   (exact: 1)")
