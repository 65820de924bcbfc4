"""Large-D ground states via Riemannian optimization on the isometry
manifold (BASELINE config 5's large-D leg).

The environment fixed point switches solver regime with D: dense
repeated squaring while the D^2 x D^2 transfer matrix is cheap, and the
matvec Krylov path above (restarted Arnoldi forward + fixed-shape GMRES
implicit adjoint, qmps_tpu/core/krylov.py) — the path that makes D = 64
gradients viable.  The reference tops out at D = 2 for its variational
circuits (scripts/bond_dimension.py reaches D = 16 only through the
classical xmps optimizer).

Run:  QMPS_TPU_X64=0 python examples/large_bond_dimension.py  (accelerator)
      python examples/large_bond_dimension.py                 (CPU f64)
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

if os.environ.get("QMPS_TPU_X64", "1") == "1":
    # float64 correctness mode is the CPU reference run
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from qmps_tpu.ham import tfim, tfim_gs_energy
from qmps_tpu.optim.riemann import ground_state_riemannian


def main():
    h = tfim(1.0).to_matrix()  # critical point: hardest for small D
    e_exact = float(tfim_gs_energy(1.0))
    # the CPU reference run stops at D=16 (minutes per rung above it)
    Ds = (4, 8, 16) if jax.default_backend() == "cpu" else (4, 8, 16, 32, 64)
    print(f"backend={jax.default_backend()}  exact E0 = {e_exact:.8f}")
    print(f"{'D':>3} {'energy':>12} {'error':>10} {'s (incl compile)':>17}")
    for D in Ds:
        t0 = time.perf_counter()
        _, e, hist = ground_state_riemannian(
            h, D=D, steps=250, key=jax.random.PRNGKey(1)
        )
        dt = time.perf_counter() - t0
        hist = np.asarray(hist)
        assert np.all(np.isfinite(hist))
        # e is the returned state's energy (evaluated at the returned
        # isometry) — the number printed is achievable by the state you get
        print(f"{D:>3} {e:>12.8f} {e - e_exact:>10.2e} {dt:>17.1f}")


if __name__ == "__main__":
    main()
