"""TFIM phase diagram as one sharded XLA program (BASELINE config 4).

Run:  python examples/phase_diagram.py          (uses all local devices)
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          python examples/phase_diagram.py      (8-way virtual CPU mesh)
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

if os.environ.get("QMPS_TPU_X64", "1") == "1":
    # float64 correctness mode is the CPU reference run; QMPS_TPU_X64=0
    # runs 32-bit on the default device
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from qmps_tpu.ham import tfim_gs_energy
from qmps_tpu.parallel import make_mesh, sweep_ground_states


def main():
    n_dev = len(jax.devices())
    n_points = 64 * max(1, n_dev)
    gs = jnp.linspace(0.1, 2.0, n_points)
    mesh = make_mesh() if n_dev > 1 else None
    t0 = time.perf_counter()
    # refine_passes=1: adiabatic-continuation re-optimization from each
    # point's neighbors (kills the occasional bad-basin outlier)
    es, _ = sweep_ground_states(gs, D=2, steps=300, mesh=mesh, refine_passes=1)
    es.block_until_ready()
    dt = time.perf_counter() - t0
    exact = np.asarray(tfim_gs_energy(gs))
    err = np.asarray(es) - exact
    print(f"{n_points} ground states on {n_dev} device(s) in {dt:.2f}s "
          f"({n_points/dt:.1f} opts/s)")
    print(f"max error vs exact integral: {err.max():.2e}; "
          f"all above exact: {bool((err > -1e-8).all())}")

    # The fused Riemannian engine: same physics, no expm chart; on a GPU
    # two Triton launches per optimizer step for the whole batch (the
    # engine default picks the kernel there and plain XLA elsewhere)
    from qmps_tpu.parallel.sweep import sweep_ground_states_fused

    t0 = time.perf_counter()
    es_f, _ = sweep_ground_states_fused(
        gs, steps=300, restarts=2, chunk=50, mesh=mesh,
    )
    es_f.block_until_ready()
    dt_f = time.perf_counter() - t0
    err_f = np.asarray(es_f) - exact
    print(f"fused engine: {dt_f:.2f}s ({n_points/dt_f:.1f} opts/s), "
          f"max error {err_f.max():.2e}")

    # Bond-growth continuation to D=4: every point warm-starts from its
    # own D=2 optimum through the exact linear su(N) embedding
    # (core/lie.grow_su_params), so no point can land in a worse basin
    # than the D=2 sweep found — the move that heals the attractive
    # bad basins refine passes can't reach at D=32
    from qmps_tpu.parallel import sweep_ground_states_grown

    t0 = time.perf_counter()
    es_g, _ = sweep_ground_states_grown(gs, D=4, steps=300, mesh=mesh)
    es_g.block_until_ready()
    dt_g = time.perf_counter() - t0
    err_g = np.asarray(es_g) - exact
    print(f"grown D=4 ladder: {dt_g:.2f}s, max error {err_g.max():.2e} "
          f"(D=2 sweep above: {err.max():.2e})")


if __name__ == "__main__":
    main()
