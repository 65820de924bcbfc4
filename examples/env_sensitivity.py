"""Gen-2 environment sensitivity studies: the eta(dt) fit and the
M-ansatz parameter stiffness spectrum.

The batched-JAX analogue of the reference's two exploratory studies:

- ``new_tdvp/RightEnvParametrisation.py:1-162`` fits polynomials to the
  mixed-transfer dominant eigenvalue eta as a function of the TDVP step
  size dt, to justify the bounded-eta environment solve
  (``loschmidt_classical.py:196-219``: eta constrained to [1-5dt^2, 1]).
  Here the fit is done against the *converged* brickwork TDVP step at
  each dt: we extract |eta| of the mixed map both with the window gate W
  (the per-site step fidelity the stepper maximizes) and without it (the
  raw state motion), fit 1-|eta| = c2 dt^2 + c3 dt^3 by least squares,
  and check the reference's bound constant c2 <= 5 actually holds on
  this manifold.

- ``new_tdvp/EnvironmentParamSensitivity.py:1-103`` probes how sensitive
  the environment objective is to each of the 6 M-ansatz parameters.
  Here that is the exact Hessian (one ``jax.hessian`` call instead of
  finite-difference scans) of the represent residual
  |eta M(p) - E[M(p)]|_F^2 at the variational optimum: its eigenvalue
  spectrum separates the stiff directions (curvature ~ O(1)) from the
  sloppy ones (gauge/phase freedom of the ansatz, curvature ~ 0) — the
  quantitative version of the reference's scatter plots.

Run:  python examples/env_sensitivity.py        (~1 min on CPU)
"""
import os
import sys

os.environ.setdefault("QMPS_TPU_X64", "1")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import optax

from qmps_tpu.algorithms.brickwork_tdvp import (
    evolve_cost_eig,
    optimize_brickwork,
    quench_window_gate,
)
from qmps_tpu.circuits.brickwork import (
    env_M,
    exact_right_env,
    param_bricks,
    right_env_map,
)
from qmps_tpu.env.variational import represent_variational_M
from qmps_tpu.ham import tfim


def tdvp_step(params, W, inner_steps: int = 250, lr: float = 2e-2):
    """One warm-started TDVP step with W as a traced argument (one compile
    for the whole dt grid, unlike BrickworkEvolver's captured-W jit)."""

    @jax.jit
    def run(p0, Wv):
        opt = optax.adam(lr)
        vg = jax.value_and_grad(evolve_cost_eig)

        def inner(carry, _):
            p, s = carry
            _, g = vg(p, p0, Wv)
            up, s = opt.update(g, s)
            return (optax.apply_updates(p, up), s), None

        (p, _), _ = jax.lax.scan(
            inner, (p0, opt.init(p0)), None, length=inner_steps
        )
        return p

    return run(params, jnp.asarray(W))


def eta_dt_study(p_gs, g_quench: float, dts):
    """|eta|(dt) of the converged TDVP step, with and without W."""
    h1 = np.asarray(tfim(g_quench).to_matrix())
    rows = []
    for dt in dts:
        W = quench_window_gate(h1, float(dt))
        p_new = tdvp_step(p_gs, W)
        # per-site step fidelity: the objective the stepper maximizes
        eta_W = float(jnp.sqrt(-evolve_cost_eig(p_new, p_gs, jnp.asarray(W))))
        # raw state motion: mixed transfer of psi(t) against psi(t+dt)
        U1, U2 = param_bricks(p_gs)
        U1p, U2p = param_bricks(p_new)
        eta_mixed, _ = exact_right_env(U1, U2, U1p.conj().T, U2p.conj().T)
        rows.append((float(dt), eta_W, float(jnp.abs(eta_mixed))))
    return rows


def fit_eta_poly(rows, col: int):
    """Least-squares 1-|eta| = c2 dt^2 + c3 dt^3 (the reference's
    polynomial fit, RightEnvParametrisation.py bottom-of-file study)."""
    dt = np.array([r[0] for r in rows])
    y = 1.0 - np.array([r[col] for r in rows])
    A = np.stack([dt**2, dt**3], axis=1)
    (c2, c3), *_ = np.linalg.lstsq(A, y, rcond=None)
    resid = float(np.max(np.abs(A @ np.array([c2, c3]) - y)))
    return float(c2), float(c3), resid


def m_param_stiffness(p_gs):
    """Hessian spectrum of the represent residual at the variational
    optimum (EnvironmentParamSensitivity.py, exact derivatives)."""
    U1, U2 = param_bricks(p_gs)
    U1d, U2d = U1.conj().T, U2.conj().T
    eta, M, res = represent_variational_M(U1, U2, U1d, U2d, steps=800)

    # recover the optimizer's raw parameter vector by re-solving the 6
    # angles is unnecessary: probe the loss surface directly in the
    # (eta, p6) chart around a fresh converged solve
    def loss(x):
        e, p = x[0], x[1:]
        Mp = env_M(p)
        EM = right_env_map(U1, U2, U1d, U2d, Mp)
        return jnp.sum(jnp.abs(e * Mp - EM) ** 2)

    # converge in the chart (adam, then read the Hessian there)
    x = jnp.concatenate([jnp.real(eta)[None], jnp.array([jnp.pi / 4, 0, 0, 0, 0, 0])])
    opt = optax.adam(2e-2)

    @jax.jit
    def run(x0):
        def step(carry, _):
            xv, s = carry
            g = jax.grad(loss)(xv)
            up, s = opt.update(g, s)
            return (optax.apply_updates(xv, up), s), None

        (xv, _), _ = jax.lax.scan(step, (x0, opt.init(x0)), None, length=1500)
        return xv

    x = run(x)
    H = np.asarray(jax.hessian(loss)(x))
    evals = np.linalg.eigvalsh(H)
    return float(loss(x)), evals, float(jnp.abs(eta)), float(res)


def main():
    g0, g1 = 1.5, 0.2  # the reference's production quench
    h0 = tfim(g0).to_matrix()
    res = optimize_brickwork(h0, steps=500, method="adam")
    p_gs = res.x
    print(f"brickwork ground state at g={g0}: E = {float(res.fun):+.6f}")

    dts = np.array([0.005, 0.01, 0.02, 0.03, 0.05, 0.08, 0.12])
    rows = eta_dt_study(p_gs, g1, dts)
    print("\n   dt      |eta_W|       |eta_mixed|")
    for dt, eW, eM in rows:
        print(f"  {dt:5.3f}   {eW:.8f}   {eM:.8f}")

    c2W, c3W, rW = fit_eta_poly(rows, 1)
    c2M, c3M, rM = fit_eta_poly(rows, 2)
    print(f"\nfit 1-|eta_W|     = {c2W:+.3f} dt^2 {c3W:+.3f} dt^3  (max resid {rW:.1e})")
    print(f"fit 1-|eta_mixed| = {c2M:+.3f} dt^2 {c3M:+.3f} dt^3  (max resid {rM:.1e})")
    bound_ok = all(1 - 5 * dt * dt <= eM + 1e-12 for dt, _, eM in rows)
    print(f"reference bound eta >= 1 - 5 dt^2 holds on the grid: {bound_ok}")

    loss_opt, evals, eta_self, res_self = m_param_stiffness(p_gs)
    print(f"\nself-environment represent: |eta| = {eta_self:.6f}, residual {res_self:.2e}")
    print(f"M-chart Hessian eigenvalues at the optimum (stiff -> sloppy):")
    print("  " + "  ".join(f"{v:+.3e}" for v in evals[::-1]))
    n_sloppy = int(np.sum(np.abs(evals) < 1e-3 * np.max(np.abs(evals))))
    print(f"sloppy (gauge) directions: {n_sloppy} of {len(evals)}")

    assert bound_ok, "eta(dt) violated the reference's 1-5dt^2 bound"
    assert c2M < 5.0, f"mixed-eta curvature {c2M} exceeds the bound constant"
    print("\nenv sensitivity study OK")


if __name__ == "__main__":
    main()
