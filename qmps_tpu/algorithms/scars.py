"""Quantum many-body scars: PXP TDVP dynamics + Poincare maps.

JAX rebuild of scars.py and poincare_map/2body_scars.py: the 2-param
analytic scars tensor A(theta, phi), 2-site-unit-cell TDVP evolution via the
mixed-transfer objective (the reference's 8-qubit Hadamard-test circuit
collapses to -|x| exactly as in objectives.overlap), the classical TDVP
ODEs for cross-validation, and vmapped Poincare-map sweeps replacing
joblib.Parallel.
"""
from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import optax

from ..circuits.ansatze import scars_tensor
from ..ham.hamiltonian import scars_H
from ..mps.imps import merge
from ..objectives.overlap import tdvp_objective


def blocked_tensor(params) -> jnp.ndarray:
    """A12 = merge(A(th1, ph1), A(th2, ph2)) — the 2-site unit cell,
    params ordered [th1, ph1, ph2, th2] (scars.py:75-86)."""
    th1, ph1, ph2, th2 = params[0], params[1], params[2], params[3]
    return merge(scars_tensor(th1, ph1), scars_tensor(th2, ph2))


def scars_cost(params, current_params, W16) -> jnp.ndarray:
    """-|x| of E = Map(W (A12 x A12), B12 x B12): the TDVP overlap density
    (scars.py:75-111 scars_time_evolve_cost_function, circuit-free)."""
    A12 = blocked_tensor(current_params)
    B12 = blocked_tensor(params)
    return tdvp_objective(A12, B12, W16)


def scars_W(mu: float, dt: float):
    """W = expm(+i dt H(mu)) (the reference's sign convention, scars.py:27).
    Host numpy so jits capture a host constant."""
    import numpy as np
    import scipy.linalg

    return scipy.linalg.expm(1j * dt * np.asarray(scars_H(mu)))


@dataclasses.dataclass
class ScarsEvolver:
    """TDVP stepper for the scars manifold.

    The Trotter gate spans a 4-site window, so advancing physical time dt
    per step needs W = expm(+i (4 dt) H) — the same window-size factor the
    reference hardcodes (scars.py:189 `dt = 4 * t[1]-t[0]`; gen-1 uses 2 dt
    for its 2-site window, scripts/loschmidt.py:341)."""

    mu: float
    dt: float
    inner_steps: int = 120
    lr: float = 2e-2
    window_factor: float = 4.0

    def __post_init__(self):
        W = scars_W(self.mu, self.window_factor * self.dt)
        opt = optax.adam(self.lr)
        vg = jax.value_and_grad(scars_cost)

        @jax.jit
        def step(params):
            def inner(carry, _):
                p, s = carry
                v, g = vg(p, params, W)
                up, s = opt.update(g, s)
                return (optax.apply_updates(p, up), s), v

            (p, _), _ = jax.lax.scan(
                inner, (params, opt.init(params)), None, length=self.inner_steps
            )
            return p, scars_cost(p, params, W)  # value at the returned params

        self._step = step

    def simulate(self, p0, n_steps: int):
        """simulate_scars analogue (scars.py:157-169): returns the angle
        trajectory (n_steps, 4), wrapped to [0, 2 pi)."""
        params = jnp.asarray(p0, jnp.float64)
        traj = []
        for _ in range(n_steps):
            traj.append(jnp.mod(params, 2 * jnp.pi))
            params, _ = self._step(params)
        return jnp.stack(traj)


# -- classical TDVP ODEs (scars.py:176-199) -----------------------------------


def dtheta_dt(th1, ph1, ph2, th2):
    return jnp.tan(th2) * jnp.sin(th1) * jnp.cos(th1) ** 2 * jnp.cos(ph1) + jnp.cos(
        th2
    ) * jnp.cos(ph2)


def dphi_dt(th1, ph1, ph2, th2):
    return 2 * jnp.tan(th1) * jnp.cos(th2) * jnp.sin(ph2) - 0.5 * jnp.tan(
        th2
    ) * jnp.cos(th1) * jnp.sin(ph1) * (
        2 * jnp.sin(th2) ** -2 + jnp.cos(2 * th1) - 5
    )


def classical_rhs(angles, t, mu):
    th1, ph1, ph2, th2 = angles
    return jnp.stack(
        [
            dtheta_dt(th1, ph1, ph2, th2),
            -mu + dphi_dt(th1, ph1, ph2, th2),
            -mu + dphi_dt(th2, ph2, ph1, th1),
            dtheta_dt(th2, ph2, ph1, th1),
        ]
    )


def classical_trajectory(y0, ts, mu: float) -> jnp.ndarray:
    """odeint of the classical scars ODEs (scars.py:180-196)."""
    from jax.experimental.ode import odeint

    return odeint(lambda y, t: classical_rhs(y, t, mu), jnp.asarray(y0, jnp.float64), ts)


# -- Poincare maps (poincare_map/2body_scars.py) ------------------------------


def scars_energy(params, mu: float) -> jnp.ndarray:
    """<H(mu)> per 2-site cell of the scars state (for constant-energy
    initial conditions, 2body_scars.py:409-454)."""
    from ..mps.imps import iMPS

    A12 = blocked_tensor(params)
    psi = iMPS([A12])
    H = scars_H(mu)
    return psi.E2(H).real


def poincare_sections(
    trajs, plane_coord: int = 1, plane_value: float = jnp.pi, coords=(0, 3)
):
    """Interpolated plane crossings of a batch of angle trajectories
    (2body_scars.py:228-257): returns a list of (n_crossings, 2) arrays of
    the section coordinates, one per trajectory."""
    import numpy as np

    out = []
    for traj in np.asarray(trajs):
        x = traj[:, plane_coord]
        # ANGULAR distance to the plane, mapped to (-pi, pi]: trajectories
        # are wrapped to [0, 2 pi), so the raw difference jumps by ~2 pi at
        # the 0/2 pi seam and a naive sign test reports spurious crossings
        # there (verified: an orbit oscillating around 0, never reaching
        # pi, produced phantom section points)
        d = np.mod(x - plane_value + np.pi, 2 * np.pi) - np.pi
        sign = np.sign(d)
        # genuine upward crossing: sign change AND a step below the
        # Nyquist bound pi — the antipode seam jump is ~2 pi, while any
        # resolvable real crossing advances < pi per sample (faster
        # winding than pi/step is aliased and undetectable regardless)
        small = np.abs(d[1:] - d[:-1]) < np.pi
        idx = np.where((sign[:-1] < 0) & (sign[1:] >= 0) & small)[0]
        pts = []
        for i in idx:
            f = -d[i] / (d[i + 1] - d[i] + 1e-30)
            pts.append(traj[i] + f * (traj[i + 1] - traj[i]))
        pts = np.array(pts) if pts else np.zeros((0, traj.shape[1]))
        # the documented (n_crossings, len(coords)) shape also when empty
        out.append(pts[:, list(coords)])
    return out


def classical_poincare_sweep(keys_or_y0s, ts, mu: float):
    """vmapped ensemble of classical trajectories (replaces joblib.Parallel,
    2body_scars.py:14)."""
    y0s = jnp.asarray(keys_or_y0s)
    return jax.vmap(lambda y0: classical_trajectory(y0, ts, mu))(y0s)


def constant_energy_initial_conditions(
    key, n: int, mu: float, target_e: float, steps: int = 300, lr: float = 5e-2
):
    """Batch of angle 4-vectors on the <H(mu)> = target_e shell
    (2body_scars.py:409-454): random starts, gradient-projected onto the
    energy surface (replacing the reference's per-point scipy solves)."""

    def shell_loss(p):
        return (scars_energy(p, mu) - target_e) ** 2

    import optax

    opt = optax.adam(lr)

    def project(p0):
        def step(carry, _):
            p, s = carry
            g = jax.grad(shell_loss)(p)
            up, s = opt.update(g, s)
            return (optax.apply_updates(p, up), s), None

        (p, _), _ = jax.lax.scan(step, (p0, opt.init(p0)), None, length=steps)
        return p

    p0s = jax.random.uniform(key, (n, 4), minval=0.1, maxval=2 * jnp.pi - 0.1)
    return jax.jit(jax.vmap(project))(p0s)


def quantum_poincare_sweep(
    y0s, mu: float, dt: float, n_steps: int, inner_steps: int = 120, mesh=None
):
    """Ensemble of *quantum* TDVP trajectories, the vmapped analogue of the
    reference's joblib sweep over initial conditions: each outer step runs
    the warm-started inner optimization for the whole batch at once.  With
    a mesh, the ensemble axis is sharded across devices via shard_map
    (collectives-free data parallelism — trajectories are independent, so
    the sweep rides pure ICI-local work like parallel.sweep)."""
    import optax

    W = scars_W(mu, 4.0 * dt)
    opt = optax.adam(2e-2)
    vg = jax.value_and_grad(scars_cost)

    def one_step(params):
        def inner(carry, _):
            p, s = carry
            v, g = vg(p, params, W)
            up, s = opt.update(g, s)
            return (optax.apply_updates(p, up), s), v

        (p, _), _ = jax.lax.scan(inner, (params, opt.init(params)), None, length=inner_steps)
        return p

    from ..parallel.mesh import shard_over_sweep
    from .evolve import _cached_jit

    batch_step = _cached_jit(
        ("scars_qstep", float(mu), float(dt), inner_steps, mesh),
        lambda: jax.jit(shard_over_sweep(jax.vmap(one_step), mesh)),
    )
    ps = jnp.asarray(y0s, jnp.float64)
    traj = [jnp.mod(ps, 2 * jnp.pi)]
    for _ in range(n_steps - 1):
        ps = batch_step(ps)
        traj.append(jnp.mod(ps, 2 * jnp.pi))
    return jnp.stack(traj, axis=1)  # (batch, n_steps, 4)
