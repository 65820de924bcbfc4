"""Variational ground-state search.

Functional core + thin class wrappers named after the reference optimizer
family (qmps/ground_state.py:120-526).  Every optimizer minimizes a pure
jitted energy objective with exact gradients; the scipy bridge reproduces
the reference's Nelder-Mead behavior when requested.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..circuits import ansatze
from ..embed.unitaries import unitary_to_tensor
from ..ham.hamiltonian import Hamiltonian, as_host_matrix
from ..objectives.energy import (
    energy_exact_env,
    energy_joint_env_purity,
    energy_two_site,
)
from ..optim.minimize import OptResult, minimize_adam, minimize_lbfgs, minimize_scipy
from ..optim.rotosolve import rotosolve


@dataclasses.dataclass
class GroundStateResult:
    params: jnp.ndarray
    energy: float
    history: Optional[jnp.ndarray]
    U: jnp.ndarray
    A: jnp.ndarray


def _ansatz_builder(ansatz: str, D: int) -> Callable:
    if ansatz == "suN":
        return lambda p: ansatze.full_state_suN(p, D)
    if ansatz == "full15":
        assert D == 2
        return ansatze.shallow_full_state
    builder = ansatze.STATE_ANSATZE[ansatz]
    return lambda p: builder(D, p)


def n_params(ansatz: str, D: int, depth: int = 2) -> int:
    if ansatz == "suN":
        return (2 * D) ** 2 - 1
    if ansatz == "full15":
        return 15
    if ansatz == "su4":
        return 15
    per_layer = {"qaoa": 2, "cnot": 2, "cnot3": 3, "exact_after_4": 6}.get(ansatz)
    if ansatz == "cnot_nonuniform":
        per_layer = 2 * (int(D).bit_length())
    return per_layer * depth


def _opt_scan_core(loss, opt, steps, lbfgs=False):
    """(x0, hre, him) -> (x, hist, e_final): the optimize-and-evaluate scan
    shared by every compiled ground-state program below.  hist carries the
    per-step pre-update losses; e_final is the RETURNED state's energy
    (never best-of-history)."""
    import optax

    vg = jax.value_and_grad(loss)

    def core(x0, hre, him):
        def step(carry, _):
            x, s = carry
            v, g = vg(x, hre, him)
            if lbfgs:
                up, s = opt.update(
                    g, s, x, value=v, grad=g,
                    value_fn=lambda x_: loss(x_, hre, him),
                )
            else:
                up, s = opt.update(g, s)
            return (optax.apply_updates(x, up), s), v

        (x, _), hist = jax.lax.scan(step, (x0, opt.init(x0)), None, length=steps)
        return x, hist, loss(x, hre, him)

    return core


def _recycled_opt_scan_core(loss_env, opt, steps, recycle_iters, final_iters=200):
    """(x0, r0) -> (x, hist, e_final): the adam-with-recycled-environment
    counterpart of _opt_scan_core, shared by the deep-brickwork program and
    the sweep's per-point optimizer.  loss_env(x, r, iters) -> (value,
    r_new); the environment rides the scan carry behind a stop_gradient
    (the recycled start is an accelerator, not part of the differentiated
    graph — transfer.right_eigpair_warm gives r0 a zero cotangent, so no
    cross-step backward chain forms).  e_final is a boosted ``final_iters``
    evaluation at the returned x: reported energies are the returned
    state's, never the recycled residual."""
    import optax

    vg = jax.value_and_grad(
        lambda x, r: loss_env(x, jax.lax.stop_gradient(r), recycle_iters),
        has_aux=True,
    )

    def core(x0, r0):
        def step(carry, _):
            x, s, r = carry
            (v, r_new), g = vg(x, r)
            up, s = opt.update(g, s)
            # r_new is unit-Frobenius by construction (right_eigpair_warm
            # normalizes every matvec) — no re-normalization needed
            return (optax.apply_updates(x, up), s, r_new), v

        from ..mps.transfer import _match_vma

        # under shard_map the replicated identity start r0 must carry the
        # varying axes of the per-shard parameters (scan carry type check)
        (x, _, r), hist = jax.lax.scan(
            step, (x0, opt.init(x0), _match_vma(r0, x0)), None, length=steps
        )
        e, _ = loss_env(x, r, final_iters)
        return x, hist, e

    return core


def _recycled_r0(D: int, ftype) -> jnp.ndarray:
    """Unit-Frobenius identity start for the recycled environment (PSD, so
    power iteration from it is monotone for A == B maps)."""
    ctype = jnp.complex128 if ftype == jnp.float64 else jnp.complex64
    r0 = jnp.eye(D, dtype=ctype)
    return r0 / jnp.linalg.norm(r0)


@functools.lru_cache(maxsize=32)
def _gs_program(ansatz: str, D: int, method: str, steps: int):
    """One compiled optimize-and-finalize program per configuration.

    The Hamiltonian matrix rides as a traced argument, so every H of the
    same shape/dtype — each g of a phase scan, TFIM and XY alike — reuses
    one executable, and the final energy/U/A are computed inside the same
    program (a fresh loss closure per call would recompile the whole
    optimizer scan each time, plus two extra jits for the finalize).
    H crosses the host->device boundary as float real/imag planes and is
    assembled with lax.complex in-program."""
    import optax

    build = _ansatz_builder(ansatz, D)

    def loss(p, hre, him):
        return energy_exact_env(build(p), jax.lax.complex(hre, him))

    if method == "adam":
        sched = optax.cosine_decay_schedule(1e-2, steps, alpha=0.05)
        opt = optax.adam(sched)
    else:
        opt = optax.lbfgs()
    core = _opt_scan_core(loss, opt, steps, lbfgs=(method == "lbfgs"))

    @jax.jit
    def run(x0, hre, him):
        x, hist, e = core(x0, hre, him)
        U = build(x)
        return x, hist, e, U, unitary_to_tensor(U)

    return run


def _h_planes(h):
    """Host float real/imag planes of a Hamiltonian matrix (the jit
    argument form; dtypes canonicalize with the x64 flag)."""
    import numpy as np

    h = np.asarray(h)
    return jnp.asarray(np.ascontiguousarray(h.real)), jnp.asarray(
        np.ascontiguousarray(h.imag)
    )


def find_ground_state(
    H,
    D: int = 2,
    ansatz: str = "suN",
    depth: int = 2,
    method: str = "lbfgs",
    steps: int = 500,
    initial_guess: jnp.ndarray | None = None,
    key=None,
) -> GroundStateResult:
    """Minimize <h> over the circuit-MPS manifold.

    H may be a Hamiltonian or a dense 4x4 matrix.  ansatz in
    {'suN', 'full15', 'cnot', 'qaoa', 'cnot3', 'exact_after_4', ...};
    method in {'adam', 'lbfgs', 'rotosolve', 'Nelder-Mead', 'Powell', ...}.
    """
    h = as_host_matrix(H)
    if initial_guess is None:
        key = jax.random.PRNGKey(0) if key is None else key
        initial_guess = jax.random.normal(key, (n_params(ansatz, D, depth),)) * 0.5

    if method in ("adam", "lbfgs"):
        run = _gs_program(ansatz, D, method, steps)
        x, hist, e, U, A = run(initial_guess, *_h_planes(h))
        return GroundStateResult(
            params=x, energy=float(e), history=hist, U=U, A=A
        )

    build = _ansatz_builder(ansatz, D)

    def loss(p):
        return energy_exact_env(build(p), h)

    res = _run(loss, initial_guess, method, steps)
    # final build as one compiled program
    U, A = jax.jit(lambda p: ((lambda u: (u, unitary_to_tensor(u)))(build(p))))(res.x)
    return GroundStateResult(
        params=res.x,
        energy=float(res.fun),
        history=res.history,
        U=U,
        A=A,
    )


def _run(loss, x0, method, steps, stateful: bool = False) -> OptResult:
    if method == "adam":
        return minimize_adam(loss, x0, steps=steps)
    if method == "lbfgs":
        return minimize_lbfgs(loss, x0, steps=steps)
    if method == "rotosolve":
        x, hist = rotosolve(loss, x0, n_sweeps=max(1, steps // 10))
        # final evaluation as one compiled program
        return OptResult(x=x, fun=float(jax.jit(loss)(x)), history=hist, nit=steps)
    return minimize_scipy(loss, x0, method=method, jit_objective=not stateful)


# -- reference-named wrappers -------------------------------------------------


class _OptimizerBase:
    """Settings-dict interface matching qmps/tools.py:203-284."""

    def __init__(self):
        self.settings = {
            "maxiter": 500,
            "verbose": False,
            "method": "lbfgs",
            "tol": 1e-8,
            "store_values": True,
        }
        self.obj_fun_values = None
        self.optimized_result: OptResult | None = None

    def change_settings(self, new_settings):
        self.settings.update(new_settings)

    def objective_function(self, params):
        raise NotImplementedError

    #: subclasses with per-evaluation state (e.g. a PRNG split for shot
    #: noise) set this so the scipy bridge does not jit the objective
    _stateful_objective = False

    def optimize(self):
        res = _run(
            self.objective_function,
            self.initial_guess,
            self.settings["method"],
            self.settings["maxiter"],
            stateful=self._stateful_objective,
        )
        self.optimized_result = res
        if res.history is not None:
            self.obj_fun_values = res.history
        self.update_state()
        return res

    def update_state(self):
        pass


class NonSparseFullEnergyOptimizer(_OptimizerBase):
    """Full SU(2D) parametrization, exact environment
    (qmps/ground_state.py:230-269)."""

    def __init__(self, H, D: int = 2, initial_guess=None, key=None):
        super().__init__()
        self.h = as_host_matrix(H)
        self.D = D
        if initial_guess is None:
            key = jax.random.PRNGKey(0) if key is None else key
            initial_guess = jax.random.normal(key, ((2 * D) ** 2 - 1,)) * 0.5
        self.initial_guess = jnp.asarray(initial_guess)

    def objective_function(self, params):
        return energy_exact_env(ansatze.full_state_suN(params, self.D), self.h)

    def update_state(self):
        self.U = ansatze.full_state_suN(self.optimized_result.x, self.D)


class SparseFullEnergyOptimizer(_OptimizerBase):
    """Shallow-ansatz optimizer, exact env or jointly optimized env with the
    purity penalty (qmps/ground_state.py:120-228)."""

    def __init__(
        self,
        H,
        D: int = 2,
        depth: int = 2,
        ansatz: str = "cnot",
        optimize_environment: bool = False,
        initial_guess=None,
        key=None,
    ):
        super().__init__()
        self.h = as_host_matrix(H)
        self.D = D
        self.optimize_environment = optimize_environment
        if optimize_environment:
            self._np = 30
            self.build = None
        else:
            self.build = _ansatz_builder(ansatz, D)
            self._np = n_params(ansatz, D, depth)
        if initial_guess is None:
            key = jax.random.PRNGKey(0) if key is None else key
            initial_guess = jax.random.normal(key, (self._np,)) * 0.5
        self.initial_guess = jnp.asarray(initial_guess)

    def objective_function(self, params):
        if self.optimize_environment:
            return energy_joint_env_purity(params, self.h)
        return energy_exact_env(self.build(params), self.h)

    def update_state(self):
        if not self.optimize_environment:
            self.U = self.build(self.optimized_result.x)


class NoisyNonSparseFullEnergyOptimizer(_OptimizerBase):
    """Full 15-param SU(4) state under per-moment depolarizing noise, exact
    environment (qmps/ground_state.py:337-418) — gradient-optimizable in
    both params and noise strength.

    ``simulation`` selects the channel semantics, mirroring the
    reference's two noisy simulator modes: "density_matrix" (exact 4^n
    evolution, objectives/noise.py) or "trajectories" (Monte-Carlo Kraus
    unraveling at 2^n per trajectory, vmapped — objectives/trajectories.py;
    the route to wider noisy windows).  Trajectory mode uses a FROZEN key
    per optimizer instance (common random numbers), so the stochastic
    objective is a smooth deterministic function the optimizer can descend.
    """

    def __init__(
        self,
        H,
        depolarizing_prob: float,
        initial_guess=None,
        key=None,
        simulation: str = "density_matrix",
        n_traj: int = 256,
        traj_key=None,
    ):
        super().__init__()
        self.h = as_host_matrix(H)
        self.p_noise = depolarizing_prob
        if simulation not in ("density_matrix", "trajectories"):
            raise ValueError(f"unknown simulation mode {simulation!r}")
        self.simulation = simulation
        self.n_traj = n_traj
        self.traj_key = jax.random.PRNGKey(42) if traj_key is None else traj_key
        if initial_guess is None:
            key = jax.random.PRNGKey(0) if key is None else key
            initial_guess = jax.random.normal(key, (15,)) * 0.5
        self.initial_guess = jnp.asarray(initial_guess)

    def objective_function(self, params):
        from ..circuits.ansatze import shallow_full_state, shallow_full_state_ops
        from ..env.exact import get_env_exact
        from ..objectives.noise import noisy_energy

        ops, n = shallow_full_state_ops(params)
        V = get_env_exact(shallow_full_state(params))
        if self.simulation == "trajectories":
            from ..objectives.trajectories import trajectory_energy

            return trajectory_energy(
                ops, n, V, self.h, self.p_noise, self.traj_key, self.n_traj
            )
        return noisy_energy(ops, n, V, self.h, self.p_noise)


class NoisySparseFullEnergyOptimizer(_OptimizerBase):
    """Shallow-ansatz state under depolarizing noise
    (qmps/ground_state.py:420-480)."""

    def __init__(
        self, H, depolarizing_prob: float, D: int = 2, depth: int = 2,
        ansatz: str = "cnot", initial_guess=None, key=None,
    ):
        super().__init__()
        self.h = as_host_matrix(H)
        self.p_noise = depolarizing_prob
        self.D = D
        self.ansatz = ansatz
        if initial_guess is None:
            key = jax.random.PRNGKey(0) if key is None else key
            initial_guess = jax.random.normal(key, (n_params(ansatz, D, depth),)) * 0.5
        self.initial_guess = jnp.asarray(initial_guess)

    def objective_function(self, params):
        from ..circuits.ansatze import STATE_ANSATZE, STATE_ANSATZE_OPS
        from ..env.exact import get_env_exact
        from ..objectives.noise import noisy_energy

        ops, n = STATE_ANSATZE_OPS[self.ansatz](self.D, params)
        V = get_env_exact(STATE_ANSATZE[self.ansatz](self.D, params))
        return noisy_energy(ops, n, V, self.h, self.p_noise)


class NoisySparseSampledEnergyOptimizer(_OptimizerBase):
    """Noise + finite shots (a working version of the reference's
    unfinished qmps/ground_state.py:482-526): the energy is measured
    Pauli-string-by-Pauli-string on the noisy state with ``n_samples``
    shots.  Shot noise makes the objective stochastic — pair with the
    scipy Nelder-Mead bridge or rotosolve, as the reference intended."""

    def __init__(
        self, H: Hamiltonian, depolarizing_prob: float = 0.0, D: int = 2,
        depth: int = 2, ansatz: str = "cnot", n_samples: int = 10000,
        initial_guess=None, key=None,
    ):
        super().__init__()
        assert isinstance(H, Hamiltonian), "needs the Pauli strings to measure"
        self.H = H
        self.p_noise = depolarizing_prob
        self.D = D
        self.ansatz = ansatz
        self.n_samples = n_samples
        self.key = jax.random.PRNGKey(17) if key is None else key
        if initial_guess is None:
            initial_guess = jax.random.normal(self.key, (n_params(ansatz, D, depth),)) * 0.5
        self.initial_guess = jnp.asarray(initial_guess)
        self.settings["method"] = "Nelder-Mead"

    def optimize(self):
        if self.settings["method"] in ("adam", "lbfgs", "rotosolve"):
            raise ValueError(
                "the sampled objective draws fresh shot noise per evaluation "
                "(stateful PRNG key), which cannot live inside a jitted "
                "optimizer loop — use a scipy method ('Nelder-Mead', "
                "'Powell'), as the reference does"
            )
        return super().optimize()

    _stateful_objective = True  # host-side PRNG split per evaluation

    def _jitted_eval(self):
        fn = getattr(self, "_eval_fn", None)
        if fn is None:
            from ..circuits.ansatze import STATE_ANSATZE
            from ..env.exact import get_env_exact
            from ..env.variational import state_circuit_psi
            from ..objectives.sampling import measure_energy

            build, D, strings, shots = (
                STATE_ANSATZE[self.ansatz], self.D, self.H.strings, self.n_samples
            )

            @jax.jit
            def fn(params, key):
                U = build(D, params)
                V = get_env_exact(U)
                psi = state_circuit_psi(U, V, 2)
                return measure_energy(key, strings, psi, qubits=(1, 2), shots=shots)

            self._eval_fn = fn
        return fn

    def objective_function(self, params):
        # the SPLIT happens on the host, outside any trace, so every
        # evaluation draws fresh shot noise even under the scipy bridge
        # (the class is marked _stateful_objective so the bridge never
        # jits this outer function — a jit would freeze the key at trace
        # time and leak a tracer into self.key); the pure inner
        # evaluation is jitted once per instance
        self.key, sub = jax.random.split(self.key)
        return self._jitted_eval()(params, sub)


class GuessInitialFullParameterOptimizer(_OptimizerBase):
    """Compile a target 2-qubit unitary into the U4 parametrization by
    maximizing the Loschmidt-style overlap (qmps/tools.py:287-305), with
    gradients instead of the reference's 4-qubit swap circuit."""

    def __init__(self, target_U, initial_guess=None, key=None):
        super().__init__()
        self.target = jnp.asarray(target_U)
        if initial_guess is None:
            key = jax.random.PRNGKey(0) if key is None else key
            initial_guess = jax.random.normal(key, (15,)) * 0.3
        self.initial_guess = jnp.asarray(initial_guess)

    def objective_function(self, params):
        from ..core.lie import U4

        U = U4(params)
        # 1 - |tr(target^dag U)/4|^2: phase-insensitive distance
        ov = jnp.trace(self.target.conj().T @ U) / 4.0
        return 1.0 - jnp.abs(ov) ** 2


class NonSparseFullTwoSiteEnergyOptimizer(_OptimizerBase):
    """2-site unit cell, two SU(4)s, averaged two-bond energy
    (qmps/ground_state.py:271-335)."""

    def __init__(self, H, initial_guess=None, key=None):
        super().__init__()
        self.h = as_host_matrix(H)
        if initial_guess is None:
            key = jax.random.PRNGKey(0) if key is None else key
            initial_guess = jax.random.normal(key, (30,)) * 0.5
        self.initial_guess = jnp.asarray(initial_guess)

    def objective_function(self, params):
        U1 = ansatze.full_state_su4(params[:15])
        U2 = ansatze.full_state_su4(params[15:])
        return energy_two_site(U1, U2, self.h)

    def update_state(self):
        self.U1 = ansatze.full_state_su4(self.optimized_result.x[:15])
        self.U2 = ansatze.full_state_su4(self.optimized_result.x[15:])


# -- deep brickwork (BASELINE config 5: D = 32-64 brick-wall uMPS) -----------


@functools.lru_cache(maxsize=32)
def _deep_bw_program(D: int, depth: int, steps: int, dense: bool,
                     power_iters: int, lr: float):
    """Compiled adam-over-brick-params program, H traced as float planes
    (one executable per configuration — same cache pattern and float-plane
    H argument as _gs_program above)."""
    import optax

    from ..circuits.brickwork_deep import (
        _n_qubits,
        brick_wall_tensor,
        brick_wall_unitary,
    )
    from ..optim.riemann import isometry_energy

    n = _n_qubits(D)

    def loss(p, hre, him):
        A = brick_wall_tensor(p, D, depth)
        V = A.transpose(1, 0, 2).reshape(2 * D, D)  # rows (i, s)
        return isometry_energy(V, jax.lax.complex(hre, him), D, dense, power_iters)

    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.05)
    opt = optax.adam(sched)
    core = _opt_scan_core(loss, opt, steps)

    @jax.jit
    def run(x0, hre, him):
        x, hist, e = core(x0, hre, him)
        # finalize U and A in-program
        U = brick_wall_unitary(x, n, depth)
        return x, jnp.concatenate([hist, e[None]]), e, U, unitary_to_tensor(U)

    return run


@functools.lru_cache(maxsize=32)
def _deep_bw_program_recycled(D: int, depth: int, steps: int, lr: float,
                              recycle_iters: int):
    """_deep_bw_program with environment recycling: the fixed point rides
    the adam scan and is refined with ``recycle_iters`` operator-form power
    matvecs per step (transfer.right_eigpair_warm) instead of being
    re-solved from scratch — the same move that bought 7-10x on the dense
    Stiefel ladder (optim/riemann._recycled_program), applied to the
    brick-parameter chart.  The final history entry is a boosted
    200-matvec evaluation so the reported energy is the returned state's,
    not the recycled residual."""
    import optax

    from ..circuits.brickwork_deep import (
        _n_qubits,
        brick_wall_tensor,
        brick_wall_unitary,
    )
    from ..optim.riemann import isometry_energy_warm

    n = _n_qubits(D)
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.05)
    opt = optax.adam(sched)

    @jax.jit
    def run(x0, hre, him):
        def loss_env(p, r, iters):
            A = brick_wall_tensor(p, D, depth)
            V = A.transpose(1, 0, 2).reshape(2 * D, D)  # rows (i, s)
            return isometry_energy_warm(V, jax.lax.complex(hre, him), D, r, iters)

        core = _recycled_opt_scan_core(loss_env, opt, steps, recycle_iters)
        x, hist, e = core(x0, _recycled_r0(D, hre.dtype))
        U = brick_wall_unitary(x, n, depth)
        return x, jnp.concatenate([hist, e[None]]), e, U, unitary_to_tensor(U)

    return run


def ground_state_deep_brickwork(
    H,
    D: int,
    depth: Optional[int] = None,
    steps: int = 400,
    lr: float = 0.05,
    key=None,
    initial_guess=None,
    power_iters: Optional[int] = None,
    dense_env_max_D: Optional[int] = None,
    recycle: bool = True,
    recycle_iters: int = 24,
):
    """Variational uMPS ground state at D = 2^(n-1) over a depth-d brick
    wall of SU(4) KAK bricks (circuits/brickwork_deep.py) — the deep
    -brickwork ansatz of BASELINE config 5, the circuit-structured
    alternative to the dense Stiefel optimizer at large bond dimension
    (reference anchors: new_tdvp/BrickWallMPS.py, qmps/tools.py:396-420).

    recycle=True (default): environment recycling — the fixed point is
    carried through the adam scan and refined with ``recycle_iters`` cheap
    operator-form power matvecs per step (transfer.right_eigpair_warm, the
    implicit c-gauge adjoint for gradients) instead of being re-solved
    from scratch.  recycle=False keeps the cold per-step solver, which
    follows optim/riemann.default_dense_env_max_D: dense repeated
    squaring up to the crossover, the restarted-Arnoldi + implicit-GMRES
    matvec path above it.
    Returns a GroundStateResult whose ``energy`` is evaluated at the
    returned parameters.
    """
    from ..circuits.brickwork_deep import _n_qubits, n_brick_params

    h = as_host_matrix(H)
    n = _n_qubits(D)
    if depth is None:
        # n layers cover the physical qubit's lightcone; the extra layer
        # buys ~30x in energy error at D=4 (7e-4 vs 2e-2 measured)
        depth = n + 1
    if initial_guess is None:
        key = jax.random.PRNGKey(0) if key is None else key
        initial_guess = (
            jax.random.normal(key, (n_brick_params(n, depth),)) * 0.3
        )
    if recycle:
        if dense_env_max_D is not None or power_iters is not None:
            # cold-solver knobs must not be silently ignored (a caller
            # forcing the Krylov path would get the recycled solver instead)
            raise ValueError(
                "dense_env_max_D/power_iters configure the cold per-step "
                "solver; pass recycle=False to use them"
            )
        run = _deep_bw_program_recycled(D, depth, steps, float(lr), recycle_iters)
    else:
        if dense_env_max_D is None:
            from ..optim.riemann import default_dense_env_max_D

            dense_env_max_D = default_dense_env_max_D()
        if power_iters is None:
            power_iters = 120
        dense = D <= dense_env_max_D
        run = _deep_bw_program(D, depth, steps, dense, power_iters, float(lr))
    x, hist, e, U, A = run(jnp.asarray(initial_guess), *_h_planes(h))
    return GroundStateResult(params=x, energy=float(e), history=hist, U=U, A=A)
