"""Real-time TDVP evolution and Loschmidt echoes.

JAX rebuild of the reference's time-evolution drivers
(qmps/new_time_evolve.py:252-302, scripts/loschmidt.py:335-407,
qmps/loschmidts/time_evo.py): per step, maximize the per-site overlap
density of the candidate state with W|psi(t)> over the ansatz parameters.
The inner optimization is a jitted adam scan warm-started from the current
parameters; a whole trajectory runs as one host loop of compiled steps.

This module provides the MPSTimeEvolve API the reference documents but
lost (qmps/time_evolve.py is referenced by tests/notebooks yet absent from
the tree — SURVEY.md section 2.8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import optax

from ..circuits import ansatze
from ..core.paulis import X, Y, Z
from ..embed.unitaries import unitary_to_tensor
from ..ham.hamiltonian import Hamiltonian
from ..mps import transfer as tr
from ..mps.imps import iMPS
from ..objectives.overlap import tdvp_objective


@dataclasses.dataclass
class EvolveRecord:
    params: jnp.ndarray  # (steps+1, n_params)
    loschmidt: jnp.ndarray  # (steps,) |<psi_0|psi_t>|^2 per site
    evs: jnp.ndarray  # (steps, 3) pauli expectation values
    errors: jnp.ndarray  # (steps,) final inner objective values


# Compiled-step cache: jax.jit caches compilations per *wrapped callable*,
# so a fresh jit wrapper per MPSTimeEvolve instance (or per evolve() call)
# recompiles an identical graph every time — a multi-second tax on exactly
# the workflows that construct steppers repeatedly (checkpoint/resume,
# noise sweeps instantiating one stepper per noise level).  Keying the
# wrapper by its full configuration makes re-instantiation free.  The
# cache is bounded (FIFO eviction) so a long parameter scan over many dt
# or Hamiltonian values does not pin compiled executables forever.
_JIT_CACHE: dict = {}
_JIT_CACHE_MAX = 64


def _cached_jit(key, builder):
    fn = _JIT_CACHE.get(key)
    if fn is None:
        if len(_JIT_CACHE) >= _JIT_CACHE_MAX:
            _JIT_CACHE.pop(next(iter(_JIT_CACHE)))
        fn = _JIT_CACHE[key] = builder()
    else:
        # LRU, not FIFO: promote the hit so a scan cycling through >64
        # configs doesn't evict the entry about to be reused
        _JIT_CACHE[key] = _JIT_CACHE.pop(key)
    return fn


def _w_key(W):
    """Cache-key component for a host gate matrix: bytes alone would alias
    arrays of different shape/dtype with identical buffers."""
    import numpy as np

    W = np.asarray(W)
    return (W.shape, W.dtype.str, W.tobytes())



def _warm_started_minimize(vg, opt, inner_steps, p, *aux):
    """The warm-started inner adam scan shared by the batched sweep
    trajectories (value discarded; the steppers keep their own cached,
    history-reporting variant)."""

    def inner(c, _):
        pp, s = c
        _, g = vg(pp, *aux)
        up, s = opt.update(g, s)
        return (optax.apply_updates(pp, up), s), None

    (p_new, _), _ = jax.lax.scan(inner, (p, opt.init(p)), None, length=inner_steps)
    return p_new


class MPSTimeEvolve:
    """TDVP stepper over a parametrized circuit-MPS manifold.

    gate: params -> state unitary (default the 15-param SU(4) circuit,
    matching qmps/new_time_evolve.py:187-188).
    """

    def __init__(
        self,
        H,
        dt: float,
        gate: Callable | None = None,
        inner_steps: int = 80,
        lr: float = 3e-2,
        trotter_factor: float = 2.0,
    ):
        import numpy as np
        import scipy.linalg

        from ..ham.hamiltonian import as_host_matrix

        h = as_host_matrix(H)
        self.h = h
        self.dt = dt
        # the reference evolves with W = expm(-i h * 2dt) per dt step: the
        # 2-site gate advances the 2-site unit cell (scripts/loschmidt.py:341);
        # host-side expm so the jit captures a host constant
        self.W = scipy.linalg.expm(-1j * np.asarray(h) * trotter_factor * dt)
        self.gate = ansatze.shallow_full_state if gate is None else gate
        self.inner_steps = inner_steps
        self.lr = lr
        self._step = self._build_step()

    def tensor(self, params) -> jnp.ndarray:
        return unitary_to_tensor(self.gate(params))

    def _loss_fn(self):
        """params, A -> objective.  Subclasses override this (and
        _cache_key) instead of copying the whole step builder."""
        gate, W = self.gate, self.W

        def loss(p, A):
            B = unitary_to_tensor(gate(p))
            return tdvp_objective(A, B, W)

        return loss

    def _cache_key(self):
        return ("tdvp_step", self.gate, self.inner_steps, self.lr, _w_key(self.W))

    def _build_step(self):
        gate, inner, lr = self.gate, self.inner_steps, self.lr
        key = self._cache_key()
        loss_fn = self._loss_fn()

        def build():
            opt = optax.adam(lr)
            loss = loss_fn
            vg = jax.value_and_grad(loss)

            @jax.jit
            def step(params):
                A = unitary_to_tensor(gate(params))

                def inner_step(carry, _):
                    p, s = carry
                    v, g = vg(p, A)
                    up, s = opt.update(g, s)
                    return (optax.apply_updates(p, up), s), v

                (p, _), _ = jax.lax.scan(
                    inner_step, (params, opt.init(params)), None, length=inner
                )
                # evaluate at the RETURNED params: the scan history records
                # the loss before each update, so hist[-1] belongs to the
                # penultimate iterate
                return p, loss(p, A)

            return step

        return _cached_jit(key, build)

    def step(self, params):
        """One TDVP step: returns (new_params, final objective value)."""
        return self._step(params)

    def evolve(
        self,
        params0: jnp.ndarray,
        n_steps: int,
        record_ops=(X, Y, Z),
        checkpoint_path: str | None = None,
        checkpoint_every: int = 25,
        log: "ConvergenceRecord | None" = None,
    ) -> EvolveRecord:
        """Run n_steps TDVP steps.

        checkpoint_path: if given, the full restart state (trajectory,
        observables, step counter) is saved there atomically every
        ``checkpoint_every`` steps and at the end; a later ``evolve`` call
        with the same path RESUMES from the last saved step (the reference
        could only np.save trajectories mid-run with no resume,
        qmps/new_time_evolve.py:294).  log: an optional
        utils.logging.ConvergenceRecord collecting the per-step inner
        objective values with wall-clock times.
        """
        import os

        import numpy as np

        from ..utils.checkpoint import load_checkpoint, save_checkpoint

        params = jnp.asarray(params0)
        gate = self.gate
        ops = list(record_ops)

        # jitted recording: the per-step tensor build / expectation /
        # overlap run as compiled programs, not eager op-by-op dispatch
        # (A0 stays device-resident between jits)
        def build_init():
            @jax.jit
            def init_tensor(p):
                return unitary_to_tensor(gate(p))

            return init_tensor

        def build_record():
            @jax.jit
            def record(p, A0):
                psi_t = iMPS([unitary_to_tensor(gate(p))])
                return psi_t.Es(ops), psi_t.overlap(iMPS([A0]))

            return record

        init_tensor = _cached_jit(("u2t", gate), build_init)
        record = _cached_jit(
            ("record", gate, tuple(_w_key(o) for o in ops)),
            build_record,
        )

        ps, les, evss, errs = [params], [], [], []
        if checkpoint_path and os.path.exists(checkpoint_path):
            state = load_checkpoint(checkpoint_path)
            d = state["__dict__"] if "__dict__" in state else state
            done = int(d["step"])
            ps = [jnp.asarray(p) for p in np.asarray(d["ps"])]
            les = [jnp.asarray(x) for x in np.asarray(d["les"])]
            evss = [jnp.asarray(x) for x in np.asarray(d["evss"])]
            errs = [jnp.asarray(x) for x in np.asarray(d["errs"])]
            params = ps[-1]
        A0 = init_tensor(ps[0])

        def save(step_done):
            save_checkpoint(
                checkpoint_path,
                {
                    "step": np.int64(step_done),
                    "ps": np.stack([np.asarray(p) for p in ps]),
                    "les": np.stack([np.asarray(x) for x in les]) if les else np.zeros((0,)),
                    "evss": np.stack([np.asarray(x) for x in evss]) if evss else np.zeros((0, len(ops))),
                    "errs": np.stack([np.asarray(x) for x in errs]) if errs else np.zeros((0,)),
                },
            )

        for k in range(len(les), n_steps):
            # step first, then record: loschmidt[k] is the state at
            # t = (k+1) dt, matching the time grid the pipelines report
            params, err = self.step(params)
            ps.append(params)
            errs.append(err)
            evs, le = record(params, A0)
            evss.append(evs)
            les.append(le)
            if log is not None:
                log.append(float(err))
            if checkpoint_path and ((k + 1) % checkpoint_every == 0 or k + 1 == n_steps):
                save(k + 1)
        return EvolveRecord(
            params=jnp.stack(ps),
            loschmidt=jnp.stack(les),
            evs=jnp.stack(evss),
            errors=jnp.stack(errs),
        )


def compile_state_to_ansatz(
    A: jnp.ndarray,
    gate: Callable | None = None,
    n_params: int = 15,
    steps: int = 800,
    lr: float = 5e-2,
    key=None,
) -> jnp.ndarray:
    """Find ansatz params whose state maximally overlaps a target uMPS tensor
    (the reference 'compile initial state into the gate' move,
    scripts/loschmidt.py:356-359, done with gradients)."""
    gate = ansatze.shallow_full_state if gate is None else gate
    key = jax.random.PRNGKey(0) if key is None else key
    p0 = jax.random.normal(key, (n_params,)) * 0.1
    eye = jnp.eye(4, dtype=A.dtype)

    def loss(p):
        B = unitary_to_tensor(gate(p))
        return tdvp_objective(A, B, eye)

    opt = optax.adam(lr)

    @jax.jit
    def run(p0):
        def step(carry, _):
            p, s = carry
            g = jax.grad(loss)(p)
            up, s = opt.update(g, s)
            return (optax.apply_updates(p, up), s), None

        (p, _), _ = jax.lax.scan(step, (p0, opt.init(p0)), None, length=steps)
        return p

    return run(p0)


def batched_quench_sweep(
    g0: float,
    g1s,
    t_max: float,
    n_steps: int,
    inner_steps: int = 80,
    gs_steps: int = 300,
    lr: float = 3e-2,
    key=None,
    mesh=None,
    params0=None,
):
    """Many quench trajectories as ONE program: vmap the full TDVP stepper
    over a batch of post-quench couplings g1 (optionally shard_map'd over a
    device mesh).  The reference ran each (noise, p) trajectory as a
    separate cluster job (scripts/loschmidt.py:351-382); here the whole
    family advances in lockstep on the accelerator.  Each trajectory's
    inner objective is the dense repeated-squaring eigensolve under vmap.

    Returns (times, loschmidt[len(g1s), n_steps]).
    """
    import optax

    from ..mps import transfer as tr
    from ..parallel.sweep import tfim_matrix
    from .ground_state import find_ground_state

    g1s = jnp.asarray(g1s)
    if g1s.ndim != 1:
        raise ValueError(f"g1s must be a 1-D batch of couplings, got shape {g1s.shape}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    gate = ansatze.shallow_full_state
    if params0 is None:
        gs = find_ground_state(
            Hamiltonian({"ZZ": -1.0, "X": g0}), D=2, ansatz="full15",
            method="lbfgs", steps=gs_steps, key=key,
        )
        params0 = gs.params
    dt = t_max / n_steps
    opt = optax.adam(lr)

    def make_W(g1):
        return jax.scipy.linalg.expm(-1j * tfim_matrix(g1).astype(jnp.complex64 if not jax.config.jax_enable_x64 else jnp.complex128) * 2 * dt)

    def one_traj(g1, p0):
        W = make_W(g1)
        A0 = unitary_to_tensor(gate(p0))

        def loss(p, A):
            return tdvp_objective(A, unitary_to_tensor(gate(p)), W)

        vg = jax.value_and_grad(loss)

        def outer(carry, _):
            p = carry
            A = unitary_to_tensor(gate(p))
            p_new = _warm_started_minimize(vg, opt, inner_steps, p, A)
            B = unitary_to_tensor(gate(p_new))
            ov, _ = tr.right_fixed_point(B, A0)
            return p_new, jnp.abs(ov) ** 2

        _, les = jax.lax.scan(outer, p0, None, length=n_steps)
        return les

    p0s = jnp.broadcast_to(params0, (g1s.shape[0],) + params0.shape)

    from ..parallel.mesh import shard_over_sweep

    fn = _cached_jit(
        ("quench_dense", gate, inner_steps, lr, float(dt), n_steps, mesh),
        lambda: jax.jit(shard_over_sweep(jax.vmap(one_traj), mesh)),
    )
    les = fn(g1s, p0s)
    times = jnp.arange(1, n_steps + 1) * dt
    return times, les


class NoisyMPSTimeEvolve(MPSTimeEvolve):
    """TDVP stepper whose inner objective is the depolarizing-noise
    density-matrix amplitude (scripts/loschmidt.py:241-277 noisy_obj),
    with exact gradients through the channel."""

    def __init__(self, H, dt: float, depolarizing_prob: float, **kw):
        self.p_noise = depolarizing_prob
        super().__init__(H, dt, **kw)

    def _loss_fn(self):
        from ..objectives.noise import noisy_tdvp_objective

        gate, W, p = self.gate, self.W, self.p_noise

        def loss(pp, A):
            B = unitary_to_tensor(gate(pp))
            return noisy_tdvp_objective(A, B, W, p)

        return loss

    def _cache_key(self):
        return (
            "noisy_tdvp_step", self.gate, self.inner_steps, self.lr,
            float(self.p_noise), _w_key(self.W),
        )


def batched_noise_sweep(
    g0: float,
    g1: float,
    t_max: float,
    n_steps: int,
    noise_levels,
    inner_steps: int = 80,
    gs_steps: int = 300,
    lr: float = 3e-2,
    key=None,
    mesh=None,
):
    """The reference's production noise study (scripts/loschmidt.py:335-382
    — one cluster job per depolarizing probability) in lockstep: the
    channel strength is an ordinary scalar in the density-matrix
    objective, so the whole noise family advances together under vmap
    (optionally shard_map'd over a mesh).

    The TIME axis runs as a host loop of one compiled vmapped step, not a
    single giant lax.scan — the structure MPSTimeEvolve already uses; the
    host loop costs one dispatch per step.

    Returns (times, rates[len(noise_levels), n_steps]) with
    rate = -log |<psi_0|psi_t>|^2 of the evolved pure parametrized state
    (the noise shapes the optimization landscape, as in the reference).
    """
    import optax

    from ..objectives.noise import noisy_tdvp_objective
    from ..parallel.mesh import shard_over_sweep
    from ..parallel.sweep import tfim_matrix
    from .ground_state import find_ground_state

    ps_noise = jnp.asarray(
        noise_levels,
        jnp.float64 if jax.config.jax_enable_x64 else jnp.float32,
    )
    gate = ansatze.shallow_full_state
    gs = find_ground_state(
        Hamiltonian({"ZZ": -1.0, "X": g0}), D=2, ansatz="full15",
        method="lbfgs", steps=gs_steps, key=key,
    )
    params0 = gs.params
    dt = t_max / n_steps
    opt = optax.adam(lr)
    u2t = lambda p: unitary_to_tensor(gate(p))

    def one_step(p_noise, p, A0):
        ctype = jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64
        W = jax.scipy.linalg.expm(-1j * tfim_matrix(g1).astype(ctype) * 2 * dt)

        def loss(pp, A):
            return noisy_tdvp_objective(A, u2t(pp), W, p_noise)

        vg = jax.value_and_grad(loss)
        A = u2t(p)
        p_new = _warm_started_minimize(vg, opt, inner_steps, p, A)
        ov, _ = tr.right_fixed_point(u2t(p_new), A0)
        return p_new, jnp.abs(ov) ** 2

    p0s = jnp.broadcast_to(params0, (ps_noise.shape[0],) + params0.shape)
    step = _cached_jit(
        ("noise_sweep_step", gate, inner_steps, lr, float(g1), float(dt), mesh),
        lambda: jax.jit(shard_over_sweep(jax.vmap(one_step), mesh)),
    )
    init_tensors = _cached_jit(
        ("u2t_batch", gate), lambda: jax.jit(lambda p0s: jax.vmap(u2t)(p0s))
    )

    A0s = init_tensors(p0s)
    ps, les = p0s, []
    for _ in range(n_steps):
        ps, le = step(ps_noise, ps, A0s)
        les.append(le)
    les = jnp.stack(les, axis=1)  # (len(noise), n_steps)
    times = jnp.arange(1, n_steps + 1) * dt
    return times, -jnp.log(les)


def noisy_loschmidt_echo_run(
    g0: float,
    g1: float,
    t_max: float,
    n_steps: int,
    noise_levels,
    inner_steps: int = 80,
    gs_steps: int = 300,
    key=None,
):
    """The reference's production noise sweep (scripts/loschmidt.py:335-382):
    one quench trajectory per depolarizing probability.  Returns
    (times, rates[len(noise), n_steps])."""
    from .ground_state import find_ground_state

    H0 = Hamiltonian({"ZZ": -1.0, "X": g0})
    H1 = Hamiltonian({"ZZ": -1.0, "X": g1})
    gs = find_ground_state(H0, D=2, ansatz="full15", method="lbfgs", steps=gs_steps, key=key)

    dt = t_max / n_steps
    rates = []
    for p in noise_levels:
        stepper = (
            MPSTimeEvolve(H1, dt, inner_steps=inner_steps)
            if p == 0
            else NoisyMPSTimeEvolve(H1, dt, p, inner_steps=inner_steps)
        )
        rec = stepper.evolve(gs.params, n_steps)
        rates.append(-jnp.log(rec.loschmidt))
    times = jnp.arange(1, n_steps + 1) * dt
    return times, jnp.stack(rates)


def loschmidt_echo_run(
    g0: float,
    g1: float,
    t_max: float,
    n_steps: int,
    gate: Callable | None = None,
    inner_steps: int = 120,
    gs_steps: int = 400,
    key=None,
):
    """Full quench pipeline (scripts/loschmidt.py:335-382): ground state of
    TFIM(g0), compiled into the ansatz, evolved under TFIM(g1); returns
    (times, rate function -log(overlap density), EvolveRecord)."""
    from .ground_state import find_ground_state

    H0, H1 = Hamiltonian({"ZZ": -1.0, "X": g0}), Hamiltonian({"ZZ": -1.0, "X": g1})
    gate = ansatze.shallow_full_state if gate is None else gate

    gs = find_ground_state(H0, D=2, ansatz="full15", method="lbfgs", steps=gs_steps, key=key)
    params0 = gs.params  # same ansatz family: reuse directly

    dt = t_max / n_steps
    stepper = MPSTimeEvolve(H1, dt, gate=gate, inner_steps=inner_steps)
    rec = stepper.evolve(params0, n_steps)
    times = jnp.arange(1, n_steps + 1) * dt
    rates = -jnp.log(rec.loschmidt)
    return times, rates, rec
