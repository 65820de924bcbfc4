"""The BASELINE.json config ladder as runnable workload dataclasses.

The reference has no config system (constants in __main__ blocks,
SURVEY.md section 5); here each benchmark configuration is a frozen
dataclass with a ``run()`` that returns a metrics dict.  These are the
driver-facing workloads:

1. TFIM ground state, D=2 (CPU-runnable PR1 reference)
2. D=4 circuit MPS + transfer fixed-point environment
3. Post-quench TDVP + Loschmidt echo vs the exact oracle
4. vmapped/sharded (g,) phase-diagram sweep
5. brickwork TDVP with the flat-matmul kernels (stretch)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class GroundStateConfig:
    """Configs 1-2: variational TFIM ground state at bond dimension D."""

    g: float = 1.0
    D: int = 2
    ansatz: str = "suN"
    method: str = "lbfgs"
    steps: int = 300

    def run(self) -> dict:
        from .algorithms import find_ground_state
        from .ham import tfim, tfim_gs_energy_f64

        t0 = time.perf_counter()
        res = find_ground_state(
            tfim(self.g), D=self.D, ansatz=self.ansatz,
            method=self.method, steps=self.steps,
        )
        dt = time.perf_counter() - t0
        e_exact = float(tfim_gs_energy_f64(self.g))
        return {
            "energy": res.energy,
            "exact": e_exact,
            "error": res.energy - e_exact,
            "seconds": dt,
            "steps_per_sec": self.steps / dt,
        }


@dataclasses.dataclass(frozen=True)
class QuenchConfig:
    """Config 3: post-quench TDVP + Loschmidt echo vs the exact rate."""

    g0: float = 1.5
    g1: float = 0.2
    t_max: float = 0.8
    n_steps: int = 20
    inner_steps: int = 100

    def run(self) -> dict:
        from .algorithms.evolve import loschmidt_echo_run
        from .ham import loschmidt_rate

        t0 = time.perf_counter()
        times, rates, rec = loschmidt_echo_run(
            self.g0, self.g1, self.t_max, self.n_steps, inner_steps=self.inner_steps
        )
        dt = time.perf_counter() - t0
        exact = np.array(
            [float(loschmidt_rate(t, self.g0, self.g1)) for t in np.asarray(times)]
        )
        return {
            "max_rate_error": float(np.max(np.abs(np.asarray(rates) - exact))),
            "seconds": dt,
            "tdvp_steps_per_sec": self.n_steps / dt,
        }


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Config 4: the sharded phase-diagram sweep."""

    n_points: int = 256
    D: int = 2
    steps: int = 300
    g_min: float = 0.1
    g_max: float = 2.0
    use_mesh: bool = False
    ansatz: str = "suN"
    refine_passes: int = 0

    def run(self) -> dict:
        from .ham import tfim_gs_energy_f64
        from .parallel import make_mesh, sweep_ground_states

        gs = jnp.linspace(self.g_min, self.g_max, self.n_points)
        mesh = make_mesh() if self.use_mesh and len(jax.devices()) > 1 else None
        # warm-up/compile
        es, _ = sweep_ground_states(
            gs, D=self.D, ansatz=self.ansatz, steps=self.steps, mesh=mesh,
            refine_passes=self.refine_passes,
        )
        es.block_until_ready()
        t0 = time.perf_counter()
        es, _ = sweep_ground_states(
            gs + 1e-3, D=self.D, ansatz=self.ansatz, steps=self.steps,
            mesh=mesh, refine_passes=self.refine_passes,
        )
        es.block_until_ready()
        dt = time.perf_counter() - t0
        exact = tfim_gs_energy_f64(np.asarray(gs + 1e-3, np.float64))
        err = np.asarray(es, np.float64) - exact
        return {
            "opts_per_sec": self.n_points / dt,
            "seconds": dt,
            "median_error": float(np.median(err)),
            "max_error": float(np.max(err)),
            # signed minimum: energies BELOW exact flag an unconverged
            # or exploited environment readout (the recycle_iters
            # correctness knob), which max/median alone cannot see
            "min_error": float(np.min(err)),
        }


@dataclasses.dataclass(frozen=True)
class FusedSweepConfig:
    """Config 4, fused Riemannian engine: on a GPU two Triton launches per
    optimizer step over the whole batch, closed-form polar retraction
    (parallel.sweep.sweep_ground_states_fused)."""

    n_points: int = 256
    steps: int = 300
    restarts: int = 4
    g_min: float = 0.1
    g_max: float = 2.0
    chunk: int = 50  # steps per compiled scan program

    def run(self) -> dict:
        from .ham import tfim_gs_energy_f64
        from .parallel.sweep import sweep_ground_states_fused

        gs = jnp.linspace(self.g_min, self.g_max, self.n_points)
        es, _ = sweep_ground_states_fused(
            gs, steps=self.steps, restarts=self.restarts, chunk=self.chunk
        )
        es.block_until_ready()
        t0 = time.perf_counter()
        es, _ = sweep_ground_states_fused(
            gs + 1e-3, steps=self.steps, restarts=self.restarts, chunk=self.chunk
        )
        es.block_until_ready()
        dt = time.perf_counter() - t0
        exact = tfim_gs_energy_f64(np.asarray(gs + 1e-3, np.float64))
        err = np.asarray(es, np.float64) - exact
        return {
            "opts_per_sec": self.n_points / dt,
            "seconds": dt,
            "median_error": float(np.median(err)),
            "max_error": float(np.max(err)),
            # signed minimum: energies BELOW exact flag an unconverged
            # or exploited environment readout (the recycle_iters
            # correctness knob), which max/median alone cannot see
            "min_error": float(np.min(err)),
        }


@dataclasses.dataclass(frozen=True)
class GrownSweepConfig:
    """Config 4 at large D via bond-growth continuation: the whole grid
    optimized up the ladder D_start -> ... -> D, each rung warm-started
    from the last through the exact linear su(N) embedding
    (parallel.sweep.sweep_ground_states_grown) — heals the attractive
    bad basins random starts leave at D >= 16 that refine passes can't
    reach."""

    n_points: int = 256
    D: int = 16
    steps: int = 300
    g_min: float = 0.1
    g_max: float = 2.0
    D_start: int = 2

    def run(self) -> dict:
        from .ham import tfim_gs_energy_f64
        from .parallel.sweep import sweep_ground_states_grown

        gs = jnp.linspace(self.g_min, self.g_max, self.n_points)
        es, _ = sweep_ground_states_grown(
            gs, D=self.D, steps=self.steps, D_start=self.D_start
        )  # compile every rung
        es.block_until_ready()
        t0 = time.perf_counter()
        es, _ = sweep_ground_states_grown(
            gs + 1e-3, D=self.D, steps=self.steps, D_start=self.D_start
        )
        es.block_until_ready()
        dt = time.perf_counter() - t0
        exact = tfim_gs_energy_f64(np.asarray(gs + 1e-3, np.float64))
        err = np.asarray(es, np.float64) - exact
        return {
            "opts_per_sec": self.n_points / dt,
            "seconds": dt,
            "median_error": float(np.median(err)),
            "max_error": float(np.max(err)),
            # signed minimum: energies BELOW exact flag an unconverged
            # or exploited environment readout (the recycle_iters
            # correctness knob), which max/median alone cannot see
            "min_error": float(np.min(err)),
        }


@dataclasses.dataclass(frozen=True)
class StiefelSweepConfig:
    """Config 4 at large D, production engine: the phase-diagram sweep by
    direct Stiefel descent on the (2D, D) isometry
    (parallel.sweep.sweep_ground_states_stiefel), aimed at "1000+ vmapped
    optimizations, D <= 32, under a minute" (BASELINE.md).
    recycle_iters=None rides the library's D-aware default (96 at D >= 16
    — the correctness knob, see the sweep docstring)."""

    n_points: int = 1024
    D: int = 16
    steps: int = 300
    g_min: float = 0.1
    g_max: float = 2.0
    recycle_iters: int | None = None

    def run(self) -> dict:
        from .ham import tfim_gs_energy_f64
        from .parallel.sweep import sweep_ground_states_stiefel

        gs = jnp.linspace(self.g_min, self.g_max, self.n_points)
        es, _, _ = sweep_ground_states_stiefel(
            gs, D=self.D, steps=self.steps, recycle_iters=self.recycle_iters
        )  # compile
        es.block_until_ready()
        t0 = time.perf_counter()
        es, _, _ = sweep_ground_states_stiefel(
            gs + 1e-3, D=self.D, steps=self.steps,
            recycle_iters=self.recycle_iters,
        )
        es.block_until_ready()
        dt = time.perf_counter() - t0
        exact = tfim_gs_energy_f64(np.asarray(gs + 1e-3, np.float64))
        err = np.asarray(es, np.float64) - exact
        return {
            "opts_per_sec": self.n_points / dt,
            "seconds": dt,
            "median_error": float(np.median(err)),
            "max_error": float(np.max(err)),
            # signed minimum: energies BELOW exact flag an unconverged
            # or exploited environment readout (the recycle_iters
            # correctness knob), which max/median alone cannot see
            "min_error": float(np.min(err)),
        }


@dataclasses.dataclass(frozen=True)
class BrickworkConfig:
    """Config 5: gen-2 brickwork TDVP with the flat-matmul hot kernel."""

    batch: int = 16384
    iters: int = 30

    def run(self) -> dict:
        from .kernels import manifold_overlap_batched

        rng = np.random.default_rng(0)

        def hu(b, n):
            A = rng.standard_normal((b, n, n)) + 1j * rng.standard_normal((b, n, n))
            Q, _ = np.linalg.qr(A)
            return Q.astype(np.complex64)

        # device-resident args: numpy args would re-transfer on every call
        # and the loop would time the copy instead of compute
        args = jax.device_put(
            [hu(self.batch, 4) for _ in range(4)] + [hu(self.batch, 2), hu(1, 16)[0]]
        )
        jax.block_until_ready(args)

        @jax.jit
        def f(U1, U2, U1p, U2p, M, W):
            return jnp.abs(
                manifold_overlap_batched(
                    U1, U2, U1p, U2p, M, jnp.swapaxes(M, -1, -2).conj(), W
                )
            )

        out = f(*args)
        out.block_until_ready()
        assert np.all(np.isfinite(np.asarray(out[:4])))  # hard readback check
        t0 = time.perf_counter()
        for _ in range(self.iters):
            out = f(*args)
        out.block_until_ready()
        dt = time.perf_counter() - t0
        assert np.all(np.isfinite(np.asarray(out[:4])))
        metrics = {"overlap_evals_per_sec": self.batch * self.iters / dt, "seconds": dt}

        return metrics


@dataclasses.dataclass(frozen=True)
class LargeDConfig:
    """Config 5 (large-D leg): Riemannian TFIM ground state at D = 32-64.

    Exercises both environment-solver regimes: the dense repeated-squaring
    chain and the matvec Krylov path above the crossover (restarted
    Arnoldi forward + fixed-shape GMRES implicit adjoint, core/krylov.py).
    """

    g: float = 1.0
    D: int = 64
    steps: int = 150

    def run(self) -> dict:
        from .ham import tfim, tfim_gs_energy_f64
        from .optim.riemann import ground_state_riemannian

        h = tfim(self.g).to_matrix()
        t0 = time.perf_counter()
        _, e, hist = ground_state_riemannian(
            h, D=self.D, steps=self.steps, key=jax.random.PRNGKey(1)
        )
        dt = time.perf_counter() - t0
        h_np = np.asarray(hist)
        assert np.all(np.isfinite(h_np))
        e_exact = float(tfim_gs_energy_f64(self.g))
        # e is the RETURNED state's energy (hist[-1] is evaluated at the
        # returned isometry) — never report best-of-history the returned
        # parameters don't achieve
        return {
            "energy": float(e),
            "exact": e_exact,
            "error": float(e) - e_exact,
            "best_seen": float(h_np.min()),
            "seconds": dt,
            "steps_per_sec": self.steps / dt,
        }


@dataclasses.dataclass(frozen=True)
class DeepBrickworkConfig:
    """Config 5 (brick-wall leg): deep-brickwork uMPS ground state at
    D = 32-64 — depth-n wall of SU(4) KAK bricks, parameter count
    ~depth*n*19 instead of (2D)^2, through the same two environment
    regimes as LargeDConfig (algorithms/ground_state.py:
    ground_state_deep_brickwork; circuits/brickwork_deep.py)."""

    g: float = 1.0
    D: int = 32
    steps: int = 300
    depth: int | None = None

    def run(self) -> dict:
        from .algorithms import ground_state_deep_brickwork
        from .ham import tfim, tfim_gs_energy_f64

        t0 = time.perf_counter()
        gs = ground_state_deep_brickwork(
            tfim(self.g), D=self.D, depth=self.depth, steps=self.steps,
            key=jax.random.PRNGKey(1),
        )
        dt = time.perf_counter() - t0
        h_np = np.asarray(gs.history)
        assert np.all(np.isfinite(h_np))
        e_exact = float(tfim_gs_energy_f64(self.g))
        return {
            "energy": gs.energy,  # the returned state's energy
            "exact": e_exact,
            "error": gs.energy - e_exact,
            "n_params": int(np.asarray(gs.params).size),
            "seconds": dt,
            "steps_per_sec": self.steps / dt,
        }


CONFIG_LADDER = (
    GroundStateConfig(D=2),
    GroundStateConfig(D=4),
    QuenchConfig(),
    SweepConfig(),
    FusedSweepConfig(),
    # config 4 at large D: the full 1024-point sweep through the
    # deep-brickwork ansatz with per-point environment recycling —
    # the "(g, D) sweep, D <= 32" reading of the BASELINE target.
    # refine_passes=4: random starts leave a ~6-point bad-basin cluster
    # near g~1.85 (err 0.13); four continuation passes heal it fully
    # at D=16 (max err 0.13 -> 4.2e-3, zero points > 5e-3).  The ladder
    # entry is D=16; D=32 runs the same path via SweepConfig(n_points=1024,
    # D=32, ansatz="deep_bw", refine_passes=4)
    SweepConfig(n_points=1024, D=16, ansatz="deep_bw", refine_passes=4),
    # config 4 at large D, suN chart: bond-growth continuation up the
    # D = 2 -> 16 ladder
    GrownSweepConfig(),
    # config 4 at large D, production engine: direct Stiefel descent
    StiefelSweepConfig(),
    BrickworkConfig(),
    LargeDConfig(D=32),
    LargeDConfig(D=64),
    DeepBrickworkConfig(D=32),
)


def run_ladder(configs: Sequence = CONFIG_LADDER, profile_dir: Optional[str] = None):
    """Run the workload ladder; returns {config_name: metrics}.

    With ``profile_dir`` set (or QMPS_PROFILE_DIR in the environment),
    each config runs under a jax.profiler trace written to
    ``<profile_dir>/<ConfigName_i>`` — view with xprof/tensorboard.  This
    is the replacement for the reference's ad-hoc time.time() benchmarks
    (SURVEY.md section 5): per-op device timelines on demand around the
    exact production workloads.
    """
    import os

    from .utils.profiling import trace

    profile_dir = profile_dir or os.environ.get("QMPS_PROFILE_DIR")
    results = {}
    for i, cfg in enumerate(configs):
        name = f"{type(cfg).__name__}_{i}"
        if profile_dir:
            with trace(os.path.join(profile_dir, name)):
                results[name] = cfg.run()
        else:
            results[name] = cfg.run()
    return results


if __name__ == "__main__":
    import json

    print(json.dumps(run_ladder(), indent=1, default=float))
