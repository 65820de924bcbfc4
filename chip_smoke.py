"""Smoke test of the main path on one GPU, at the benchmark's real sizes.

    python chip_smoke.py           # all phases on one card
    python chip_smoke.py --four    # only the four-card sharded sweeps

Every phase runs in this one process (a JAX process reserves most of the
card's memory, so a second one could not start) and prints one JSON line
with its ``compile_s`` and ``run_s`` and each accuracy number beside the
gate it is held to.  ``compile_s`` is the first call's wall time less a
second, identical call's (``run_s``).  Any failed gate, any exception, a
default backend other than "gpu" or a missing ``nvidia-smi`` ends the run
with a non-zero exit code and no ``ok`` line.  The last line of a passing
run is ``{"ok": true, "device": {...}}`` as JAX reports the device.

Phases (one card):
1. host -> device -> host round trip of a complex64 array, exact;
2. the Triton energy kernel against its plain-XLA twin at batch 4096 and
   65536 (energies, gradients, a host f64 sample, both times);
3. the D=2 fused sweep, 1024 couplings x 4 restarts x 300 steps;
4. the D=32 Stiefel sweep, 1024 points, cheap descent + 60 polish steps;
5. VUMPS at D=32 to the gradient knee with GMRES environments;
6. the g 1.5 -> 0.2 TDVP quench, 100 steps, against the exact rate up to
   the first dynamical transition, which no D=2 state resolves.
"""
import json
import os
import shutil
import subprocess
import sys
import time

os.environ.setdefault("QMPS_TPU_X64", "0")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

N_POINTS = 1024
RESTARTS = 4
PARITY_BATCHES = (N_POINTS * RESTARTS, 65536)


class GateError(AssertionError):
    pass


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def gate(name, value, limit, fields, op="<="):
    """Record ``value`` beside its limit; raise if it misses."""
    value = float(value)
    ok = value <= limit if op == "<=" else value >= limit
    fields[name] = {"value": value, "gate": f"{op} {limit}"}
    if not ok or not np.isfinite(value):
        emit("gate_failed", name=name, value=value, limit=limit)
        raise GateError(f"{name} = {value} misses {op} {limit}")


def twice(fn):
    """(first result, compile_s, run_s) of two identical calls."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t2 = time.perf_counter()
    return out, (t1 - t0) - (t2 - t1), t2 - t1


def once(fn):
    """(result, None, wall_s) of one call, compilation included."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, None, time.perf_counter() - t0


def sweep_gs():
    import jax.numpy as jnp

    gvals = np.linspace(0.1, 2.0, N_POINTS) + 1e-3
    return gvals, jnp.asarray(gvals, jnp.float32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_transfer():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1024, 16)) + 1j * rng.standard_normal((1024, 16))
         ).astype(np.complex64)
    back = np.asarray(jax.device_put(x))
    exact = bool(back.dtype == x.dtype and np.array_equal(back, x))
    emit("transfer", complex64_roundtrip_exact=exact)
    if not exact:
        raise GateError("complex64 host-device round trip is not exact")


def phase_kernel_parity():
    import jax.numpy as jnp

    from qmps_tpu.ham.classical_baselines import host_energy_d2
    from qmps_tpu.kernels.energy_fused import energy_objective_fused
    from qmps_tpu.parallel.sweep import tfim_matrix

    for B in PARITY_BATCHES:
        key = jax.random.PRNGKey(B)
        with jax.default_matmul_precision("highest"):
            X = (jax.random.normal(key, (B, 4, 2))
                 + 1j * jax.random.normal(jax.random.fold_in(key, 1), (B, 4, 2)))
            V, _ = jnp.linalg.qr(X.astype(jnp.complex64))
            As = V.reshape(-1, 2, 2, 2).transpose(0, 2, 1, 3)
            g = jnp.linspace(0.1, 2.0, B, dtype=jnp.float32)
            hs = jax.vmap(tfim_matrix)(g).real.astype(jnp.float32)

            def make(engine):
                def f(A, h):
                    e, vjp = jax.vjp(
                        lambda a: energy_objective_fused(a, h, 48, False, engine), A
                    )
                    return e, vjp(jnp.ones_like(e))[0]
                return jax.jit(f)

            res, fields = {}, {"batch": B}
            for engine in ("pallas", "xla"):
                f = make(engine)
                t0 = time.perf_counter()
                c = f.lower(As, hs).compile()
                compile_s = time.perf_counter() - t0
                out = jax.block_until_ready(c(As, hs))
                n = 20
                t0 = time.perf_counter()
                for _ in range(n):
                    out = c(As, hs)
                jax.block_until_ready(out)
                fields[f"{engine}_compile_s"] = compile_s
                fields[f"{engine}_ms_per_value_and_grad"] = (
                    (time.perf_counter() - t0) / n * 1e3)
                res[engine] = [np.asarray(o) for o in out]
        (ek, gk), (ex, gx) = res["pallas"], res["xla"]
        gate("energy_max_abs_diff", np.max(np.abs(ek - ex)), 1e-5, fields)
        gate("grad_rel_diff",
             np.linalg.norm(gk - gx) / np.linalg.norm(gx), 1e-4, fields)
        A64 = np.asarray(As[:64], np.complex128)
        h64 = np.asarray(hs[:64], np.float64)
        e64 = np.array([host_energy_d2(A64[b], h64[b]) for b in range(64)])
        gate("pallas_vs_host_f64", np.max(np.abs(ek[:64] - e64)), 2e-5, fields)
        gate("xla_vs_host_f64", np.max(np.abs(ex[:64] - e64)), 2e-5, fields)
        fields["compile_s"] = fields["pallas_compile_s"]
        fields["run_s"] = fields["pallas_ms_per_value_and_grad"] / 1e3
        emit("kernel_parity", **fields)


def run_fused_sweep(mesh=None, calls=twice):
    from qmps_tpu.parallel.sweep import sweep_ground_states_fused

    _, gs = sweep_gs()
    return calls(lambda: sweep_ground_states_fused(
        gs, steps=300, restarts=RESTARTS, chunk=50, mesh=mesh))


def check_fused_sweep(es, As, fields):
    from qmps_tpu.ham import tfim_gs_energy_f64
    from qmps_tpu.ham.classical_baselines import host_energy_d2
    from qmps_tpu.utils.host_eval import tfim_h64_batch

    gvals, _ = sweep_gs()
    A = np.asarray(As, np.complex128)
    hs = tfim_h64_batch(gvals)
    e64 = np.array([host_energy_d2(A[b], hs[b]) for b in range(N_POINTS)])
    err = e64 - tfim_gs_energy_f64(gvals)
    gate("non_finite_points", np.count_nonzero(~np.isfinite(err)), 0, fields)
    gate("max_error", np.max(err), 5e-3, fields)
    gate("median_error", np.median(err), 2e-4, fields)
    fields["min_error"] = float(np.min(err))


def phase_fused_sweep():
    (es, As), compile_s, run_s = run_fused_sweep()
    fields = {"compile_s": compile_s, "run_s": run_s}
    check_fused_sweep(es, As, fields)
    emit("fused_sweep_D2", **fields)
    return np.asarray(es)


STIEFEL_D = 32
STIEFEL_SCHEDULE = dict(steps=180, precision="default", polish_steps=60)


def run_stiefel_sweep(mesh=None, calls=twice):
    from qmps_tpu.parallel.sweep import sweep_ground_states_stiefel

    _, gs = sweep_gs()
    return calls(lambda: sweep_ground_states_stiefel(
        gs, D=STIEFEL_D, mesh=mesh, **STIEFEL_SCHEDULE))


def check_stiefel_sweep(es, As, rs, fields):
    from qmps_tpu.ham import tfim_gs_energy_f64
    from qmps_tpu.utils.host_eval import host_f64_sweep_energies, tfim_h64_batch

    gvals, _ = sweep_gs()
    t0 = time.perf_counter()
    e64, _ = host_f64_sweep_energies(As, rs, tfim_h64_batch(gvals))
    fields["host_f64_eval_s"] = time.perf_counter() - t0
    err = e64 - tfim_gs_energy_f64(gvals)
    gate("non_finite_points", np.count_nonzero(~np.isfinite(err)), 0, fields)
    gate("max_error", np.max(err), 2e-3, fields)
    gate("min_error", np.min(err), -1e-5, fields, op=">=")
    fields["median_error"] = float(np.median(err))


def phase_stiefel_sweep():
    (es, As, rs), compile_s, run_s = run_stiefel_sweep()
    fields = {"compile_s": compile_s, "run_s": run_s, **STIEFEL_SCHEDULE}
    check_stiefel_sweep(es, As, rs, fields)
    emit(f"stiefel_sweep_D{STIEFEL_D}", **fields)
    return np.asarray(es)


VUMPS_D = 32


def phase_vumps():
    from qmps_tpu.ham import tfim, tfim_gs_energy_f64
    from qmps_tpu.mps.tdvp import vumps_ground_state_converged
    from qmps_tpu.utils.host_eval import host_energy_gauge_free

    h = np.asarray(tfim(1.0).to_matrix().real, np.float32)
    (AL, _, e, info), compile_s, run_s = twice(
        lambda: vumps_ground_state_converged(
            h, VUMPS_D, tol=3e-4, k=48, env_solver="gmres",
            key=jax.random.PRNGKey(2)))
    fields = {"compile_s": compile_s, "run_s": run_s,
              "total_iters": int(info["total_iters"])}
    e64 = host_energy_gauge_free(AL, np.asarray(h, np.float64), f32_ref=float(e))
    gate("energy_error_f64", e64 - float(tfim_gs_energy_f64(1.0)), 1e-4, fields)
    gate("grad_norm", info["grad_norms"][-1], 3e-4, fields)
    emit(f"vumps_D{VUMPS_D}", **fields)


QUENCH_INNER_STEPS = 120


def phase_quench():
    """The D=2 circuit-TDVP quench (g 1.5 -> 0.2, dt = 0.02, 100 steps)
    against the exact rate function.  No D=2 state follows the exact rate
    through the first dynamical transition (t ~ 0.92): exact D=2 TDVP —
    the classical tangent-space integrator (mps/tdvp.Trajectory, RK4 at
    dt/4) from the same initial state — misses it by ~3e-2.  So the gate
    covers the window in which that reference stays within half the gate
    of the exact rate, and the full-horizon deviations of both are
    printed beside it."""
    from qmps_tpu.algorithms.evolve import batched_quench_sweep
    from qmps_tpu.algorithms.ground_state import find_ground_state
    from qmps_tpu.circuits.ansatze import shallow_full_state
    from qmps_tpu.embed import unitary_to_tensor
    from qmps_tpu.ham import loschmidt_rate, tfim
    from qmps_tpu.ham.hamiltonian import Hamiltonian
    from qmps_tpu.mps.tdvp import Trajectory

    gs = find_ground_state(
        Hamiltonian({"ZZ": -1.0, "X": 1.5}), D=2, ansatz="full15",
        method="lbfgs", steps=400,
    )
    t_max, n_steps, tol = 2.0, 100, 1e-2
    (times, les), compile_s, run_s = twice(lambda: batched_quench_sweep(
        1.5, [0.2], t_max, n_steps, inner_steps=QUENCH_INNER_STEPS,
        params0=gs.params))
    times = np.asarray(times)
    rates = -np.log(np.asarray(les)[0])
    exact = np.array([float(loschmidt_rate(t, 1.5, 0.2)) for t in times])
    traj = Trajectory(unitary_to_tensor(shallow_full_state(gs.params)),
                      tfim(0.2).to_matrix()).rk4int(t_max, 4 * n_steps)
    ref_dev = np.abs(-np.log(np.asarray(traj.loschmidts()))[3::4] - exact)
    window = np.cumprod(ref_dev <= tol / 2).astype(bool)
    dev = np.abs(rates - exact)
    fields = {"compile_s": compile_s, "run_s": run_s,
              "inner_steps": QUENCH_INNER_STEPS,
              "gated_until_t": float(times[window][-1]) if window.any() else 0.0,
              "rate_max_dev_full_horizon": float(dev.max()),
              "d2_tdvp_max_dev_full_horizon": float(ref_dev.max())}
    if not window[: n_steps // 4].all():
        raise GateError("D=2 TDVP reference leaves the exact rate within t <= 0.5")
    gate("rate_max_dev", dev[window].max(), tol, fields)
    emit("tdvp_quench", **fields)


def phase_four():
    """Phases 3 and 4 over a 1-D mesh of four cards, then on one card with
    the same seeds; per-point energies must agree.  A sweep that runs
    once reports no ``compile_s`` (its ``run_s`` includes compilation).
    The one-card fused sweep runs exactly as phase 3 does, through
    ``twice``: a Triton kernel's IR carries its call sites, so only then
    does it find phase 3's kernels in the persistent compile cache."""
    from qmps_tpu.parallel import make_mesh

    mesh = make_mesh(4)
    for name, run, check, one_card in (
        ("fused_sweep_D2", run_fused_sweep, check_fused_sweep, twice),
        (f"stiefel_sweep_D{STIEFEL_D}", run_stiefel_sweep, check_stiefel_sweep, once),
    ):
        results = {}
        for tag, m, calls in (("four", mesh, once), ("one", None, one_card)):
            out, compile_s, run_s = run(m, calls=calls)
            fields = {"cards": 4 if m is not None else 1,
                      "compile_s": compile_s, "run_s": run_s}
            check(*out, fields)
            emit(name, **fields)
            results[tag] = np.asarray(out[0], np.float64)
        fields = {}
        gate("four_vs_one_max_abs_diff",
             np.max(np.abs(results["four"] - results["one"])), 1e-5, fields)
        emit(f"{name}_four_vs_one", **fields)


def main(argv):
    four = argv == ["--four"]
    if argv and not four:
        raise SystemExit(f"usage: python chip_smoke.py [--four], got {argv}")
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: default backend is {backend!r}, not 'gpu'")
    if shutil.which("nvidia-smi") is None:
        raise SystemExit("chip_smoke: nvidia-smi not found")
    devices = jax.devices()
    count = 4 if four else 1
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)

    import qmps_tpu  # noqa: F401  (pins the package numerics policy)

    t0 = time.perf_counter()
    if four:
        phase_four()
    else:
        phase_transfer()
        phase_kernel_parity()
        phase_fused_sweep()
        phase_stiefel_sweep()
        phase_vumps()
        phase_quench()
    emit("total", seconds=time.perf_counter() - t0)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main(sys.argv[1:])
