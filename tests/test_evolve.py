"""Quantum-circuit TDVP evolution: stationarity, cross-validation against
the classical TDVP engine, and the quench rate oracle (short horizon)."""
import jax
import numpy as np
import pytest

from qmps_tpu.algorithms import MPSTimeEvolve, find_ground_state
from qmps_tpu.algorithms.evolve import compile_state_to_ansatz, loschmidt_echo_run
from qmps_tpu.ham import loschmidt_rate, tfim
from qmps_tpu.mps.imps import iMPS
from qmps_tpu.mps.tdvp import Trajectory


@pytest.mark.slow
def test_ground_state_stationary_under_evolution():
    gs = find_ground_state(tfim(1.0), D=2, ansatz="full15", method="lbfgs", steps=150)
    ev = MPSTimeEvolve(tfim(1.0), dt=0.02, inner_steps=60)
    rec = ev.evolve(gs.params, 4)
    assert np.all(np.asarray(rec.loschmidt) > 0.995)
    assert np.all(np.asarray(rec.errors) < -0.998)


def test_compile_state_to_ansatz(key):
    A = iMPS.random(key, 2, 2).left_canonicalise()[0]
    p = compile_state_to_ansatz(A, steps=600)
    from qmps_tpu.circuits.ansatze import shallow_full_state
    from qmps_tpu.embed import unitary_to_tensor

    B = unitary_to_tensor(shallow_full_state(p))
    ov = float(iMPS([B]).overlap(iMPS([A])))
    assert ov > 1 - 1e-5


@pytest.mark.slow
def test_batched_quench_sweep_matches_exact():
    """Two vmapped quench trajectories in one program, both tracking the
    exact rate function (the reference ran each as a separate job)."""
    from qmps_tpu.algorithms.evolve import batched_quench_sweep

    times, les = batched_quench_sweep(
        1.5, [0.2, 0.4], t_max=0.6, n_steps=15, inner_steps=80, gs_steps=250
    )
    rates = -np.log(np.asarray(les))
    for j, g1 in enumerate([0.2, 0.4]):
        exact = np.array([float(loschmidt_rate(t, 1.5, g1)) for t in np.asarray(times)])
        assert np.max(np.abs(rates[j] - exact)) < 0.02, g1


@pytest.mark.slow
def test_quench_matches_classical_tdvp_and_exact():
    """Circuit TDVP (D=2) vs exact rate over a short quench horizon
    (scripts/loschmidt.py workload, truncated)."""
    times, rates, rec = loschmidt_echo_run(
        g0=1.5, g1=0.2, t_max=0.8, n_steps=20, inner_steps=100, gs_steps=300
    )
    exact = np.array([float(loschmidt_rate(t, 1.5, 0.2)) for t in np.asarray(times)])
    got = np.asarray(rates)
    # D=2 circuit TDVP w/ finite dt: reference-level agreement
    assert np.max(np.abs(got - exact)) < 0.02
    # and it should track the classical engine more tightly than the oracle
    assert got[-1] > 0.1  # rate has clearly risen by t=0.8


def test_engine_and_shape_validation(key):
    """batched_quench_sweep has one engine (dense vmapped TDVP): an engine
    keyword is refused rather than silently ignored, and malformed inputs
    are rejected loudly before any ground-state work."""
    from qmps_tpu.algorithms.evolve import batched_quench_sweep

    with pytest.raises(TypeError, match="engine"):
        batched_quench_sweep(1.5, [0.2], 0.1, 1, inner_steps=1, gs_steps=2, engine="pallas")
    with pytest.raises(ValueError, match="1-D"):
        batched_quench_sweep(1.5, [[0.2, 0.3]], 0.1, 1, inner_steps=1, gs_steps=2)
    with pytest.raises(ValueError, match="n_steps"):
        batched_quench_sweep(1.5, [0.2], 0.1, 0, inner_steps=1, gs_steps=2)


def test_jit_cache_bounded_and_keyed():
    """The compiled-step cache evicts FIFO at its bound and distinguishes
    gates of identical bytes but different config."""
    from qmps_tpu.algorithms import evolve as ev

    ev._JIT_CACHE.clear()
    for i in range(ev._JIT_CACHE_MAX + 5):
        ev._cached_jit(("k", i), lambda: object())
    assert len(ev._JIT_CACHE) == ev._JIT_CACHE_MAX
    assert ("k", 0) not in ev._JIT_CACHE  # oldest evicted
    assert ("k", ev._JIT_CACHE_MAX + 4) in ev._JIT_CACHE
    ev._JIT_CACHE.clear()

    # same bytes, different shape/dtype -> different keys
    k1 = ev._w_key(np.zeros((2, 8), np.float32))
    k2 = ev._w_key(np.zeros((4, 4), np.float32))
    k3 = ev._w_key(np.zeros((2, 2), np.complex64))
    assert len({k1, k2, k3}) == 3
