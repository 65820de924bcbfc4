"""Gen-2 brickwork stack: state builders, tensor converters, energies,
TDVP evolution, and the batched flat-matmul kernel's exactness."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmps_tpu.algorithms.brickwork_tdvp import (
    BrickworkEvolver,
    bw_layer_energy,
    brickwork_energy,
    evolve_cost_exact_env,
    optimize_brickwork,
)
from qmps_tpu.circuits.brickwork import (
    bricks_to_tensor_left,
    bw_state,
    manifold_overlap,
    param_bricks,
)
from qmps_tpu.core.linalg import random_unitary
from qmps_tpu.ham import tfim, tfim_gs_energy
from qmps_tpu.kernels import manifold_overlap_batched
from qmps_tpu.mps.imps import iMPS


def test_param_bricks_unitary(key):
    U1, U2 = param_bricks(jax.random.normal(key, (22,)))
    for U in (U1, U2):
        np.testing.assert_allclose(
            np.asarray(U.conj().T @ U), np.eye(4), atol=1e-10
        )


def test_bw_state_normalized(key):
    U1, U2 = param_bricks(jax.random.normal(key, (22,)))
    for l in (2, 3):
        psi = bw_state(U1, U2, l)
        np.testing.assert_allclose(float(jnp.linalg.norm(psi)), 1.0, atol=1e-10)


def test_windowed_energy_identity_bricks():
    """Zero params -> identity bricks -> |00..> product: <-ZZ> = -1."""
    from qmps_tpu.core.paulis import Z

    h = -jnp.kron(Z, Z)
    e_win = float(brickwork_energy(jnp.zeros(22), h))
    np.testing.assert_allclose(e_win, -1.0, atol=1e-9)


def test_bricks_to_tensor_canonical_forms(key):
    """Brick -> MPS tensor conversion (BrickWallMPS.py:89-111): the
    left-leaning form is left-canonical and the right-leaning form is
    right-canonical after reordering to (d, D, D)."""
    p = jax.random.normal(key, (22,)) * 0.4
    U1, U2 = param_bricks(p)
    from qmps_tpu.circuits.brickwork import bricks_to_tensor_right

    AL = jnp.transpose(bricks_to_tensor_left(U1, U2), (1, 0, 2))
    g = sum(np.asarray(AL[s]).conj().T @ np.asarray(AL[s]) for s in range(4))
    np.testing.assert_allclose(g, np.eye(2), atol=1e-10)
    AR = jnp.transpose(bricks_to_tensor_right(U1, U2), (1, 0, 2))
    gr = sum(np.asarray(AR[s]) @ np.asarray(AR[s]).conj().T for s in range(4))
    np.testing.assert_allclose(gr, np.eye(2), atol=1e-10)


def test_brickwork_env_matches_blocked_map(key):
    """The brickwork right-transfer eigenvalue equals the dominant
    eigenvalue of the mixed transfer map of the blocked (d=4) tensors —
    the two gen-2 representations describe the same physics."""
    from qmps_tpu.circuits.brickwork import exact_right_env
    from qmps_tpu.mps.imps import Map

    p1 = jax.random.normal(key, (22,)) * 0.4
    p2 = jax.random.normal(jax.random.fold_in(key, 1), (22,)) * 0.4
    U1, U2 = param_bricks(p1)
    U1p, U2p = param_bricks(p2)
    eta, _ = exact_right_env(U1, U2, U1p.conj().T, U2p.conj().T)
    A = jnp.transpose(bricks_to_tensor_left(U1, U2), (1, 0, 2))
    B = jnp.transpose(bricks_to_tensor_left(U1p, U2p), (1, 0, 2))
    x, _ = Map(A, B).right_fixed_point()
    np.testing.assert_allclose(complex(eta), complex(x), atol=1e-8)


def test_fast_kernel_matches_einsum(key):
    B = 5
    mk = lambda s, n: jax.vmap(lambda k: random_unitary(k, n))(
        jax.random.split(jax.random.fold_in(key, s), B)
    )
    U1, U2, U1p, U2p = mk(0, 4), mk(1, 4), mk(2, 4), mk(3, 4)
    M = mk(4, 2)
    W = random_unitary(jax.random.fold_in(key, 9), 16)
    ref = jnp.stack(
        [
            manifold_overlap(
                U1[i], U2[i], U1p[i].conj().T, U2p[i].conj().T,
                M[i], jnp.swapaxes(M[i], -1, -2).conj(), W,
            )
            for i in range(B)
        ]
    )
    fast = manifold_overlap_batched(
        U1, U2, U1p, U2p, M, jnp.swapaxes(M, -1, -2).conj(), W
    )
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), atol=1e-12)


@pytest.mark.slow
def test_brickwork_loschmidt_tracks_exact():
    """Gen-2 Loschmidt pipeline (new_tdvp/LoschmidtEchos.py): the 22-param
    brickwork TDVP rate function tracks the exact quench oracle at
    reference-level fidelity over a short horizon."""
    from qmps_tpu.algorithms.brickwork_tdvp import (
        loschmidt_echo_brickwork,
        quench_window_gate,
    )
    from qmps_tpu.ham import loschmidt_rate, tfim

    res = optimize_brickwork(tfim(1.5).to_matrix(), steps=400)
    dt = 0.05
    W = quench_window_gate(tfim(0.2).to_matrix(), dt)
    les, traj, costs = loschmidt_echo_brickwork(
        res.x, jnp.asarray(W), n_steps=12, inner_steps=120
    )
    rates = -np.log(np.asarray(les)) / 2  # per site (cell = 2 sites)
    ts = np.arange(1, 13) * dt
    exact = np.array([float(loschmidt_rate(t, 1.5, 0.2)) for t in ts])
    assert np.max(np.abs(rates - exact)) < 0.05
    assert rates[-1] > rates[0]  # the echo is building up


def test_brickwork_ground_state():
    res = optimize_brickwork(tfim(1.0).to_matrix(), steps=250)
    # windowed objective is an approximation; reference-level accuracy
    assert res.fun - float(tfim_gs_energy(1.0)) < 5e-2


def test_brickwork_evolve_stationary(key):
    """W = I: the evolution objective (which carries the reference's
    unit-Frobenius environment normalization, so its value is not -1) is
    near-stationary at params_new = params_cur: a few warm-started inner
    steps barely move the parameters."""
    p = jax.random.normal(key, (22,)) * 0.3
    ev = BrickworkEvolver(jnp.eye(16, dtype=jnp.complex128), inner_steps=40, lr=5e-3)
    traj, costs = ev.time_evolve(p, 2)
    drift = float(jnp.linalg.norm(traj[-1] - traj[0]))
    assert drift < 0.2, drift
    # and the cost is a (locally) maximal overlap: perturbations don't help
    c0 = float(evolve_cost_exact_env(p, p, jnp.eye(16, dtype=jnp.complex128)))
    assert c0 < 0


def test_bricks_from_tensor_structure(key):
    """Us_from_A port (new_tdvp/loschmidt_classical.py:93-141): the QR+polar
    split returns genuine unitaries and is deterministic."""
    from qmps_tpu.circuits.brickwork import bricks_from_tensor
    from qmps_tpu.mps.imps import iMPS, random_tensor

    A = iMPS([random_tensor(key, 2, 2)]).left_canonicalise()[0]
    U1, U2 = bricks_from_tensor(A)
    np.testing.assert_allclose(
        np.asarray(U1 @ U1.conj().T), np.eye(4), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(U2 @ U2.conj().T), np.eye(4), atol=1e-12
    )
    U1b, U2b = bricks_from_tensor(A)
    np.testing.assert_allclose(np.asarray(U1), np.asarray(U1b), atol=1e-14)


@pytest.mark.slow
def test_warm_start_quench_tracks_exact_rate():
    """The classical warm start: compile a classically
    found D=2 TFIM ground state into the brickwork manifold, quench with
    the calibrated window gate, and reproduce the exact rate to < 1e-2."""
    from qmps_tpu.algorithms import find_ground_state
    from qmps_tpu.algorithms.brickwork_tdvp import (
        BrickworkEvolver,
        compile_tensor_to_bricks,
        quench_window_gate,
    )
    from qmps_tpu.circuits.brickwork import bricks_to_tensor_left
    from qmps_tpu.ham import loschmidt_rate
    from qmps_tpu.mps.imps import iMPS

    res = find_ground_state(tfim(1.5), D=2, steps=400)
    p, ov = compile_tensor_to_bricks(res.A)
    assert float(ov) > 0.99  # manifold distance at g=1.5 is ~7.7e-3

    dt = 0.025
    W = quench_window_gate(tfim(0.2).to_matrix(), dt)
    ev = BrickworkEvolver(jnp.asarray(W), inner_steps=200, lr=5e-2)
    traj, _ = ev.time_evolve(p, 12)

    def blocked(pp):
        U1, U2 = param_bricks(pp)
        return jnp.transpose(bricks_to_tensor_left(U1, U2), (1, 0, 2))

    psi0 = iMPS([blocked(traj[0])])
    rates = np.array(
        [-np.log(float(iMPS([blocked(q)]).overlap(psi0))) / 2 for q in traj[1:]]
    )
    ts = np.arange(1, 13) * dt
    exact = np.array([float(loschmidt_rate(t, 1.5, 0.2)) for t in ts])
    assert np.max(np.abs(rates - exact)) < 1e-2
    assert rates[-1] > rates[0]
