"""Monte-Carlo trajectory unraveling of the depolarizing channel.

The reference's noisy optimizer family can simulate either the exact
density matrix or stochastic noise trajectories (the two cirq simulator
modes behind qmps/ground_state.py:337-418).  The density-matrix path
(objectives/noise.py) is exact but rho is 4^n — the 6-qubit TDVP window
is already a 4096^2 matrix.  Here the same channel is unraveled into
pure-state trajectories: after every gate-moment each qubit receives

    I  with prob 1 - p,     X, Y or Z  each with prob p/3,

which reproduces rho -> (1-p) rho + (p/3)(X rho X + Y rho Y + Z rho Z)
exactly in expectation, at 2^n state cost per trajectory.  Trajectories
are embarrassingly parallel: ``vmap`` over PRNG keys is the natural
layout (one batched program, no per-trajectory dispatch), so wider noisy
windows and n_traj ~ 10^3-10^4 are one program call.

The stochastic Pauli is applied as sum_k w_k P_k with a ONE-HOT weight
vector computed from a uniform draw — no data-dependent control flow, so
the whole trajectory jits/vmaps cleanly (lax.switch under vmap would
evaluate every branch anyway; the 4-term select is four cheap 1-qubit
applications' worth of FLOPs in a single gate apply).
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..circuits.ir import apply_unitary
from ..config import CDTYPE, NP_CDTYPE

Op = Tuple[jnp.ndarray, Sequence[int]]

# host constants (numpy arrays embed into jitted programs as literals)
_PAULI_STACK = np.stack(
    [
        np.eye(2),
        np.array([[0, 1], [1, 0]]),
        np.array([[0, -1j], [1j, 0]]),
        np.array([[1, 0], [0, -1]]),
    ]
).astype(np.complex128)


def _stochastic_pauli(u: jnp.ndarray, p) -> jnp.ndarray:
    """(2, 2) gate: I if u < 1-p else X/Y/Z by equal thirds of [1-p, 1)."""
    p = jnp.asarray(p, u.dtype)
    edges = jnp.stack(
        [1.0 - p, 1.0 - 2.0 * p / 3.0, 1.0 - p / 3.0]
    )  # thresholds for k >= 1, 2, 3
    k = jnp.sum(u >= edges)  # 0..3
    w = jax.nn.one_hot(k, 4, dtype=jnp.float32)
    P = jnp.asarray(_PAULI_STACK, dtype=CDTYPE)
    return jnp.tensordot(w.astype(CDTYPE), P, 1)


def trajectory_circuit_state(
    ops: Iterable[Op], n: int, p, key, psi0=None
) -> jnp.ndarray:
    """One stochastic trajectory of the noisy circuit: |0..0> (or psi0)
    through the gates, one sampled Pauli per (moment, qubit) — the
    unraveling of noisy_circuit_rho's per-moment channel."""
    ops = list(ops)
    if psi0 is None:
        psi = jnp.zeros((2**n,), CDTYPE).at[0].set(1.0)
    else:
        psi = psi0.astype(CDTYPE)
    us = jax.random.uniform(key, (len(ops), n))
    for m, (U, wires) in enumerate(ops):
        psi = apply_unitary(psi, U.astype(CDTYPE), wires, n)
        for q in range(n):
            psi = apply_unitary(psi, _stochastic_pauli(us[m, q], p), (q,), n)
    return psi


def trajectory_rho_estimate(ops: Sequence[Op], n: int, p, key, n_traj: int):
    """Mean of |psi><psi| over ``n_traj`` vmapped trajectories — an unbiased
    estimator of noisy_circuit_rho (exact as n_traj -> inf; used by the
    validation tests)."""
    keys = jax.random.split(key, n_traj)

    def one(k):
        psi = trajectory_circuit_state(ops, n, p, k)
        return jnp.outer(psi, psi.conj())

    return jnp.mean(jax.vmap(one)(keys), axis=0)


def trajectory_energy(
    state_ops: Sequence[Op],
    n_state: int,
    V: jnp.ndarray,
    h: jnp.ndarray,
    p,
    key,
    n_traj: int = 512,
) -> jnp.ndarray:
    """MC-trajectory estimate of objectives.noise.noisy_energy: same
    circuit (V, two state-circuit copies), same per-moment channel, but
    E = mean_traj <psi| I_D (x) h (x) I_D |psi> over pure states."""
    from ..core.paulis import kron_all

    kv = int(V.shape[0]).bit_length() - 1
    n = 2 + kv
    D = 2 ** (kv // 2)
    ops = [(V, tuple(range(2, 2 + kv)))]
    ops += [(U, tuple(w + 1 for w in wires)) for U, wires in state_ops]
    ops += list(state_ops)
    eye = np.eye(D, dtype=NP_CDTYPE)
    H = kron_all([jnp.asarray(eye), h.astype(CDTYPE), jnp.asarray(eye)])
    keys = jax.random.split(key, n_traj)

    def one(k):
        psi = trajectory_circuit_state(ops, n, p, k)
        return jnp.vdot(psi, H @ psi).real

    return jnp.mean(jax.vmap(one)(keys))


def trajectory_tdvp_p0(
    A: jnp.ndarray,
    B: jnp.ndarray,
    W: jnp.ndarray,
    r: jnp.ndarray,
    p,
    key,
    n_traj: int = 512,
) -> jnp.ndarray:
    """MC-trajectory estimate of the noisy Bell-form TDVP amplitude
    rho[0, 0] (objectives.noise.noisy_tdvp_amplitude): mean |<0...0|psi>|^2
    over trajectories of the same 6-qubit circuit."""
    from .overlap import bell_tdvp_ops

    ops = bell_tdvp_ops(A, B, W, r)
    keys = jax.random.split(key, n_traj)

    def one(k):
        psi = trajectory_circuit_state(ops, 6, p, k)
        return jnp.abs(psi[0]) ** 2

    return jnp.mean(jax.vmap(one)(keys))


def trajectory_tdvp_objective(A, B, W, p, key, n_traj: int = 512) -> jnp.ndarray:
    """-sqrt(2 sqrt(P0)) with P0 from trajectories — the MC face of
    objectives.noise.noisy_tdvp_objective."""
    from ..mps import transfer as tr
    from .overlap import mixed_transfer_with_gate

    WAA, BB = mixed_transfer_with_gate(A, B, W)
    _, r = tr.right_fixed_point(WAA, BB)
    p0 = trajectory_tdvp_p0(A, B, W, r, p, key, n_traj)
    return -jnp.sqrt(2.0 * jnp.sqrt(jnp.maximum(p0, 0.0)))
