"""TDVP overlap objectives.

The canonical TDVP cost (qmps/new_time_evolve.py:193-221 `obj`,
scripts/loschmidt.py:209-239): given the current left-canonical tensor A and
the Trotter gate W = exp(-i h dt), score a candidate tensor B by the
per-site overlap density of |psi(B)> with W|psi(A)> — the dominant
eigenvalue x of the mixed transfer operator E = Map(W (A (x) A), B (x) B).

Fast path: return -|x| directly from the differentiable fixed-point solve.
Circuit path: reproduce the reference's 5/6-qubit Hadamard-test circuit
amplitude exactly (for parity tests and for the noisy/sampled variants).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..circuits.ir import circuit_state, dagger_ops
from ..config import CDTYPE
from ..core import gates as g
from ..embed.unitaries import (
    put_env_on_left_site,
    put_env_on_right_site,
    tensor_to_unitary,
)
from ..mps import transfer as tr
from ..mps.imps import merge


def mixed_transfer_with_gate(A: jnp.ndarray, B: jnp.ndarray, W: jnp.ndarray):
    """E = Map(W (A (x) A), B (x) B): blocked 2-site mixed transfer with the
    Trotter gate applied to the ket."""
    AA = merge(A, A)
    WAA = jnp.tensordot(W.astype(A.dtype), AA, [[1], [0]])
    BB = merge(B, B)
    return WAA, BB


def tdvp_objective(A: jnp.ndarray, B: jnp.ndarray, W: jnp.ndarray) -> jnp.ndarray:
    """-|x|: maximize the per-site fidelity density (fast path).

    Only the eigenvalue is consumed, so the implicit adjoint applies: the
    backward pass is one extra eigen-solve + a rank-1 outer product instead
    of differentiating through the squaring iteration."""
    WAA, BB = mixed_transfer_with_gate(A, B, W)
    E = tr.transfer_dense(WAA, BB)
    x = tr.dominant_eigval_dense(E)
    return -jnp.abs(x)


def bell_tdvp_ops(A: jnp.ndarray, B: jnp.ndarray, W: jnp.ndarray, r: jnp.ndarray):
    """THE 6-qubit Bell-form TDVP circuit as an op list — the single
    shared builder behind the exact amplitude (below), the density-matrix
    noise channel (objectives/noise.py) and the MC-trajectory unraveling
    (objectives/trajectories.py): Bell pair, two U's up, W across the
    physical legs, L from r^dag on top, R from r on the bottom, two
    U'^dag down, CNOT + H (scripts/loschmidt.py:227-238)."""
    U = tensor_to_unitary(A)
    Ud = tensor_to_unitary(B)
    R = put_env_on_left_site(r)
    L = put_env_on_right_site(r.conj().T)
    ops = [
        (g.H, (3,)),
        (g.CNOT, (3, 4)),
        (U, (2, 3)),
        (U, (1, 2)),
        (W.astype(CDTYPE), (2, 3)),
        (L, (0, 1)),
        (R, (4, 5)),
    ]
    ops += dagger_ops([(Ud, (1, 2))])
    ops += dagger_ops([(Ud, (2, 3))])
    ops += [(g.CNOT, (3, 4)), (g.H, (3,))]
    return ops


def hadamard_test_amplitude(
    A: jnp.ndarray, B: jnp.ndarray, W: jnp.ndarray, r: jnp.ndarray
) -> jnp.ndarray:
    """2 psi[0] of the 6-qubit Bell-prepared TDVP circuit
    (scripts/loschmidt.py:227-238): Bell pair, two U's up, W across the
    physical legs, L from r^dag on top, R from r on the bottom, two U'^dag
    down, CNOT + H.

    For L/R both built from the normalized fixed point r of
    E = Map(W (A x A), B x B) the value is exactly x * Tr(r^dag r) = x: the
    Bell preparation/readout addresses only the deterministic rows of the
    environment embeddings, so the amplitude is completion-independent.
    (The reference's *5-qubit* variant, new_time_evolve.py:210-221, applies
    R directly to |00> and leaks arbitrary null-space completion components
    into the amplitude — verified numerically against a scipy mirror — so
    we canonicalize on the Bell form, which the reference itself uses for
    its identity battery and production Loschmidt runs.)
    """
    psi = circuit_state(bell_tdvp_ops(A, B, W, r), 6)
    return 2 * psi[0]


def get_overlap_exact(A: jnp.ndarray, B: jnp.ndarray):
    """(|x|^2, r): per-site overlap density of two uMPS tensors
    (qmps/time_evolve_tools.py:84-91)."""
    x, r = tr.right_fixed_point(A, B)
    return jnp.abs(x) ** 2, r


def get_overlap_variational(
    A: jnp.ndarray, B: jnp.ndarray, steps: int = 400, lr: float = 5e-2, key=None
):
    """Fully variational overlap: optimize an 8-real-param environment r to
    maximize the Bell-form circuit amplitude (qmps/time_evolve_tools.py:95-131),
    gradient-based.  Returns (|amp|, r)."""
    import jax
    import optax

    from ..core.linalg import rotate_to_hermitian

    import numpy as np

    from ..config import NP_CDTYPE

    key = jax.random.PRNGKey(0) if key is None else key
    W = np.eye(4, dtype=NP_CDTYPE)  # host constant, embedded in the jit

    def amp_of(rs):
        r = rotate_to_hermitian((rs[:4] + 1j * rs[4:]).reshape(2, 2))
        r = r / jnp.linalg.norm(r)
        return hadamard_test_amplitude(A, B, W, r)

    def loss(rs):
        return -jnp.abs(amp_of(rs))

    opt = optax.adam(lr)

    @jax.jit
    def run(v0):
        def step(carry, _):
            v, s = carry
            g = jax.grad(loss)(v)
            up, s = opt.update(g, s)
            return (optax.apply_updates(v, up), s), None

        (v, _), _ = jax.lax.scan(step, (v0, opt.init(v0)), None, length=steps)
        return v

    v = run(jax.random.normal(key, (8,)))
    r = rotate_to_hermitian((v[:4] + 1j * v[4:]).reshape(2, 2))
    return jnp.abs(amp_of(v)), r / jnp.linalg.norm(r)


def tdvp_objective_circuit(A: jnp.ndarray, B: jnp.ndarray, W: jnp.ndarray) -> jnp.ndarray:
    """Circuit-path objective: -|2 psi[0]| = -|x|, identical to the fast
    path (the reference's -sqrt(2|psi[0]|) is the same monotone ranking)."""
    WAA, BB = mixed_transfer_with_gate(A, B, W)
    _, r = tr.right_fixed_point(WAA, BB)
    amp = hadamard_test_amplitude(A, B, W, r)
    return -jnp.abs(amp)
