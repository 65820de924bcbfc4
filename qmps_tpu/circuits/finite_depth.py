"""Finite-depth brick-wall (staircase/lightcone) states.

JAX rebuild of scripts/finite_depth/finite_depth.py: pyramid-shaped
brick-wall circuits of a given depth approximating the infinite state on a
finite window, their growth under a Trotter layer, and central-window
expectation values — the machinery behind the reference's local-vs-global
overlap comparisons.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import CDTYPE
from ..core import gates as g
from ..core.paulis import I2, kron_all
from .ir import apply_unitary


def ladder_ansatz(p) -> jnp.ndarray:
    """Rx (x) Rx, Rz (x) Rz + CNOT per 4 params — the pure-numpy CNOT-ladder
    ansatz of scripts/ground_state_finding.py:83-92."""
    p = jnp.asarray(p)
    pad = (-p.shape[0]) % 4
    p = jnp.concatenate([p, jnp.zeros((pad,), p.dtype)])
    U = jnp.eye(4, dtype=CDTYPE)
    for w, x, u, v in p.reshape(-1, 4):
        U = g.CNOT @ jnp.kron(g.rz(u), g.rz(v)) @ jnp.kron(g.rx(w), g.rx(x)) @ U
    return U


def real_ansatz(p) -> jnp.ndarray:
    """Ry (x) Ry + CZ per 2 params: a real-valued 2-qubit family
    (scripts/ground_state_finding.py:94-102, finite_depth.py)."""
    p = jnp.asarray(p)
    pad = (-p.shape[0]) % 2
    p = jnp.concatenate([p, jnp.zeros((pad,), p.dtype)])
    U = jnp.eye(4, dtype=CDTYPE)
    for w, x in p.reshape(-1, 2):
        U = g.CZ @ jnp.kron(g.ry(w), g.ry(x)) @ U
    return U


def real_hermitian_ansatz(p) -> jnp.ndarray:
    """Real hermitian 2-qubit family via controlled-Ry conjugations
    (scripts/ground_state_finding.py:104-110)."""
    p = jnp.asarray(p)
    U = jnp.eye(4, dtype=CDTYPE)
    for w in p:
        ent = g.SWAP @ g.cry(jnp.pi - w) @ g.SWAP @ g.cry(-w)
        U = ent @ jnp.kron(g.ry(w), I2) @ U
    return U


def staircase_state(U: jnp.ndarray, depth: int = 2, support: int = 2) -> jnp.ndarray:
    """Pyramid brick-wall state: ``depth`` staggered layers of the 2-qubit
    brick U over a window wide enough that the central ``support`` qubits
    see the full lightcone (brick_wall_state, finite_depth.py:66-81).

    Layer k applies U on pairs offset by k qubits from each edge — the
    WIDEST layer first, narrowing toward the central support (the
    lightcone pyramid of finite_depth.py:76-81, where width runs
    depth..1 so offset = depth - width increases).  With the orientation
    inverted (narrowest first) the central qubits do NOT see the full
    lightcone: the central 2-qubit RDM differed from the wide-window
    brickwork reference by 0.93 in Frobenius norm (it matches to 4e-15
    this way — regression-tested).  Qubit count =
    2 (depth - 1) + 2 ceil(support / 2).
    """
    n = 2 * (depth - 1) + 2 * ((support + 1) // 2)
    psi = jnp.zeros((2**n,), CDTYPE).at[0].set(1.0)
    for off in range(depth):  # offset from each edge, widest layer first
        for q in range(off, n - off - 1, 2):
            psi = apply_unitary(psi, U, (q, q + 1), n)
    return psi


def grow_staircase(U: jnp.ndarray, W: jnp.ndarray, depth: int = 2, support: int = 2) -> jnp.ndarray:
    """State of depth+2 whose two INNERMOST (last-applied, narrowest)
    layers are the Trotter brick W instead of U (brick_wall_state.grow,
    finite_depth.py:84-106, widths 2 and 1): finite-depth evolution of
    the staircase."""
    total = depth + 2
    n = 2 * (total - 1) + 2 * ((support + 1) // 2)
    psi = jnp.zeros((2**n,), CDTYPE).at[0].set(1.0)
    for off in range(total):  # widest first; the last two layers are W
        brick = U if off < depth else W
        for q in range(off, n - off - 1, 2):
            psi = apply_unitary(psi, brick, (q, q + 1), n)
    return psi


def central_expectation(psi: jnp.ndarray, H: jnp.ndarray) -> jnp.ndarray:
    """<H> on the central 2 qubits (brick_wall_state.ev, finite_depth.py:108-113)."""
    n = int(psi.shape[0]).bit_length() - 1
    if H.shape[0] == 2:
        H = jnp.kron(H, I2)
    pad = (n - 2) // 2
    Hfull = kron_all([I2] * pad + [H.astype(CDTYPE)] + [I2] * (n - 2 - pad))
    return jnp.real(psi.conj() @ (Hfull @ psi))


def brick_wall_unitary(U: jnp.ndarray, depth: int = 2) -> jnp.ndarray:
    """The (depth+1)-qubit staircase unitary whose first column block embeds
    the finite-depth MPS isometry (brick_wall_unitary, finite_depth.py:122-130)."""
    n = depth + 1
    from .ir import circuit_unitary

    ops = [(U, (n - 2 - i, n - 1 - i)) for i in range(depth)]
    return circuit_unitary(ops, n)


def local_global_overlap(U1: jnp.ndarray, U2: jnp.ndarray, depth: int, support: int = 2):
    """(local, global) overlaps of two staircase states: the central-window
    fidelity vs the full-window fidelity — the reference's finite-depth
    local-vs-global comparison."""
    psi1 = staircase_state(U1, depth, support)
    psi2 = staircase_state(U2, depth, support)
    n = int(psi1.shape[0]).bit_length() - 1
    glob = jnp.abs(jnp.vdot(psi1, psi2)) ** 2
    # local: fidelity of the reduced density matrices on the central pair
    from ..env.variational import reduced_density_matrix

    mid = [(n - 2) // 2, (n - 2) // 2 + 1]
    r1 = reduced_density_matrix(psi1, mid, n)
    r2 = reduced_density_matrix(psi2, mid, n)
    # Uhlmann fidelity via the PSD square-root-free form
    s1 = _sqrtm_psd(r1)
    inner = s1 @ r2 @ s1
    loc = jnp.real(jnp.trace(_sqrtm_psd(inner))) ** 2
    return loc, glob


def _sqrtm_psd(M: jnp.ndarray) -> jnp.ndarray:
    w, V = jnp.linalg.eigh((M + M.conj().T) / 2)
    w = jnp.clip(w, 0.0, None)
    return (V * jnp.sqrt(w)[None, :]) @ V.conj().T
