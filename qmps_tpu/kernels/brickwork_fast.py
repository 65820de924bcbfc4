"""Batched brickwork contractions as flat matmuls.

The reference's hot kernel is a 13-operand einsum over rank-4 tensors of
dim 2 (ManifoldOverlap.circuit).  Vmapped as it stands, that form is a
deep chain of tiny-dim reshapes that compiles slowly.

This module re-expresses the same contractions as a short pipeline of
*batched flat matmuls* — (B, 16, 16) kron blocks applied to (B, 2, 16, 2)
state slabs — which compiles in seconds and keeps the batch dimension
leading.  Numerics are identical to
circuits.brickwork.manifold_overlap (tested to 1e-12 on CPU).

Layout: 64 = (q0)(q1 q2 q3 q4)(q5); the U2 layer partitions as
(q0 q1)(q2 q3)(q4 q5), the U1 layer and the Ml (x) W (x) Mr center as
(q0)(q1..q4)(q5).
"""
from __future__ import annotations

import jax.numpy as jnp


def _kron_b(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Batched Kronecker product: (B, m, m) x (B, n, n) -> (B, mn, mn)."""
    b, m, _ = A.shape
    n = B.shape[-1]
    return jnp.einsum("bij,bkl->bikjl", A, B).reshape(b, m * n, m * n)


def manifold_overlap_batched(U1, U2, U1p, U2p, Mr, Ml, W) -> jnp.ndarray:
    """<psi(U1p, U2p)| Ml (x) W (x) Mr |psi(U1, U2)> for a batch of brick
    pairs (the mcircuit form, ClassicalTDVPStripped.py:277-283).

    U1, U2, U1p, U2p: (B, 4, 4) unitaries; Mr, Ml: (B, 2, 2); W: (16, 16).
    Returns (B,) complex overlaps.
    """
    Bn = U1.shape[0]
    c2 = U2[:, :, 0]  # (B, 4): the U2 layer acting on |00>
    v = jnp.einsum("bi,bj,bk->bijk", c2, c2, c2).reshape(Bn, 2, 16, 2)
    K = _kron_b(U1, U1)  # (B, 16, 16)
    v = jnp.einsum("bij,bajc->baic", K, v)
    v = jnp.einsum("ij,bajc->baic", W, v)
    v = jnp.einsum("bxa,baic->bxic", Ml, v)
    v = jnp.einsum("byc,baic->baiy", Mr, v)
    Kp = _kron_b(U1p, U1p)
    v = jnp.einsum("bji,bajc->baic", Kp.conj(), v)  # apply Kp^dag
    r2 = U2p[:, :, 0].conj()  # row 0 of U2p^dag, three-fold
    v = v.reshape(Bn, 4, 4, 4)
    return jnp.einsum("bi,bj,bk,bijk->b", r2, r2, r2, v)
