"""Fixed-shape Krylov solvers: Arnoldi eigensolver + restarted GMRES.

Two consumers in the framework:

- the matvec fixed-point path for large bond dimension (``mps/transfer.py``),
  where the dense D^2 x D^2 transfer matrix is too big to materialize and
  plain power iteration stalls on near-degenerate spectra (measured: 0.018
  eigenvalue error at gap ratio ~0.99 — exactly where TDVP sits near
  dynamical phase transitions).  The reference dodges this with dense
  ``scipy.linalg.eig`` + argmax (new_tdvp/ClassicalTDVPStripped.py:424-431),
  which is CPU-only and non-differentiable.
- the implicit-function adjoint of that path, which needs a bordered
  (n+1)-dim linear solve.  Unlike ``jax.scipy.sparse.linalg.gmres`` (a
  data-dependent ``while_loop``), the restarted fixed-iteration GMRES here
  is pure matmuls + one small dense least-squares per restart, with static
  shapes throughout.

Everything is jit/vmap-safe: no data-dependent control flow, no
``while_loop``; iteration counts are static arguments.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax


def arnoldi(matvec: Callable, v0: jnp.ndarray, k: int):
    """k-step Arnoldi factorization  A Q_k = Q_{k+1} H  (rows of Q are the
    basis vectors).

    Returns (Q, H) with Q of shape (k+1, n), H of shape (k+1, k).  Uses
    classical Gram-Schmidt with one reorthogonalization pass (two dense
    (k+1, n) matvecs per step — matrix-unit shaped, no inner python loop).
    On breakdown (invariant subspace found) the next basis vector is
    numerically garbage but its H column entry is ~0, so Ritz values and
    GMRES least-squares solutions are unaffected.
    """
    n = v0.shape[0]
    dtype = v0.dtype
    nrm0 = jnp.linalg.norm(v0)
    Q0 = jnp.zeros((k + 1, n), dtype).at[0].set(
        v0 / jnp.maximum(nrm0, jnp.finfo(v0.real.dtype).tiny)
    )
    H0 = jnp.zeros((k + 1, k), dtype)

    def step(carry, j):
        Q, H = carry
        w = matvec(Q[j])
        mask = (jnp.arange(k + 1) <= j).astype(w.real.dtype)
        # orthogonalize against the filled rows (rows > j are zero anyway;
        # the mask guards against garbage rows after a breakdown)
        h = (Q.conj() @ w) * mask
        w = w - Q.T @ h
        h2 = (Q.conj() @ w) * mask
        w = w - Q.T @ h2
        h = h + h2
        beta = jnp.linalg.norm(w)
        Q = Q.at[j + 1].set(w / jnp.maximum(beta, jnp.finfo(w.real.dtype).tiny))
        H = H.at[:, j].set(h).at[j + 1, j].set(beta.astype(dtype))
        return (Q, H), None

    (Q, H), _ = lax.scan(step, (Q0, H0), jnp.arange(k))
    return Q, H


def dominant_eigpair_arnoldi(
    matvec: Callable,
    v0: jnp.ndarray,
    k: int = 32,
    restarts: int = 3,
):
    """Dominant (largest |lam|) eigenpair by restarted Arnoldi.

    Each cycle: k-step Arnoldi, dominant Ritz pair of the small (k, k)
    Hessenberg matrix by repeated squaring (log2-convergent for ANY spectral
    gap — see core.linalg.dominant_eig_dense), restart from the Ritz
    vector.  Near-degenerate dominant pairs (gap ratio ~0.999) are resolved
    because both vectors enter the Krylov space and the projected problem
    separates them exactly.  Differentiable, but consumers should wrap it in
    an implicit-function custom_vjp (see transfer._right_eigpair_matvec).

    Returns (lam, v) with |v| = 1 (phase arbitrary).
    """
    from .linalg import dominant_eig_dense

    def cycle(v, _):
        Q, H = arnoldi(matvec, v, k)
        lam, y = dominant_eig_dense(H[:k, :k], n_squarings=50)
        v = Q[:k].T @ y
        v = v / jnp.linalg.norm(v)
        return v, lam

    v, lams = lax.scan(cycle, v0 / jnp.linalg.norm(v0), None, length=restarts)
    # Rayleigh quotient on the final vector (more accurate than the last
    # cycle's Ritz value when the restart improved v)
    lam = jnp.vdot(v, matvec(v))
    return lam, v


def gmres_solve(
    matvec: Callable,
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    k: int = 40,
    restarts: int = 4,
):
    """Restarted GMRES(k) with static shapes — a fixed-iteration
    replacement for jax.scipy.sparse.linalg.gmres (a data-dependent
    while_loop) inside lax.scan.

    Per restart: Arnoldi on the residual, then the (k+1, k) least-squares
    problem min |beta e1 - H y| via dense lstsq (tiny).  Returns x after
    restarts * k total matvecs, plus the final residual norm.
    """
    x0 = jnp.zeros_like(b) if x0 is None else x0

    def cycle(x, _):
        r = b - matvec(x)
        beta = jnp.linalg.norm(r)
        Q, H = arnoldi(matvec, r, k)
        e1 = jnp.zeros((k + 1,), b.dtype).at[0].set(beta.astype(b.dtype))
        y, *_ = jnp.linalg.lstsq(H, e1)
        x = x + Q[:k].T @ y
        return x, beta

    x, betas = lax.scan(cycle, x0, None, length=restarts)
    res = jnp.linalg.norm(b - matvec(x))
    return x, res
