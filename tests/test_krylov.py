"""Krylov solvers: restarted Arnoldi eigensolver + fixed-shape GMRES.

Covers the large-D fixed-point path (SURVEY section 7 hard-part 1 /
build-stage B1 "power + Arnoldi"): near-degenerate spectra where plain
power iteration stalls, and the bordered adjoint solve that backs the
matvec custom_vjp in mps/transfer.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmps_tpu.core.krylov import arnoldi, dominant_eigpair_arnoldi, gmres_solve
from qmps_tpu.mps import transfer as tr


def _random_matrix_with_gap(rng, n, gap_ratio):
    """Dense matrix with |lam_2| / |lam_1| = gap_ratio, random eigenbasis."""
    evals = np.concatenate(
        [[1.0, gap_ratio], rng.uniform(0.1, 0.9 * gap_ratio, n - 2)]
    ).astype(np.complex128)
    Q = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))[0]
    return Q @ np.diag(evals) @ Q.conj().T, Q[:, 0]


def test_arnoldi_factorization(rng):
    n, k = 40, 12
    M = jnp.asarray(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    v0 = jnp.asarray(rng.normal(size=(n,)) + 0j)
    Q, H = arnoldi(lambda x: M @ x, v0, k)
    # A Q_k^T = Q_{k+1}^T H  and orthonormal basis
    assert np.linalg.norm(M @ Q[:k].T - Q.T @ H) < 1e-10
    assert np.linalg.norm(Q.conj() @ Q.T - np.eye(k + 1)) < 1e-10


@pytest.mark.parametrize(
    "gap_ratio",
    [0.5, pytest.param(0.99, marks=pytest.mark.slow), pytest.param(0.999, marks=pytest.mark.slow)],
)
def test_arnoldi_near_degenerate(rng, gap_ratio):
    """Engineered gap ratio up to 0.999 at n = 1024 (D=32): residual < 1e-8.

    Power iteration stalls here (measured 0.018 eigenvalue error at ~0.99);
    the restarted Arnoldi resolves the dominant pair because both
    near-degenerate vectors enter the Krylov space.
    """
    # gap 0.5 is the fast-suite smoke row: a smaller problem keeps the
    # one-CPU compile cheap; the hard 0.99/0.999 rows stay at n = 1024
    n, k, restarts = (1024, 48, 4) if gap_ratio > 0.9 else (256, 24, 2)
    M, v_true = _random_matrix_with_gap(rng, n, gap_ratio)
    M = jnp.asarray(M)
    v0 = jnp.asarray(rng.normal(size=(n,)) + 0j)
    lam, v = jax.jit(
        lambda v0: dominant_eigpair_arnoldi(lambda x: M @ x, v0, k=k, restarts=restarts)
    )(v0)
    assert abs(complex(lam) - 1.0) < 1e-9
    residual = np.linalg.norm(M @ v - lam * v)
    assert residual < 1e-8
    overlap = abs(np.vdot(np.asarray(v), v_true))
    assert overlap > 1 - 1e-8


def test_gmres_solve_exact_at_full_k(rng):
    """k = n makes GMRES a direct solver regardless of spectrum."""
    n = 60
    Amat = jnp.asarray(
        rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    ) + 4.0 * jnp.eye(n)
    b = jnp.asarray(rng.normal(size=(n,)) + 1j * rng.normal(size=(n,)))
    x, res = gmres_solve(lambda v: Amat @ v, b, k=n, restarts=1)
    assert float(res) < 1e-10
    assert np.linalg.norm(Amat @ x - b) < 1e-10


def test_gmres_solve_restarted(rng):
    """Restarted GMRES(k << n) converges when the field of values excludes
    the origin (the transfer-operator bordered systems have this shape)."""
    n = 200
    Amat = jnp.asarray(
        rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    ) + 20.0 * jnp.eye(n)
    b = jnp.asarray(rng.normal(size=(n,)) + 1j * rng.normal(size=(n,)))
    x, res = gmres_solve(lambda v: Amat @ v, b, k=40, restarts=10)
    assert np.linalg.norm(Amat @ x - b) < 1e-10


def test_matvec_fixed_point_matches_dense(key):
    """right_fixed_point(dense=False) agrees with the dense solver at D=8."""
    from qmps_tpu.mps.imps import iMPS

    A = iMPS.random(key, 2, 8)[0]
    lam_d, r_d = tr.right_fixed_point(A, A, dense=True)
    lam_m, r_m = tr.right_fixed_point(A, A, dense=False, iters=200)
    assert abs(complex(lam_d) - complex(lam_m)) < 1e-9
    assert np.linalg.norm(np.asarray(r_d) - np.asarray(r_m)) < 1e-8


def test_matvec_gradients_match_dense(key):
    """The bordered-GMRES implicit adjoint of the matvec path reproduces the
    dense path's gradients (both against the same scalar objective)."""
    from qmps_tpu.mps.imps import iMPS

    A = iMPS.random(key, 2, 4)[0]

    def loss(A, dense):
        lam, r = tr.right_fixed_point(A, A, dense=dense, iters=200)
        return (jnp.abs(lam) + jnp.abs(jnp.trace(r))).real

    g_dense = jax.grad(lambda A: loss(A, True))(A)
    g_matvec = jax.grad(lambda A: loss(A, False))(A)
    assert np.linalg.norm(np.asarray(g_dense) - np.asarray(g_matvec)) < 1e-7


def test_matvec_grad_under_scan(key):
    """The shape that ruled out jax.scipy's while_loop gmres as the
    adjoint: a value_and_grad consumer wrapped in lax.scan.  Must compile
    and run."""
    from qmps_tpu.mps.imps import iMPS

    A0 = iMPS.random(key, 2, 4)[0]

    def loss(A):
        lam, _ = tr.right_fixed_point(A, A, dense=False, iters=96)
        return jnp.abs(lam)

    def step(A, _):
        v, g = jax.value_and_grad(loss)(A)
        return A - 0.01 * g.conj(), v

    A, vals = jax.jit(lambda A: jax.lax.scan(step, A, None, length=3))(A0)
    assert np.all(np.isfinite(np.asarray(vals)))
