"""Riemannian (Stiefel) ground-state optimizer."""
import jax
import jax.numpy as jnp
import numpy as np

from qmps_tpu.ham import tfim, tfim_gs_energy
from qmps_tpu.optim.riemann import ground_state_riemannian, stiefel_minimize


def test_stiefel_minimize_stays_on_manifold(key):
    D = 3
    X = jax.random.normal(key, (6, D)) + 1j * jax.random.normal(
        jax.random.fold_in(key, 1), (6, D)
    )
    V0, _ = jnp.linalg.qr(X)
    target = jnp.eye(6, dtype=V0.dtype)[:, :D]

    def loss(V):
        return jnp.sum(jnp.abs(V - target) ** 2)

    V, hist = stiefel_minimize(loss, V0, steps=200, lr=0.2)
    np.testing.assert_allclose(
        np.asarray(V.conj().T @ V), np.eye(D), atol=1e-9
    )
    assert float(hist[-1]) < float(hist[0])


def test_riemannian_ground_state_d2():
    h = tfim(1.0).to_matrix()
    A, e, hist = ground_state_riemannian(h, 2, steps=300, lr=0.08)
    e_exact = float(tfim_gs_energy(1.0))
    # matches the D=2 variational optimum (the chart optimizers land at the
    # same energy)
    assert e - e_exact < 1e-3
    # left-canonical by construction
    g = sum(np.asarray(A[s]).conj().T @ np.asarray(A[s]) for s in range(2))
    np.testing.assert_allclose(g, np.eye(2), atol=1e-10)


def test_reported_energy_is_returned_states_energy():
    """The reported energy must be achieved by the RETURNED tensor — not a
    best-of-history value no returned state realizes (round-2 verdict:
    the hist[-1] off-by-one class, finished here)."""
    from qmps_tpu.mps.imps import iMPS

    h = tfim(1.0).to_matrix()
    A, e, hist = ground_state_riemannian(h, 2, steps=60, lr=0.08)
    # hist carries steps+1 entries; the last is the returned state's energy
    assert len(np.asarray(hist)) == 61
    assert float(hist[-1]) == e
    e_of_A = float(iMPS([A]).energy(h))
    tol = 200 * np.finfo(np.asarray(hist).dtype).eps
    assert abs(e_of_A - e) < tol


def test_warm_eigpair_matches_dense(key):
    """right_eigpair_warm (cold-started, enough iters) reproduces the dense
    eigensolver's fixed point and eigenvalue (f64)."""
    from qmps_tpu.mps.imps import iMPS
    from qmps_tpu.mps.transfer import right_eigpair_warm, right_fixed_point

    A = iMPS.random(key, 2, 5)[0]
    lam_d, r_d = right_fixed_point(A, A, dense=True)
    r0 = jnp.eye(5, dtype=A.dtype)
    lam_w, r_w = right_eigpair_warm(A, A, r0, 200)
    np.testing.assert_allclose(complex(lam_w), complex(lam_d), atol=1e-10)
    # gauge-free comparison: projectors agree
    rw = np.asarray(r_w).reshape(-1)
    rd = np.asarray(r_d).reshape(-1)
    np.testing.assert_allclose(
        np.outer(rw, rw.conj()), np.outer(rd, rd.conj()) / np.vdot(rd, rd),
        atol=1e-9,
    )


def test_warm_energy_gradient_matches_cold(key):
    """The implicit c-gauge adjoint of the recycled fixed point gives the
    same energy gradient as the cold dense path (both compute the same
    gauge-invariant functional; f64)."""
    from qmps_tpu.optim.riemann import isometry_energy, isometry_energy_warm

    D = 4
    h = tfim(1.2).to_matrix()
    X = jax.random.normal(key, (2 * D, D)) + 1j * jax.random.normal(
        jax.random.fold_in(key, 7), (2 * D, D)
    )
    V, _ = jnp.linalg.qr(X)
    r0 = jnp.eye(D, dtype=V.dtype) / np.sqrt(D)

    e_cold, g_cold = jax.value_and_grad(
        lambda V: isometry_energy(V, h, D, True), holomorphic=False
    )(V)
    (e_warm, _), g_warm = jax.value_and_grad(
        lambda V: isometry_energy_warm(V, h, D, jax.lax.stop_gradient(r0), 300),
        has_aux=True,
        holomorphic=False,
    )(V)
    np.testing.assert_allclose(float(e_warm), float(e_cold), atol=1e-10)
    np.testing.assert_allclose(np.asarray(g_warm), np.asarray(g_cold), atol=1e-7)


def test_unroll_gradient_matches_implicit(key):
    """bwd="unroll" (plain AD through the warm power iterations — the
    vmapped-sweep fast path; the batched LU implicit adjoint is
    pivot-sequential under vmap) agrees with the implicit c-gauge adjoint
    at enough iterations: it is the exact gradient of the iters-refined
    energy, which converges to the implicit gradient as the power
    residual vanishes (f64)."""
    from qmps_tpu.optim.riemann import isometry_energy_warm

    D = 4
    h = tfim(1.2).to_matrix()
    X = jax.random.normal(key, (2 * D, D)) + 1j * jax.random.normal(
        jax.random.fold_in(key, 7), (2 * D, D)
    )
    V, _ = jnp.linalg.qr(X)
    r0 = jnp.eye(D, dtype=V.dtype) / np.sqrt(D)

    def vg(bwd):
        return jax.value_and_grad(
            lambda V: isometry_energy_warm(
                V, h, D, jax.lax.stop_gradient(r0), 300, bwd=bwd
            ),
            has_aux=True,
            holomorphic=False,
        )(V)

    (e_imp, _), g_imp = vg("auto")
    (e_unr, _), g_unr = vg("unroll")
    np.testing.assert_allclose(float(e_unr), float(e_imp), atol=1e-12)
    np.testing.assert_allclose(np.asarray(g_unr), np.asarray(g_imp), atol=1e-7)


def test_warm_start_vector_gets_zero_cotangent(key):
    from qmps_tpu.mps.imps import iMPS
    from qmps_tpu.mps.transfer import right_eigpair_warm

    A = iMPS.random(key, 2, 3)[0]
    r0 = jnp.eye(3, dtype=A.dtype)

    def f(r0):
        lam, _ = right_eigpair_warm(A, A, r0, 100)
        return jnp.abs(lam)

    g = jax.grad(f, holomorphic=False)(r0)
    np.testing.assert_allclose(np.asarray(g), 0.0, atol=0.0)


def test_recycled_matches_cold_optimizer():
    """recycle=True converges to the same ground-state energy as the cold
    per-step solver at D=4 (and both beat the exact integral gap bound)."""
    h = tfim(1.0).to_matrix()
    e_exact = float(tfim_gs_energy(1.0))
    A_r, e_r, _ = ground_state_riemannian(h, 4, steps=250, lr=0.08, recycle=True)
    A_c, e_c, _ = ground_state_riemannian(h, 4, steps=250, lr=0.08, recycle=False)
    assert 0 <= e_r - e_exact < 1e-3
    assert abs(e_r - e_c) < 2e-4
    # returned tensor is still left-canonical
    g = sum(np.asarray(A_r[s]).conj().T @ np.asarray(A_r[s]) for s in range(2))
    np.testing.assert_allclose(g, np.eye(4), atol=1e-10)
