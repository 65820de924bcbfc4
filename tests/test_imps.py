"""uMPS layer: canonical forms, fixed points, expectation values, overlaps.

Cross-validation strategy per SURVEY.md section 4: every quantity asserted
against a dense numpy mirror and analytic states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmps_tpu.core.paulis import X, Y, Z
from qmps_tpu.mps.imps import (
    Map,
    TransferMatrix,
    iMPS,
    left_orthogonalise,
    merge,
    random_tensor,
    right_orthogonalise,
)
from qmps_tpu.mps.transfer import (
    dominant_eig_dense,
    left_matvec,
    right_matvec,
    transfer_dense,
)


def np_dominant_eig(E):
    w, v = np.linalg.eig(np.asarray(E))
    i = np.argmax(np.abs(w))
    return w[i], v[:, i]


class TestFixedPoints:
    def test_dense_solver_matches_numpy(self, rng):
        for n in (4, 16, 64):
            E = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
            lam_np, v_np = np_dominant_eig(E)
            lam, v = dominant_eig_dense(jnp.asarray(E))
            np.testing.assert_allclose(complex(lam), lam_np, atol=1e-9)
            # eigenvector up to phase
            v = np.asarray(v)
            overlap = abs(np.vdot(v, v_np)) / (np.linalg.norm(v) * np.linalg.norm(v_np))
            assert overlap > 1 - 1e-9

    def test_transfer_fixed_point_eigen_property(self, key):
        A = random_tensor(key, 2, 4)
        B = random_tensor(jax.random.PRNGKey(7), 2, 4)
        E = Map(A, B)
        lam, r = E.right_fixed_point()
        assert float(E.is_right_eigenvector(r, lam)) < 1e-8
        lam_l, l = E.left_fixed_point()
        # left eigenvalue equals the right one (same spectrum)
        np.testing.assert_allclose(complex(lam_l), complex(lam), atol=1e-8)

    def test_fixed_point_matches_dense_eig(self, key):
        A = random_tensor(key, 2, 4)
        E = transfer_dense(A, A)
        lam_np, v_np = np_dominant_eig(E)
        lam, r = TransferMatrix(A).right_fixed_point()
        np.testing.assert_allclose(complex(lam), lam_np, atol=1e-9)
        rv = np.asarray(r).reshape(-1)
        assert abs(np.vdot(rv, v_np)) / np.linalg.norm(v_np) > 1 - 1e-9

    def test_power_iteration_matches_dense(self, key):
        A = random_tensor(key, 2, 8)
        lam_d, r_d = TransferMatrix(A).right_fixed_point(dense=True)
        lam_p, r_p = TransferMatrix(A).right_fixed_point(dense=False)
        np.testing.assert_allclose(complex(lam_p), complex(lam_d), rtol=1e-8)
        np.testing.assert_allclose(np.asarray(r_p), np.asarray(r_d), atol=1e-7)

    def test_gradients_flow(self, key):
        A = random_tensor(key, 2, 2)

        def f(x):
            lam, r = TransferMatrix(A + x * A).right_fixed_point()
            return jnp.abs(lam)

        g = jax.grad(f)(0.0)
        assert np.isfinite(float(g))
        # finite-difference check
        eps = 1e-6
        fd = (f(eps) - f(-eps)) / (2 * eps)
        np.testing.assert_allclose(float(g), float(fd), rtol=1e-4)


class TestCanonical:
    def test_left_canonical(self, key):
        for D in (2, 4, 8):
            A = random_tensor(key, 2, D)
            AL, _, _ = left_orthogonalise(A)
            gauge = sum(
                np.asarray(AL[s]).conj().T @ np.asarray(AL[s]) for s in range(2)
            )
            np.testing.assert_allclose(gauge, np.eye(D), atol=1e-9)

    def test_right_canonical(self, key):
        A = random_tensor(key, 2, 4)
        AR, _, _ = right_orthogonalise(A)
        gauge = sum(np.asarray(AR[s]) @ np.asarray(AR[s]).conj().T for s in range(2))
        np.testing.assert_allclose(gauge, np.eye(4), atol=1e-9)

    def test_canonicalization_preserves_state(self, key):
        """Physical expectation values are gauge invariant."""
        A = random_tensor(key, 2, 3)
        psi = iMPS([A])
        psiL = psi.left_canonicalise()
        for op in (X, Y, Z):
            np.testing.assert_allclose(
                complex(psi.E(op)), complex(psiL.E(op)), atol=1e-8
            )

    def test_mixed_gauge(self, key):
        A = random_tensor(key, 2, 4)
        AL, AR, C = iMPS([A]).mixed()
        np.testing.assert_allclose(
            sum(np.asarray(AL[s]).conj().T @ np.asarray(AL[s]) for s in range(2)),
            np.eye(4),
            atol=1e-9,
        )
        np.testing.assert_allclose(
            sum(np.asarray(AR[s]) @ np.asarray(AR[s]).conj().T for s in range(2)),
            np.eye(4),
            atol=1e-9,
        )
        # AL C = C AR
        for s in range(2):
            np.testing.assert_allclose(
                np.asarray(AL[s] @ C), np.asarray(C @ AR[s]), atol=1e-8
            )


class TestObservables:
    def test_product_state_expectations(self):
        """D=1-like product state embedded at D=2: |psi> = cos(a)|0>+sin(a)|1>."""
        a = 0.37
        A = jnp.zeros((2, 1, 1), jnp.complex128)
        A = A.at[0, 0, 0].set(jnp.cos(a))
        A = A.at[1, 0, 0].set(jnp.sin(a))
        psi = iMPS([A])
        np.testing.assert_allclose(float(psi.E(Z).real), np.cos(2 * a), atol=1e-8)
        np.testing.assert_allclose(float(psi.E(X).real), np.sin(2 * a), atol=1e-8)

    def test_overlap_self_is_one(self, key):
        A = random_tensor(key, 2, 3)
        psi = iMPS([A])
        np.testing.assert_allclose(float(psi.overlap(psi)), 1.0, atol=1e-8)

    def test_overlap_product_states(self):
        def prod(a):
            A = jnp.zeros((2, 1, 1), jnp.complex128)
            A = A.at[0, 0, 0].set(jnp.cos(a))
            A = A.at[1, 0, 0].set(jnp.sin(a))
            return iMPS([A])

        a, b = 0.3, 1.1
        got = float(prod(a).overlap(prod(b)))
        np.testing.assert_allclose(got, np.cos(a - b) ** 2, atol=1e-8)

    def test_merge_matches_two_site_blocking(self, key):
        A = random_tensor(key, 2, 3)
        B = random_tensor(jax.random.PRNGKey(3), 2, 3)
        M = merge(A, B)
        assert M.shape == (4, 3, 3)
        # M[(s t)] = A[s] B[t]
        for s in range(2):
            for t in range(2):
                np.testing.assert_allclose(
                    np.asarray(M[2 * s + t]),
                    np.asarray(A[s] @ B[t]),
                    atol=1e-12,
                )


class TestMultiSiteCanonical:
    """True n-site unit cell: per-site canonical forms, no silent blocking
    (xmps iMPS n>1 semantics via qmps/ground_state.py:271-335)."""

    def test_left_canonicalise_returns_per_site_tensors(self, key):
        ks = jax.random.split(key, 2)
        psi = iMPS([random_tensor(k, 2, 3) for k in ks])
        can = psi.left_canonicalise()
        assert len(can) == 2
        for A in can.data:
            gram = np.einsum("sji,sjk->ik", np.conj(np.asarray(A)), np.asarray(A))
            np.testing.assert_allclose(gram, np.eye(3), atol=1e-10)

    def test_right_canonicalise_returns_per_site_tensors(self, key):
        ks = jax.random.split(key, 3)
        psi = iMPS([random_tensor(k, 2, 2) for k in ks])
        can = psi.right_canonicalise()
        assert len(can) == 3
        for A in can.data:
            gram = np.einsum("sij,skj->ik", np.asarray(A), np.conj(np.asarray(A)))
            np.testing.assert_allclose(gram, np.eye(2), atol=1e-10)

    def test_per_site_form_is_the_same_state(self, key):
        """Canonicalization is a gauge transformation: the per-site form has
        unit overlap with the original state and identical observables."""
        ks = jax.random.split(key, 2)
        psi = iMPS([random_tensor(k, 2, 3) for k in ks])
        can = psi.left_canonicalise()
        ov = float(iMPS([can.blocked]).overlap(iMPS([psi.blocked])))
        np.testing.assert_allclose(ov, 1.0, atol=1e-8)
        op = np.kron(np.array([[1, 0], [0, -1]]), np.eye(2))  # Z on site 1
        e_orig = complex(iMPS([psi.blocked]).E(op))
        e_can = complex(iMPS([can.blocked]).E(op))
        np.testing.assert_allclose(e_can, e_orig, atol=1e-8)

    def test_per_site_matches_blocked_canonical_physics(self, key):
        ks = jax.random.split(key, 2)
        psi = iMPS([random_tensor(k, 2, 2) for k in ks])
        can = psi.left_canonicalise()
        blocked_can = iMPS([psi.blocked]).left_canonicalise()
        op = np.kron(np.array([[0, 1], [1, 0]]), np.eye(2))
        np.testing.assert_allclose(
            complex(iMPS([can.blocked]).E(op)),
            complex(blocked_can.E(op)),
            atol=1e-8,
        )

    def test_cell_closure(self, key):
        """The QR sweep closes: re-canonicalizing a canonical cell is the
        identity (deterministic gauge via sign-fixed QR)."""
        ks = jax.random.split(key, 2)
        can = iMPS([random_tensor(k, 2, 3) for k in ks]).left_canonicalise()
        again = can.left_canonicalise()
        for A, B in zip(can.data, again.data):
            np.testing.assert_allclose(np.asarray(A), np.asarray(B), atol=1e-8)


@pytest.mark.slow
def test_rank_deficient_f32_stays_finite():
    """Rank-deficient states in float32 (the x64-off mode): the
    canonical forms, mixed gauge, entropy, and truncation must all stay
    finite — a fixed 1e-14 cholesky jitter underflowed below complex64
    resolution and every one of these silently NaN'd."""
    A2 = np.zeros((2, 2, 2), np.complex64)
    A2[0, 0, 0] = 1
    A2[1, 1, 0] = 1
    A4 = np.zeros((2, 4, 4), np.complex64)
    A4[:, :2, :2] = A2  # product state embedded at D=4: Schmidt rank 1
    psi = iMPS([jnp.asarray(A4)])
    assert np.all(np.isfinite(np.asarray(psi.left_canonicalise()[0])))
    AL, AR, C = psi.mixed()
    for x in (AL, AR, C):
        assert np.all(np.isfinite(np.asarray(x)))
    S = float(psi.entanglement_entropy())
    assert np.isfinite(S) and S < 1e-3  # product state: ~the f32 jitter floor
    tr_state, w = psi.truncated(2)
    assert np.all(np.isfinite(np.asarray(tr_state[0])))
    assert float(w) > 0.999
