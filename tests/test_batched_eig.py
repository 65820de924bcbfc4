"""The plain batched dominant eigensolvers that replaced the hand-written
eigensolver kernels: repeated squaring as batched XLA matmuls
(kernels/energy_fused._eig_right_xla) and the vmapped dense solver with its
rank-1 implicit eigenvalue adjoint (mps/transfer.dominant_eigval_dense),
checked against numpy.linalg.eig."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmps_tpu.circuits.brickwork import param_bricks, right_env_matrix
from qmps_tpu.kernels.energy_fused import _eig_right_xla
from qmps_tpu.mps import transfer as tr


def _numpy_dominant(E):
    w, vecs = np.linalg.eig(np.asarray(E, np.complex128))
    i = np.argmax(np.abs(w))
    return w[i], vecs[:, i]


def _check(E, lam, v, atol, ov_tol):
    for b in range(E.shape[0]):
        w, vec = _numpy_dominant(E[b])
        np.testing.assert_allclose(complex(lam[b]), w, atol=atol)
        ov = abs(np.vdot(np.asarray(v[b]), vec))
        assert ov > 1 - ov_tol, (b, ov)


def physical_batch(B, key):
    """Transfer matrices of random brickwork states vs slight deformations
    (the TDVP inner-loop workload)."""
    ks = jax.random.split(key, B)

    def one(k):
        p = jax.random.normal(k, (22,)) * 0.4
        U1, U2 = param_bricks(p)
        p2 = p + 0.05 * jax.random.normal(jax.random.fold_in(k, 1), (22,))
        U1p, U2p = param_bricks(p2)
        return right_env_matrix(U1, U2, U1p.conj().T, U2p.conj().T)

    return jax.vmap(one)(ks)


@pytest.mark.parametrize("N", [4, 16, 32, 64])
def test_squaring_matches_numpy_eig(N):
    """Batched repeated squaring agrees with numpy eig on random complex
    batches at every transfer-matrix size the sweeps use (D = 2..8)."""
    rng = np.random.default_rng(7)
    E = (rng.normal(size=(6, N, N)) + 1j * rng.normal(size=(6, N, N))) / np.sqrt(N)
    lam, v = _eig_right_xla(jnp.asarray(E), 40)
    assert lam.shape == (6,) and v.shape == (6, N)
    _check(E, lam, v, atol=1e-9, ov_tol=1e-9)


def test_squaring_adversarial_near_degenerate():
    """Squaring converges where plain power iteration stalls: a spectrum
    whose two leading eigenvalues differ by 1.1% in modulus."""
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(8, 4, 4)) + 1j * rng.normal(size=(8, 4, 4)))
    lam_true = np.array([1.0, 0.989, 0.5, 0.1 + 0.2j])
    E = np.einsum("bij,j,bkj->bik", Q, lam_true, Q.conj())  # normal matrices
    lam, v = _eig_right_xla(jnp.asarray(E), 40)
    _check(E, lam, v, atol=1e-9, ov_tol=1e-9)


def test_squaring_physical_batch_float32(key):
    """The accelerator dtype: complex64 transfer matrices of physical
    brickwork states, eigenvalue to the float32 floor."""
    E = np.asarray(physical_batch(5, key)).astype(np.complex64)
    lam, v = _eig_right_xla(jnp.asarray(E), 40)
    assert lam.dtype == jnp.complex64
    _check(E, lam, v, atol=2e-5, ov_tol=1e-4)


def test_dense_eigval_vmap_matches_numpy(key):
    """vmap of the dense solver (the quench engine's inner eigensolve)."""
    E = np.asarray(physical_batch(4, key))
    lam = jax.vmap(tr.dominant_eigval_dense)(jnp.asarray(E))
    for b in range(4):
        w, _ = _numpy_dominant(E[b])
        np.testing.assert_allclose(complex(lam[b]), w, atol=1e-10)


def test_dense_eigval_gradient_rank1(key):
    """The implicit eigenvalue adjoint under vmap equals the rank-1 formula
    dlam/dE = conj(w) v^T / (w^dag v) built from numpy eigenvectors (in
    the package's pairing convention, d Re lam = Re sum(grad * dE))."""
    E = np.asarray(physical_batch(3, key))
    g = jax.grad(
        lambda e: jnp.sum(jax.vmap(tr.dominant_eigval_dense)(e)).real
    )(jnp.asarray(E))
    for b in range(3):
        _, v = _numpy_dominant(E[b])
        _, w = _numpy_dominant(E[b].conj().T)
        want = np.outer(w.conj(), v) / np.vdot(w, v)
        np.testing.assert_allclose(np.asarray(g[b]), want, atol=1e-8)


def test_tdvp_objective_vmap_D4(key):
    """The batched TDVP objective at D=4 (vmapped dense path) equals -|x|
    of numpy's dominant eigenvalue of the explicit mixed transfer matrix."""
    import scipy.linalg as sla

    from qmps_tpu.ham import tfim
    from qmps_tpu.mps.imps import iMPS
    from qmps_tpu.objectives.overlap import (
        mixed_transfer_with_gate,
        tdvp_objective,
    )

    ks = jax.random.split(key, 4)
    As = jnp.stack([iMPS.random(ks[i], 2, 4).left_canonicalise()[0] for i in range(2)])
    Bs = jnp.stack(
        [iMPS([As[i] + 0.03 * jax.random.normal(ks[2 + i], As[i].shape)]).left_canonicalise()[0]
         for i in range(2)]
    )
    W = np.asarray(sla.expm(-1j * 0.1 * np.asarray(tfim(1.0).to_matrix())))
    vals = jax.vmap(lambda a, b: tdvp_objective(a, b, W))(As, Bs)
    for i in range(2):
        E = tr.transfer_dense(*mixed_transfer_with_gate(As[i], Bs[i], jnp.asarray(W)))
        w, _ = _numpy_dominant(E)
        np.testing.assert_allclose(float(vals[i]), -abs(w), atol=1e-10)
