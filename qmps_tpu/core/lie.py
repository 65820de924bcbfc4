"""Lie-algebra parametrizations of unitaries.

JAX replacement for the reference's xmps.spin.{SU, U4, lambdas} and
new_tdvp/unitary_param.py: every parametrization here is a pure, jittable,
differentiable map  params -> unitary, so derivative-free optimization can be
replaced by exact gradients (SURVEY.md section 7, stage B0).

- ``su_generators(N)``: generalized Gell-Mann basis of su(N) (N^2-1 hermitian,
  traceless matrices) — analogue of xmps.spin.lambdas().
- ``SU(v, N) = expm(-i sum_k v_k G_k)`` — analogue of xmps.spin.SU
  (reference usage: qmps/ground_state.py:251-266).
- ``U4(v)``: 15-param SU(4) (xmps.spin.U4 analogue).
- ``first_column_unitary(p)``: 7-param 2-qubit unitary whose action on |00> is
  fully general — analogue of new_tdvp OO_unitary
  (ClassicalTDVPStripped.py:39-48).
- ``U2f`` / ``U4_kak`` / ``U4_state``: the closed-form parametrizations of
  new_tdvp/unitary_param.py:77-120.
- ``embed_su_params`` / ``extract_su_params``: bond-dimension warm-start
  embedding, the xmps insu2N/extractv analogue (scripts/bond_dimension.py:24-35).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CDTYPE
from .gates import ry, rz


@lru_cache(maxsize=None)
def su_generators(N: int) -> np.ndarray:
    """Generalized Gell-Mann basis of su(N), stacked (N^2-1, N, N).

    Ordering: for each pair j<k (row-major) the symmetric then antisymmetric
    generator, followed by the N-1 diagonal generators.

    Cached as a host numpy array: caching a jnp array created inside a jit
    trace would leak a tracer out of the transform.
    """
    gens = []
    for j in range(N):
        for k in range(j + 1, N):
            s = np.zeros((N, N), dtype=np.complex128)
            s[j, k] = s[k, j] = 1.0
            gens.append(s)
            a = np.zeros((N, N), dtype=np.complex128)
            a[j, k] = -1j
            a[k, j] = 1j
            gens.append(a)
    for l in range(1, N):
        d = np.zeros((N, N), dtype=np.complex128)
        d[:l, :l] = np.eye(l)
        d[l, l] = -l
        gens.append(np.sqrt(2.0 / (l * (l + 1))) * d)
    return np.stack(gens)


def SU(v, N: int) -> jnp.ndarray:
    """expm(-i v . G) over the su(N) basis; v has N^2-1 real entries."""
    G = su_generators(N)
    H = jnp.tensordot(jnp.asarray(v, CDTYPE), G, axes=[[0], [0]])
    return jax.scipy.linalg.expm(-1j * H)


def U4(v) -> jnp.ndarray:
    """15-parameter SU(4) (xmps.spin.U4 analogue)."""
    return SU(v, 4)


@lru_cache(maxsize=None)
def _first_column_generators() -> np.ndarray:
    """7 su(4) generators whose exponential sweeps out all states e^{iH}|00>.

    The reference keeps the xmps lambdas with support in the first column
    (ClassicalTDVPStripped.py:30-36); we use the pair generators touching
    index 0 plus one diagonal generator with weight on index 0.
    """
    gens = []
    for k in range(1, 4):
        s = np.zeros((4, 4), dtype=np.complex128)
        s[0, k] = s[k, 0] = 1.0
        gens.append(s)
        a = np.zeros((4, 4), dtype=np.complex128)
        a[0, k] = -1j
        a[k, 0] = 1j
        gens.append(a)
    d = np.diag([3.0, -1.0, -1.0, -1.0]) / np.sqrt(6.0)
    gens.append(d.astype(np.complex128))
    return np.stack(gens)


def first_column_unitary(p) -> jnp.ndarray:
    """7-param 2-qubit unitary; U|00> covers all normalized 2-qubit states."""
    G = _first_column_generators()
    H = jnp.tensordot(jnp.asarray(p, CDTYPE), G, axes=[[0], [0]])
    return jax.scipy.linalg.expm(-1j * H)


# -- closed-form parametrizations (new_tdvp/unitary_param.py) ----------------


def U2f(a, b, c, d) -> jnp.ndarray:
    """General U(2) with explicit phases (unitary_param.py:77-86)."""
    a, b, c, d = (jnp.asarray(x, CDTYPE) for x in (a, b, c, d))
    c1 = jnp.exp(1j * (a - b / 2 - d / 2))
    c2 = jnp.exp(1j * (a - b / 2 + d / 2))
    c3 = jnp.exp(1j * (a + b / 2 - d / 2))
    c4 = jnp.exp(1j * (a + b / 2 + d / 2))
    return jnp.array(
        [
            [c1 * jnp.cos(c / 2), -c2 * jnp.sin(c / 2)],
            [c3 * jnp.sin(c / 2), c4 * jnp.cos(c / 2)],
        ]
    )


def U4_kak(p) -> jnp.ndarray:
    """19-param U(4), KAK-style: 4 local U(2)s + 3 CNOTs + 3 mid rotations
    (unitary_param.py:110-120)."""
    from .gates import CNOT, I2

    # CNOT with control on qubit 1 (low bit): SWAP.CNOT.SWAP
    from .gates import SWAP

    c0 = CNOT
    c1 = SWAP @ CNOT @ SWAP
    u1 = U2f(p[0], p[1], p[2], p[3])
    u2 = U2f(p[4], p[5], p[6], p[7])
    u3 = U2f(p[8], p[9], p[10], p[11])
    u4 = U2f(p[12], p[13], p[14], p[15])
    return (
        (jnp.kron(u3, u4) @ c0)
        @ jnp.kron(ry(p[16]), I2)
        @ (c1 @ jnp.kron(ry(p[17]), rz(p[18])))
        @ (c0 @ jnp.kron(u1, u2))
    )


def U4_state(p) -> jnp.ndarray:
    """Normalized 2-qubit state from 9 params (unitary_param.py:89-108; the
    reference docstring says 7 but its own code consumes 9 — we accept >=7 and
    zero-pad)."""
    p = jnp.concatenate([jnp.asarray(p, CDTYPE).reshape(-1), jnp.zeros(9, CDTYPE)])[:9]
    U = U2f(p[0], p[1], p[2], p[3])
    V = U2f(p[4], p[5], p[6], p[7])
    th = p[8]
    Smat = jnp.array([[1.0, 0.0], [0.0, 1j]], dtype=CDTYPE) * jnp.array(
        [[jnp.cos(th), 0.0], [0.0, jnp.sin(th)]], dtype=CDTYPE
    )
    return (U @ Smat @ V).reshape(4)


# -- warm-start embedding (host-side utility) --------------------------------


def extract_su_params(U: np.ndarray) -> np.ndarray:
    """Project i*log(U) onto the su(N) generator basis (xmps extractv analogue).

    Host-side numpy (uses a dense eigendecomposition of a unitary); not for
    the jit hot path.
    """
    U = np.asarray(U)
    N = U.shape[0]
    w, V = np.linalg.eig(U)
    # strip global phase so log lands in su(N)
    phase = np.angle(np.linalg.det(U)) / N
    w = w * np.exp(-1j * phase)
    H = -(V @ np.diag(np.log(w)) @ np.linalg.inv(V)) / 1j  # U = expm(-iH)
    H = (H + H.conj().T) / 2
    G = np.asarray(su_generators(N))
    # generators satisfy tr(G_a G_b) = 2 delta_ab
    return np.real(np.einsum("aij,ji->a", G, H)) / 2.0


def embed_su_params(v: np.ndarray, eps: float = 4e-2) -> np.ndarray:
    """su(N) params -> su(2N) params for the D -> 2D warm start
    (scripts/bond_dimension.py:24-35 `fixindices(insu2N(.))` analogue).

    The new bond qubit is inserted as an identity factor next to the physical
    leg so that tracing it out recovers the D-dim unitary; a small eps
    perturbation moves off singular points exactly as the reference does.
    """
    v = np.asarray(v)
    N = int(np.sqrt(len(v) + 1))
    U = np.asarray(SU(jnp.asarray(v), N))
    # kron(U, I2) keeps the fresh qubit least significant on both row and
    # column indices — already the tensor-product structure the reference's
    # fixindices arranges with its explicit swap, so no permutation is
    # needed here.  The uniform eps shift off singular points matches the
    # reference (it adds eps to the parameter vector: `SU(v + eps, N)`).
    U2N = np.kron(U, np.eye(2))
    return extract_su_params(U2N) + eps


@lru_cache(maxsize=None)
def _grow_su_map(N: int) -> np.ndarray:
    """(4N^2-1, N^2-1) matrix M with  coeffs(kron(H, I2)) = M @ coeffs(H).

    Because kron(A, I)^k = kron(A^k, I), U = expm(-iH) gives
    kron(U, I2) = expm(-i kron(H, I2)) EXACTLY — so the D -> 2D parameter
    embedding of `embed_su_params` is a fixed LINEAR map on su(N)
    coefficients, with no eigendecomposition, no matrix log, and no
    branch-cut failure when U has eigenvalues near -1.  Host numpy,
    cached per N.
    """
    G = su_generators(N)  # (N^2-1, N, N)
    G2 = su_generators(2 * N)  # (4N^2-1, 2N, 2N)
    K = np.einsum("aij,kl->aikjl", G, np.eye(2)).reshape(
        N * N - 1, 2 * N, 2 * N
    )  # kron(G_a, I2)
    # tr(G2_b G2_c) = 2 delta_bc, so coeff_b = tr(G2_b K_a)/2 per unit v_a
    return np.real(np.einsum("bij,aji->ba", G2, K)) / 2.0


def grow_su_params(vs: np.ndarray, eps: float = 4e-2) -> np.ndarray:
    """Batched, exact D -> 2D warm-start embedding: (..., N^2-1) su(N)
    parameter vectors -> (..., 4N^2-1) su(2N) vectors, via the linear map
    `_grow_su_map` (same semantics as `embed_su_params`, branch-cut-free
    and vectorized for sweep-scale bond-growth continuation).  The uniform
    eps shift off singular points matches the reference
    (scripts/bond_dimension.py:24-35)."""
    vs = np.asarray(vs)
    N = int(np.sqrt(vs.shape[-1] + 1))
    return vs @ _grow_su_map(N).T + eps
