"""Differentiable linear-algebra utilities.

JAX replacements for the reference's scipy.linalg.null_space-based
constructions (qmps/tools.py:76-120), which are neither differentiable nor
batchable.  Completion here is QR-based with a fixed deterministic filler
(SURVEY.md section 7 "hard parts" item 4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CDTYPE


def cT(t: jnp.ndarray) -> jnp.ndarray:
    """Hermitian conjugate of the last two indices (reference qmps/tools.py:61)."""
    return jnp.swapaxes(t.conj(), -1, -2)


def direct_sum(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Block-diagonal direct sum (reference qmps/tools.py:69)."""
    (a1, a2), (b1, b2) = A.shape, B.shape
    out = jnp.zeros((a1 + b1, a2 + b2), dtype=jnp.result_type(A, B))
    out = out.at[:a1, :a2].set(A)
    out = out.at[a1:, a2:].set(B)
    return out


def from_real_vector(v: jnp.ndarray) -> jnp.ndarray:
    """(re..., im...) -> complex vector (reference qmps/tools.py:43)."""
    re, im = jnp.split(v, 2)
    return re + 1j * im


def to_real_vector(A: jnp.ndarray) -> jnp.ndarray:
    """complex array -> (re..., im...) real vector (reference qmps/tools.py:49)."""
    return jnp.concatenate([jnp.real(A).reshape(-1), jnp.imag(A).reshape(-1)])


def _filler(m: int, k: int) -> np.ndarray:
    """Fixed, seed-deterministic (m, m-k) complex filler for QR completion."""
    rng = np.random.default_rng(20240517 + 1000 * m + k)
    F = rng.standard_normal((m, m - k)) + 1j * rng.standard_normal((m, m - k))
    return F


def unitary_completion(iso: jnp.ndarray) -> jnp.ndarray:
    """Complete an (m, k) isometry (orthonormal columns) to an (m, m) unitary
    whose first k columns are exactly ``iso``.

    Differentiable replacement for null_space completion
    (qmps/tools.py:76-94).  QR of [iso | F] with a fixed filler F: since the
    first k columns are orthonormal already, Q[:, :k] = iso up to a diagonal
    phase which we divide out.
    """
    m, k = iso.shape
    if m == k:
        return iso
    F = jnp.asarray(_filler(m, k), dtype=iso.dtype)
    # project the filler off the isometry's column space to keep QR
    # well-conditioned, then orthonormalize everything jointly
    F = F - iso @ (cT(iso) @ F)
    B = jnp.concatenate([iso, F], axis=1)
    Q, R = jnp.linalg.qr(B)
    d = jnp.diagonal(R)
    phase = d / jnp.abs(d)
    return Q * phase[None, :]


def row_completion(rows: jnp.ndarray) -> jnp.ndarray:
    """Complete a (k, m) matrix with orthonormal rows to an (m, m) unitary
    whose first k rows are exactly ``rows``."""
    return cT(unitary_completion(cT(rows)))


def polar(A: jnp.ndarray):
    """Polar decomposition A = U P via SVD (differentiable)."""
    u, s, vh = jnp.linalg.svd(A, full_matrices=False)
    U = u @ vh
    P = cT(vh) @ (s[:, None] * vh)
    return U, P


def rotate_to_hermitian(r: jnp.ndarray) -> jnp.ndarray:
    """Remove the global phase from a matrix that is hermitian up to a phase
    (xmps.tensor.rotate_to_hermitian analogue).

    If r = e^{i phi} h with h hermitian, then tr(r @ r) = e^{2 i phi} |h|_F^2,
    so phi is recovered up to pi; the sign is fixed so that tr(h) >= 0.
    """
    t = jnp.trace(r @ r)
    phase = jnp.exp(-0.5j * jnp.angle(t))
    h = r * phase
    sign = jnp.where(jnp.real(jnp.trace(h)) < 0, -1.0, 1.0)
    return h * sign


def eye_like(A: jnp.ndarray) -> jnp.ndarray:
    return jnp.eye(A.shape[-1], dtype=A.dtype)


def frob_norm(A: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(jnp.abs(A) ** 2))


def random_unitary(key, n: int, dtype=CDTYPE) -> jnp.ndarray:
    """Haar-ish random unitary via QR of a complex gaussian."""
    import jax

    kr, ki = jax.random.split(key)
    A = jax.random.normal(kr, (n, n)) + 1j * jax.random.normal(ki, (n, n))
    Q, R = jnp.linalg.qr(A.astype(dtype))
    d = jnp.diagonal(R)
    return Q * (d / jnp.abs(d))[None, :]


def nsphere(v: jnp.ndarray) -> jnp.ndarray:
    """Unit vector on S^n from n hyperspherical angles (the reference's
    Nsphere, qmps/time_evolve_tools.py:25-36), as one jittable cumprod:
    x_k = cos(v_k) prod_{j<k} sin(v_j) for k < n, x_n = prod_j sin(v_j).
    Always unit-norm, so it parametrizes normalized environment vectors
    without a constraint term."""
    v = jnp.asarray(v)
    sines = jnp.cumprod(jnp.sin(v))
    prefix = jnp.concatenate([jnp.ones((1,), v.dtype), sines[:-1]])
    return jnp.concatenate([prefix * jnp.cos(v), sines[-1:]])


def split_ns(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Chunk a flat parameter vector into consecutive groups of n
    (qmps/tools.py:161-174 split_2s/3s/ns as one shape op): (k*n,) -> (k, n)."""
    x = jnp.asarray(x)
    if x.shape[0] % n:
        raise ValueError(f"length {x.shape[0]} is not a multiple of {n}")
    return x.reshape(-1, n)


def spectral_radius_dense(E: jnp.ndarray, n_squarings: int = 30) -> jnp.ndarray:
    """rho(E) = max |eigenvalue| by Gelfand's formula through the repeated
    -squaring normalization factors: with M_0 = E/||E|| and
    M_{k+1} = M_k^2 / s_k, s_k = ||M_k^2||_F, one has
    log rho = log||E|| + sum_k log(s_k) / 2^(k+1) as k -> inf.

    Unlike ``dominant_eig_dense`` (Rayleigh quotient at a converged
    vector), this is correct when the dominant eigenvalue is a COMPLEX
    CONJUGATE PAIR — the generic situation for the subdominant transfer
    eigenvalue of a uMPS with oscillatory correlations, where squaring
    has no single eigenvector to converge to but the norm growth rate is
    still rho."""

    def step(carry, k):
        M, acc = carry
        M2 = M @ M
        s = jnp.linalg.norm(M2)
        return (M2 / jnp.maximum(s, jnp.finfo(M2.real.dtype).tiny), acc + jnp.log(s) / (2.0 ** (k + 1))), None

    nrm = jnp.linalg.norm(E)
    M0 = E / jnp.maximum(nrm, jnp.finfo(E.real.dtype).tiny)
    (_, acc), _ = jax.lax.scan(
        step, (M0, jnp.zeros((), E.real.dtype)), jnp.arange(n_squarings)
    )
    return nrm * jnp.exp(acc)


def dominant_eig_dense(E: jnp.ndarray, n_squarings: int = 40):
    """Dominant eigenpair of a dense matrix by repeated squaring.

    Returns (lam, v) with v unit-norm (arbitrary phase).  Error after k
    squarings ~ |lam_2/lam_1|^(2^k): converged to machine precision for any
    nontrivial gap.  Differentiable (matmul chain).
    """
    n = E.shape[0]

    def step(M, _):
        M2 = M @ M
        M2 = M2 / jnp.linalg.norm(M2)
        return M2, None

    M0 = E / jnp.linalg.norm(E)
    M, _ = jax.lax.scan(step, M0, None, length=n_squarings)
    # a generic start vector; vec(I) has weight on the dominant eigenvector
    # for transfer operators (overlap with the fixed point is the state norm)
    v0 = jnp.eye(int(n**0.5 + 0.5), dtype=E.dtype).reshape(-1) if int(n**0.5 + 0.5) ** 2 == n else jnp.ones((n,), E.dtype)
    v = M @ v0
    # fall back to a fixed pseudo-random vector if v0 was (near-)orthogonal
    # to the dominant eigenspace
    alt = M @ _chirp(n, E.dtype)
    use_alt = jnp.linalg.norm(v) < 1e-8 * jnp.linalg.norm(alt)
    v = jnp.where(use_alt, alt, v)
    v = v / jnp.linalg.norm(v)
    lam = jnp.vdot(v, E @ v)
    return lam, v


def _chirp(n: int, dtype) -> jnp.ndarray:
    k = jnp.arange(n)
    return (jnp.cos(0.7 * k + 0.3) + 1j * jnp.sin(1.3 * k + 1.1)).astype(dtype)
