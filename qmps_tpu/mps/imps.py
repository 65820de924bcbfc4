"""Uniform (infinite, translation-invariant) MPS.

This module is the JAX-native replacement for the external xmps library the
reference leans on everywhere (SURVEY.md L0): iMPS, TransferMatrix and Map
with the same capabilities — random states, canonical forms, mixed gauge,
expectation values, overlaps and fixed points — but built from jit-safe,
differentiable primitives (QR/Cholesky/power-iteration, no scipy.eig).

Conventions: an MPS tensor A has shape (d, D, D) = (physical, left, right),
A[s] is a D x D matrix.  Left-canonical means sum_s A[s]^dag A[s] = I.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from ..config import CDTYPE
from ..core.linalg import cT
from . import transfer as tr


def merge(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Block two site tensors into one (d^2, D, D) tensor
    (reference qmps/time_evolve_tools.py:20-23)."""
    d1, d2 = A.shape[0], B.shape[0]
    return (
        jnp.tensordot(A, B, [[2], [1]])  # (d1, D, d2, D)
        .transpose([0, 2, 1, 3])
        .reshape(d1 * d2, A.shape[1], B.shape[2])
    )


def random_tensor(key, d: int = 2, D: int = 2, dtype=CDTYPE) -> jnp.ndarray:
    k1, k2 = jax.random.split(key)
    A = jax.random.normal(k1, (d, D, D)) + 1j * jax.random.normal(k2, (d, D, D))
    return A.astype(dtype)


def _cholesky_psd(M: jnp.ndarray) -> jnp.ndarray:
    """Cholesky of a hermitian PSD matrix with a tiny jitter for safety.

    The jitter must scale with the DTYPE's epsilon: a fixed 1e-14 is far
    below complex64 resolution, so in 32-bit (x64-off) mode rank-deficient
    fixed points — product states, D -> 2D warm-start embeddings — have
    f32 roundoff eigenvalues ~ -1e-8 that 1e-14 cannot lift, and
    jnp.linalg.cholesky silently returns NaN."""
    M = (M + cT(M)) / 2
    eps = 32 * jnp.finfo(M.real.dtype).eps * jnp.trace(M).real
    return jnp.linalg.cholesky(M + eps * jnp.eye(M.shape[-1], dtype=M.dtype))


def _qr_pos(mat: jnp.ndarray):
    """QR with the R diagonal rotated positive-real — a deterministic gauge
    (the complex QR phase ambiguity otherwise makes canonical forms
    seed-dependent)."""
    Q, R = jnp.linalg.qr(mat)
    dg = jnp.diagonal(R)
    ph = dg / jnp.where(jnp.abs(dg) > jnp.finfo(dg.real.dtype).tiny, jnp.abs(dg), 1.0)
    return Q * ph[None, :], R * ph.conj()[:, None]



def _pinv_tri(M: jnp.ndarray, rcond: float | None = None) -> jnp.ndarray:
    """SVD pseudo-inverse with relative cutoff for gauge matrices: plain
    inv() of a rank-deficient center/boundary matrix (product states,
    D -> 2D warm-start embeddings, post-truncation states) returns
    inf/NaN; the cutoff drops the null directions instead (the same guard
    tdvp._pinv documents as standard).

    The default cutoff is dtype-aware, eps**0.75: ~7e-6 in float32 (the
    regime the original fixed 1e-6 was tuned for) but ~1e-12 in float64,
    so high-precision canonicalization keeps genuine small gauge/Schmidt
    directions instead of silently truncating everything below 1e-6."""
    u, s, vh = jnp.linalg.svd(M)
    if rcond is None:
        rcond = float(jnp.finfo(M.real.dtype).eps) ** 0.75
    cut = rcond * s[0]
    sinv = jnp.where(s > cut, 1.0 / jnp.maximum(s, cut), 0.0)
    return cT(vh) @ (sinv[:, None] * cT(u))


def left_orthogonalise(A: jnp.ndarray, dense: bool = True):
    """Gauge A to left-canonical form.

    Returns (AL, L_upper, eta): sum AL^dag AL = I, where l = L^dag L is the
    dominant left fixed point of the transfer operator and eta its
    eigenvalue (the state's norm-per-site before rescaling).
    """
    eta, l = tr.left_fixed_point(A, A, dense=dense)
    # l is hermitian PSD up to numerical phase; scale to unit trace-free form
    l = (l + cT(l)) / 2
    l = l / jnp.trace(l)
    C = _cholesky_psd(l)  # l = C C^dag, lower triangular C
    M = cT(C)  # upper; l = M^dag M
    Minv = _pinv_tri(M)
    AL = jnp.einsum("ij,sjk,kl->sil", M, A, Minv) / jnp.sqrt(eta.real)
    return AL, M, eta


def right_orthogonalise(A: jnp.ndarray, dense: bool = True):
    """Gauge A to right-canonical form: sum AR AR^dag = I."""
    eta, r = tr.right_fixed_point(A, A, dense=dense)
    r = (r + cT(r)) / 2
    r = r / jnp.trace(r)
    C = _cholesky_psd(r)  # r = C C^dag
    Cinv = _pinv_tri(C)
    AR = jnp.einsum("ij,sjk,kl->sil", Cinv, A, C) / jnp.sqrt(eta.real)
    return AR, C, eta


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class iMPS:
    """Uniform MPS with a (usually 1-site) unit cell, xmps-compatible API."""

    data: tuple

    def __init__(self, data: Sequence[jnp.ndarray] | None = None):
        self.data = tuple(jnp.asarray(a) for a in data) if data is not None else ()

    # pytree protocol -------------------------------------------------------
    def tree_flatten(self):
        return (self.data, None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.data = tuple(children)
        return obj

    def __getitem__(self, i):
        return self.data[i]

    def __len__(self):
        return len(self.data)

    # constructors ----------------------------------------------------------
    @classmethod
    def random(cls, key, d: int = 2, D: int = 2, n: int = 1, dtype=CDTYPE):
        keys = jax.random.split(key, n)
        return cls([random_tensor(k, d, D, dtype) for k in keys])

    # properties -------------------------------------------------------------
    @property
    def blocked(self) -> jnp.ndarray:
        """The unit cell merged into a single site tensor."""
        A = self.data[0]
        for B in self.data[1:]:
            A = merge(A, B)
        return A

    @property
    def d(self):
        return self.data[0].shape[0]

    @property
    def D(self):
        return self.data[0].shape[1]

    # canonical forms --------------------------------------------------------
    def left_canonicalise(self) -> "iMPS":
        """Per-site left-canonical form: an n-site cell returns n tensors,
        each satisfying sum_s A_i[s]^dag A_i[s] = I (xmps iMPS n>1
        semantics, consumed by qmps/ground_state.py:271-335 and
        scars.py:75-111).  One boundary fixed-point solve + a QR sweep
        through the cell; jit-safe and differentiable.  Use ``.blocked``
        explicitly when the merged tensor is wanted."""
        if len(self.data) == 1:
            AL, _, _ = left_orthogonalise(self.data[0])
            return iMPS([AL])
        A0 = self.blocked
        _, l = tr.left_fixed_point(A0, A0)
        l = (l + cT(l)) / 2
        l = l / jnp.trace(l)
        M = cT(_cholesky_psd(l))  # l = M^dag M, the cell-boundary gauge
        ALs = []
        for A in self.data:
            B = jnp.einsum("ij,sjk->sik", M, A)
            d, Dl, Dr = B.shape
            Q, R = _qr_pos(B.reshape(d * Dl, Dr))
            ALs.append(Q.reshape(d, Dl, Dr))
            M = R
        # each AL is isometric by construction, so the cell transfer operator
        # of (AL_1..AL_n) has spectral radius exactly 1: normalization and
        # closure (R_n = sqrt(eta_cell) M_0 for the sign-fixed QR) are
        # automatic because l is the cell fixed point.
        return iMPS(ALs)

    def right_canonicalise(self) -> "iMPS":
        """Per-site right-canonical form: sum_s A_i[s] A_i[s]^dag = I per
        site (mirror of left_canonicalise: boundary fixed point + an RQ
        sweep right-to-left)."""
        if len(self.data) == 1:
            AR, _, _ = right_orthogonalise(self.data[0])
            return iMPS([AR])
        A0 = self.blocked
        _, r = tr.right_fixed_point(A0, A0)
        r = (r + cT(r)) / 2
        r = r / jnp.trace(r)
        C = _cholesky_psd(r)  # r = C C^dag
        ARs = []
        for A in reversed(self.data):
            B = jnp.einsum("sjk,kl->sjl", A, C)
            d, Dl, Dr = B.shape
            # RQ via QR of the conjugate transpose: B[s] C = C' AR[s] with
            # sum AR AR^dag = I  <=>  stack B as (Dl, d*Dr) rows and QR its
            # dagger
            mat = B.transpose(1, 0, 2).reshape(Dl, d * Dr)
            Q, R = _qr_pos(mat.conj().T)  # (d Dr, Dl), (Dl, Dl)
            ARs.append(Q.conj().T.reshape(Dl, d, Dr).transpose(1, 0, 2))
            C = R.conj().T
        return iMPS(list(reversed(ARs)))

    def mixed(self):
        """(AL, AR, C) mixed gauge of the (blocked) state
        (xmps iMPS.mixed analogue; reference use: qmps/tools.py:184-186)."""
        AL, _, _ = left_orthogonalise(self.blocked)
        _, r = tr.right_fixed_point(AL, AL)
        r = (r + cT(r)) / 2
        r = r / jnp.trace(r)
        C = _cholesky_psd(r)  # r = C C^dag
        Cinv = _pinv_tri(C)
        AR = jnp.einsum("ij,sjk,kl->sil", Cinv, AL, C)
        return AL, AR, C

    def schmidt_values(self) -> jnp.ndarray:
        """Bipartition Schmidt coefficients of the infinite chain: the
        (normalized) singular values of the mixed-gauge center matrix C
        (r = C C^dag).  Descending order."""
        _, _, C = self.mixed()
        s = jnp.linalg.svd(C, compute_uv=False)
        return s / jnp.linalg.norm(s)

    def entanglement_entropy(self) -> jnp.ndarray:
        """Half-chain von Neumann entropy S = -sum s^2 log s^2 of the
        bipartition Schmidt spectrum.  The log guard must be dtype-aware:
        a float literal like 1e-300 underflows to 0 in float32 (the
        x64-off mode), making the clip a no-op and an exactly-zero Schmidt
        coefficient yield 0 * log(0) = NaN."""
        s2 = self.schmidt_values() ** 2
        tiny = jnp.finfo(s2.dtype).tiny
        return -jnp.sum(s2 * jnp.log(jnp.clip(s2, tiny, None)))

    def truncated(self, D_new: int) -> tuple["iMPS", jnp.ndarray]:
        """Compress to bond dimension D_new by keeping the D_new largest
        Schmidt vectors of the bipartition (the inverse of the D -> 2D
        warm-start growth, core/lie.embed_su_params).

        In mixed gauge with C = U S V^dag, the kept left Schmidt basis is
        the leading columns of U; projecting AL into it and
        re-canonicalizing gives the compressed state.  Returns
        (state, kept_weight) where kept_weight = sum of the kept squared
        Schmidt coefficients (1 - truncation error; exactly 1 when the
        state's Schmidt rank <= D_new)."""
        AL, _, C = self.mixed()
        U, s, _ = jnp.linalg.svd(C)
        s2 = (s / jnp.linalg.norm(s)) ** 2
        P = U[:, :D_new]
        A_new = jnp.einsum("ij,sjk,kl->sil", P.conj().T, AL, P)
        return iMPS([A_new]).left_canonicalise(), jnp.sum(s2[:D_new])

    # observables ------------------------------------------------------------
    def E(self, op: jnp.ndarray, canonical: bool = True) -> jnp.ndarray:
        """Single-site expectation value <psi|op|psi> (per site)."""
        A = self.blocked
        if canonical:
            AL, _, _ = left_orthogonalise(A)
        else:
            AL = A
        _, r = tr.right_fixed_point(AL, AL)
        r = (r + cT(r)) / 2
        r = r / jnp.trace(r)
        # op[t, s] pairs the BRA index t with the conjugated tensor;
        # the "st" order silently computed <op^T> (wrong for e.g. Y)
        return jnp.einsum("ts,sij,jk,tik->", jnp.asarray(op, A.dtype), AL, r, AL.conj())

    def Es(self, ops: Sequence[jnp.ndarray]) -> jnp.ndarray:
        AL, _, _ = left_orthogonalise(self.blocked)
        _, r = tr.right_fixed_point(AL, AL)
        r = (r + cT(r)) / 2
        r = r / jnp.trace(r)
        return jnp.stack(
            [
                jnp.einsum("ts,sij,jk,tik->", jnp.asarray(op, AL.dtype), AL, r, AL.conj()).real
                for op in ops
            ]
        )

    def E2(self, op2: jnp.ndarray) -> jnp.ndarray:
        """Two-site expectation value of a (d^2 x d^2) operator."""
        AL, _, _ = left_orthogonalise(self.blocked)
        _, r = tr.right_fixed_point(AL, AL)
        r = (r + cT(r)) / 2
        r = r / jnp.trace(r)
        A2 = merge(AL, AL)
        h = jnp.asarray(op2, AL.dtype)
        return jnp.einsum("ts,sij,jk,tik->", h, A2, r, A2.conj())

    def energy(self, h: jnp.ndarray) -> jnp.ndarray:
        return self.E2(h).real

    def energy_variance(self, h: jnp.ndarray,
                        env_solver: str = "dense") -> jnp.ndarray:
        """Per-site energy variance (<H^2> - <H>^2)/N for H = sum h_{n,n+1}
        — zero iff the state is an exact eigenstate; the oracle-free
        convergence certificate (tdvp.energy_variance_density)."""
        from .tdvp import energy_variance_density

        AL, _, _ = left_orthogonalise(self.blocked)
        _, r = tr.right_fixed_point(AL, AL)
        r = (r + cT(r)) / 2
        r = r / jnp.trace(r)
        return energy_variance_density(
            AL, r, jnp.asarray(h, AL.dtype), env_solver=env_solver
        )

    def correlation_length(self) -> jnp.ndarray:
        """xi = -1 / log (|lambda_2| / |lambda_1|) of the transfer spectrum.

        The dominant pair is deflated (left/right eigenvector pair — the
        transfer operator is non-normal) and |lambda_2| of the deflated
        matrix is taken as its SPECTRAL RADIUS via Gelfand's formula
        (transfer.spectral_radius_dense), NOT a Rayleigh quotient: the
        subdominant eigenvalue is generically a complex-conjugate pair
        (oscillatory correlations), where squaring has no eigenvector to
        converge to and a Rayleigh quotient at the mixed vector
        underestimates |lambda_2| badly (measured 0.55 -> 0.02 on random
        D=3 states; the radius form is exact to ~1e-7)."""
        A = self.blocked
        AL, _, _ = left_orthogonalise(A)
        E = tr.transfer_dense(AL, AL)
        lam1, v1 = tr.dominant_eig_dense(E)
        lam1l, w1 = tr.dominant_eig_dense(E.conj().T)
        w1 = w1 / jnp.vdot(w1, v1).conj()
        E2 = E - lam1 * jnp.outer(v1, w1.conj())
        rho2 = tr.spectral_radius_dense(E2)
        ratio = rho2 / jnp.abs(lam1)
        eps = jnp.finfo(ratio.dtype).eps
        return -1.0 / jnp.log(jnp.clip(ratio, jnp.finfo(ratio.dtype).tiny, 1 - eps))

    def correlator(self, op1, op2, max_dist: int = 20) -> jnp.ndarray:
        """Connected two-point function C(r) = <O1_0 O2_r> - <O1><O2> for
        r = 1..max_dist, via repeated transfer application."""
        AL, _, _ = left_orthogonalise(self.blocked)
        _, r = tr.right_fixed_point(AL, AL)
        r = (r + cT(r)) / 2
        r = r / jnp.trace(r)
        op1 = jnp.asarray(op1, AL.dtype)
        op2 = jnp.asarray(op2, AL.dtype)
        # right block with O2 inserted: T2 = sum_{s,t} op2[t,s]... as matrix
        T2 = jnp.einsum("ts,sij,jk,tlk->il", op2, AL, r, AL.conj())
        e1 = jnp.einsum("ts,sij,jk,tik->", op1, AL, r, AL.conj())
        e2 = jnp.trace(T2)

        def step(T, _):
            c = jnp.einsum("ts,sij,jk,tik->", op1, AL, T, AL.conj())
            return tr.right_matvec(AL, AL, T), c

        _, cs = jax.lax.scan(step, T2, None, length=max_dist)
        # cs[k] = <O1_0 O2_{k+1}> (k = 0 is the adjacent pair)
        return (cs - e1 * e2).real

    def static_structure_factor(self, op, p, max_dist: int = 60) -> jnp.ndarray:
        """s(p) = sum_r e^{ipr} <O_0 O_r>_c, the momentum-space connected
        two-point function: C(0) = <O^2> - <O>^2 plus 2 sum_{r>=1}
        cos(pr) C(r) (Hermitian O; C(r) from ``correlator``).  This is
        the sum rule the one-particle spectral weights of
        mps.excitations.spectral_weights saturate (tests pin ~99% at
        g=1.5 — the remainder is the multi-particle continuum)."""
        op = jnp.asarray(op)
        Cr = self.correlator(op, op, max_dist=max_dist)
        e1 = jnp.real(self.E(op))
        e2 = jnp.real(self.E(op @ op))
        r = jnp.arange(1, max_dist + 1)
        p = jnp.asarray(p)
        cos = jnp.cos(p[..., None] * r) if p.ndim else jnp.cos(p * r)
        return (e2 - e1 ** 2) + 2.0 * jnp.sum(cos * Cr, axis=-1)

    def dA_dt(self, h: jnp.ndarray) -> jnp.ndarray:
        """TDVP tangent vector for this state under the two-site Hamiltonian
        h (xmps iMPS.dA_dt analogue; see mps.tdvp)."""
        from .tdvp import dA_dt as _dA_dt

        return _dA_dt(self.blocked, h)

    def overlap(self, other: "iMPS") -> jnp.ndarray:
        """|<psi_A|psi_B>|^2 per site = |dominant eig of the mixed transfer
        operator|^2, both states canonicalized (xmps overlap semantics as used
        for Loschmidt echoes, scripts/loschmidt.py:370)."""
        AL, _, _ = left_orthogonalise(self.blocked)
        BL, _, _ = left_orthogonalise(other.blocked)
        lam, _ = tr.right_fixed_point(AL, BL)
        return jnp.abs(lam) ** 2


class Map:
    """Mixed transfer operator E^A_B (xmps Map analogue)."""

    def __init__(self, A: jnp.ndarray, B: jnp.ndarray):
        self.A = jnp.asarray(A)
        self.B = jnp.asarray(B)

    def asmatrix(self) -> jnp.ndarray:
        return tr.transfer_dense(self.A, self.B)

    def right_fixed_point(self, dense: bool = True):
        return tr.right_fixed_point(self.A, self.B, dense=dense)

    def left_fixed_point(self, dense: bool = True):
        """Returns (x, l) with sum_s A[s]^dag l B[s] = conj(x) l and x the
        (shared) dominant eigenvalue of the transfer operator.  Circuit
        readout identity: 2 psi[0] = Tr(g l^T) (see
        tests/test_overlap_identities.py; the reference states Tr(g l.conj()),
        qmps/new_time_evolve.py:145, which coincides when l is hermitian)."""
        lam, l = tr.left_fixed_point(self.A, self.B, dense=dense)
        return jnp.conj(lam), l

    def is_right_eigenvector(self, r: jnp.ndarray, lam=None) -> jnp.ndarray:
        Er = tr.right_matvec(self.A, self.B, r)
        if lam is None:
            lam = jnp.vdot(r.reshape(-1), Er.reshape(-1)) / jnp.vdot(
                r.reshape(-1), r.reshape(-1)
            )
        return jnp.linalg.norm(Er - lam * r)

    def is_left_eigenvector(self, l: jnp.ndarray, lam=None) -> jnp.ndarray:
        El = tr.left_matvec(self.A, self.B, l)
        if lam is None:
            lam = jnp.vdot(l.reshape(-1), El.reshape(-1)) / jnp.vdot(
                l.reshape(-1), l.reshape(-1)
            )
        return jnp.linalg.norm(El - lam * l)


class TransferMatrix(Map):
    """Transfer operator of a single state (xmps TransferMatrix analogue)."""

    def __init__(self, A: jnp.ndarray):
        super().__init__(A, A)

    def eigs(self):
        """(eta, l, r): dominant eigenvalue with left/right fixed points,
        both hermitian with unit trace (xmps .eigs as consumed by
        qmps/tools.py:176-182)."""
        eta, r = tr.right_fixed_point(self.A, self.A)
        _, l = tr.left_fixed_point(self.A, self.A)
        r = (r + cT(r)) / 2
        l = (l + cT(l)) / 2
        r = r / jnp.trace(r)
        l = l / jnp.trace(l)
        return eta, l, r
