"""Uniform (infinite) Matrix Product Operators and MPO-driven VUMPS/TDVP.

The reference's classical baseline consumes an MPO Hamiltonian
(`xmps.tdvp.tdvp_fast.MPO_TFI`, used at
the reference's qmps/loschmidts/mps_loschmidts.py:3; listed in SURVEY.md
L0's public interface) — the one L0 symbol the two-site-``h`` plumbing of
`mps/tdvp.py` did not cover.  This module provides it in JAX and
goes past the reference: besides nearest-neighbour models it handles any
finite-range interaction (next-nearest-neighbour Ising below) and
exponentially decaying couplings (a diagonal ``lam * I`` interior block),
neither of which fit a two-site ``h`` at all.

Representation: a Schur-form (upper-triangular) uniform MPO tensor
``W[a, b]`` of d x d blocks with ``W[0, 0] = W[chi-1, chi-1] = I``; the
Hamiltonian is the sum over all placements of strings that start in row 0
and end in column chi-1 (left boundary e_0, right boundary e_{chi-1}).
``W`` is a HOST numpy array, baked into jitted programs as a constant —
the same convention as ``ham.Hamiltonian.to_matrix`` (complex constants
cannot cross host<->device at trace time on this backend, config.py).

Environments: the standard triangular recursion (Zauner-Stauber et al.,
PRB 97, 045145, App. C).  With AL left-canonical and r its right fixed
point, the left block environments ``L_a`` (D x D, a = 0..chi-1) satisfy

    L_b = sum_{a<=b, s, t}  AL_s^dag L_a W[a, b, s, t] AL_t ,

solved component-by-component down the triangle: ``L_0 = I`` exactly; a
strictly-triangular interior component is a direct sum; an interior
component with ``W[b, b] != 0`` is a NONSINGULAR dense (D^2, D^2) solve
(geometric sum of a contraction with spectral radius < 1); and the final
component ``L_{chi-1}`` is the SINGULAR geometric sum regularized by the
energy-density subtraction — exactly `tdvp._solve_left_env`, shared.
Right environments mirror this with AR and the left fixed point l.

Everything is fixed-shape jax under the hood (the recursion is a host
loop over the STATIC MPO bond dimension), so the whole stack jits, vmaps
and differentiates like the two-site path.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..core.linalg import cT
from . import transfer as tr
from .tdvp import (
    _extract_AL,
    _h4,
    _lanczos_ground,
    _pinv,
    _polar_right_rows,
    _refresh_C,
    _solve_left_env,
    _solve_right_env,
    _two_site,
    mixed_gauge,
)

__all__ = [
    "MPO",
    "mpo_tfim",
    "mpo_heisenberg",
    "mpo_xxz",
    "mpo_nnn_ising",
    "mpo_exp_decay",
    "mpo_from_two_site",
    "mpo_environments",
    "energy_mpo",
    "effective_H_AC_mpo",
    "effective_H_C_mpo",
    "dAC_dC_dt_mpo",
    "tdvp_step_mpo",
    "tdvp_step_rk4_mpo",
    "vumps_ground_state_mpo",
]


class MPO:
    """Schur-form uniform MPO: ``W[a, b, s, t]`` host numpy, upper
    triangular in (a, b) with identity corner blocks.

    ``W[a, b]`` is the d x d operator block from left bond state a to
    right bond state b; ``s`` is the output (bra) physical index and
    ``t`` the input (ket) index, so a block equals its operator matrix.
    """

    def __init__(self, W):
        W = np.asarray(W)
        if W.ndim != 4 or W.shape[0] != W.shape[1] or W.shape[2] != W.shape[3]:
            raise ValueError(f"W must be (chi, chi, d, d), got {W.shape}")
        chi, _, d, _ = W.shape
        if chi < 2:
            # a chi=1 tensor has no (row-0 -> column chi-1) string channel:
            # both corner checks would hit the same block and the
            # environment recursion below would never bind its loop
            # variable (NameError) / return None energies downstream
            raise ValueError(
                f"Schur-form MPO needs chi >= 2 bond states, got chi={chi}"
            )
        eye = np.eye(d)
        for corner in (0, chi - 1):
            if not np.allclose(W[corner, corner], eye, atol=1e-12):
                raise ValueError("Schur form requires identity corner blocks")
        tril = [
            (a, b) for a in range(chi) for b in range(a)
            if np.any(np.abs(W[a, b]) > 1e-14)
        ]
        if tril:
            raise ValueError(f"W must be upper triangular, nonzero at {tril}")
        # interior diagonal blocks drive the geometric environment sums:
        # the interior system (1 - W[b,b] x E) is solved WITHOUT the
        # rank-1 deflation that regularizes the corner blocks, so it is
        # singular when spectral_radius(W[b,b]) >= 1 (e.g. W[1,1] = I, a
        # non-decaying infinite-range coupling) — jnp.linalg.solve would
        # return non-finite values silently inside jit.  Reject here.
        for b in range(1, chi - 1):
            rad = np.max(np.abs(np.linalg.eigvals(W[b, b])))
            if rad >= 1.0 - 1e-12:
                raise ValueError(
                    f"interior diagonal block W[{b},{b}] has spectral "
                    f"radius {rad:.6f} >= 1: the geometric environment "
                    "sum diverges (only decaying interior strings are "
                    "representable; see mpo_exp_decay's |lam| < 1 rule)"
                )
        self.W = W.astype(np.complex128)

    @property
    def chi(self) -> int:
        return self.W.shape[0]

    @property
    def d(self) -> int:
        return self.W.shape[2]

    def matrix(self, n: int) -> np.ndarray:
        """Dense n-site Hamiltonian (open boundary, all string placements
        that FIT in the window) — the small-window oracle the tests pin
        the environment recursion against."""
        chi, d = self.chi, self.d
        vl = np.zeros(chi)
        vl[0] = 1.0
        vr = np.zeros(chi)
        vr[-1] = 1.0
        # boundary-contracted transfer product over the MPO bond:
        # cur[b] = d^k x d^k operator with left bond ending in state b
        cur = {0: np.eye(1)}
        for _ in range(n):
            nxt = {}
            for a, op in cur.items():
                for b in range(a, chi):
                    blk = self.W[a, b]
                    if not np.any(np.abs(blk) > 1e-14):
                        continue
                    term = np.kron(op, blk)
                    nxt[b] = term if b not in nxt else nxt[b] + term
            cur = nxt
        # no string terminates inside the window (e.g. a field-free
        # nearest-neighbour MPO at n=1): the Hamiltonian restricted to
        # the window is the zero operator, not a KeyError
        return cur.get(chi - 1, np.zeros((d**n, d**n), np.complex128))

    def two_site_matrix(self) -> np.ndarray:
        """Dense bond Hamiltonian h with H = sum_n h_{n,n+1} — EXACT for
        MPOs whose strings have range <= 2 (no interior-to-interior
        blocks in the Schur triangle); raises for longer-range operators
        rather than silently dropping their strings.  On-site strings
        (the W[0, chi-1] corner) are split half-and-half across the bond
        — the same convention as ham.Hamiltonian.to_matrix, so
        ``mpo_from_two_site(h).two_site_matrix() == h`` exactly and the
        circuit-TDVP steppers (whose Trotter gate is two-site) can
        consume any two-site-representable MPO."""
        chi, d = self.chi, self.d
        W = self.W
        long_range = [
            (a, b) for a in range(1, chi - 1) for b in range(a, chi - 1)
            if np.any(np.abs(W[a, b]) > 1e-14)
        ]
        if long_range:
            raise ValueError(
                "MPO has interior-to-interior blocks at "
                f"{long_range}: its strings have range >= 3 and cannot "
                "be written as a two-site bond Hamiltonian — use the "
                "MPO-native evolution path (mps.tdvp.Trajectory(A0, "
                "h=mpo)) instead"
            )
        eye = np.eye(d)
        h = np.zeros((d * d, d * d), np.complex128)
        for k in range(1, chi - 1):
            h += np.kron(W[0, k], W[k, chi - 1])
        f = W[0, chi - 1]
        h += 0.5 * (np.kron(f, eye) + np.kron(eye, f))
        return h


def mpo_tfim(g: float, J: float = 1.0) -> MPO:
    """TFIM  H = -J sum Z_i Z_{i+1} - g sum X_i  (the xmps ``MPO_TFI``
    capability, /root/reference/qmps/loschmidts/mps_loschmidts.py:3).

    NOTE the sign/splitting convention matches ``ham.tfim(g)``'s TWO-SITE
    matrix -ZZ + (g/2)(XI + IX) only up to the sign of the field term:
    ham.tfim uses +g X.  This constructor takes the textbook -g X; pass
    g -> -g for bit-parity with ham.tfim (TFIM is unitarily equivalent
    under Z-conjugation, so energies agree either way)."""
    from ..core.paulis import PAULI

    I, X, Z = PAULI["I"], PAULI["X"], PAULI["Z"]
    W = np.zeros((3, 3, 2, 2), np.complex128)
    W[0, 0] = I
    W[2, 2] = I
    W[0, 1] = Z
    W[1, 2] = -J * Z
    W[0, 2] = -g * X
    return MPO(W)


def mpo_from_two_site(h) -> MPO:
    """Exact MPO of an arbitrary two-site Hamiltonian h[(uv), (st)] via
    the operator-Schmidt (SVD) decomposition h = sum_k O_k (x) P_k —
    chi = 2 + rank <= 6 for d = 2.  Guarantees ENERGY-IDENTICAL plumbing
    with the two-site path for any model in the reference's zoo."""
    h = np.asarray(h, np.complex128)
    d = int(round(h.shape[0] ** 0.5))
    hk = h.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(d * d, d * d)
    u, s, vh = np.linalg.svd(hk)
    rank = int(np.sum(s > 1e-12 * s[0]))
    chi = rank + 2
    W = np.zeros((chi, chi, d, d), np.complex128)
    eye = np.eye(d)
    W[0, 0] = eye
    W[chi - 1, chi - 1] = eye
    for k in range(rank):
        W[0, 1 + k] = (u[:, k] * s[k]).reshape(d, d)
        W[1 + k, chi - 1] = vh[k].reshape(d, d)
    return MPO(W)


def mpo_heisenberg(J: float = 1.0) -> MPO:
    """Isotropic Heisenberg H = J sum (XX + YY + ZZ) (the MPO form of
    ham.heisenberg / new_tdvp/HeisenbergHam.py:24-25)."""
    return mpo_xxz(delta=1.0, J=J)


def mpo_xxz(delta: float, J: float = 1.0) -> MPO:
    """XXZ  H = J sum (XX + YY + delta ZZ), chi = 5."""
    from ..core.paulis import PAULI

    I, X, Y, Z = PAULI["I"], PAULI["X"], PAULI["Y"], PAULI["Z"]
    W = np.zeros((5, 5, 2, 2), np.complex128)
    W[0, 0] = I
    W[4, 4] = I
    for k, (op, coef) in enumerate(((X, J), (Y, J), (Z, J * delta))):
        W[0, 1 + k] = op
        W[1 + k, 4] = coef * op
    return MPO(W)


def mpo_nnn_ising(g: float, J2: float, J1: float = 1.0) -> MPO:
    """Next-nearest-neighbour Ising
    H = -J1 sum Z_i Z_{i+1} - J2 sum Z_i Z_{i+2} - g sum X_i  (chi = 4)
    — the minimal model that CANNOT be written as a two-site ``h``; the
    capability the MPO layer adds over mps/tdvp.py."""
    from ..core.paulis import PAULI

    I, X, Z = PAULI["I"], PAULI["X"], PAULI["Z"]
    W = np.zeros((4, 4, 2, 2), np.complex128)
    W[0, 0] = I
    W[3, 3] = I
    W[0, 1] = Z
    W[1, 2] = I  # carry Z one more site for the J2 string
    W[1, 3] = -J1 * Z
    W[2, 3] = -J2 * Z
    W[0, 3] = -g * X
    return MPO(W)


def mpo_exp_decay(op_l, op_r, lam: float, prefactor: float = 1.0,
                  field=None) -> MPO:
    """Exponentially decaying two-body coupling
    H = prefactor sum_{i<j} lam^(j-i-1) op_l_i op_r_j  (+ field on-site),
    chi = 3 with interior block W[1,1] = lam I — exercises the
    nonsingular interior geometric-sum solve (|lam| < 1 required)."""
    if not abs(lam) < 1:
        raise ValueError("exp-decay MPO needs |lam| < 1")
    op_l = np.asarray(op_l, np.complex128)
    op_r = np.asarray(op_r, np.complex128)
    d = op_l.shape[0]
    W = np.zeros((3, 3, d, d), np.complex128)
    eye = np.eye(d)
    W[0, 0] = eye
    W[2, 2] = eye
    W[0, 1] = op_l
    W[1, 1] = lam * eye
    W[1, 2] = prefactor * op_r
    if field is not None:
        W[0, 2] = np.asarray(field, np.complex128)
    return MPO(W)


# ---------------------------------------------------------------------------
# Block environments
# ---------------------------------------------------------------------------


def _wblocks(mpo: MPO, dtype):
    """Host W -> list-of-lists of jnp blocks (None where zero) + the
    static sparsity pattern.  Blocks become compile-time constants."""
    W = mpo.W
    chi = mpo.chi
    blocks = [[None] * chi for _ in range(chi)]
    for a in range(chi):
        for b in range(a, chi):
            if np.any(np.abs(W[a, b]) > 1e-14):
                blocks[a][b] = jnp.asarray(W[a, b], dtype)
    return blocks


def _apply_left(AL, X, blk):
    """sum_{s,t} AL_s^dag X blk[s, t] AL_t  (one site of the left
    recursion through one W block)."""
    return jnp.einsum("sia,ij,st,tjb->ab", AL.conj(), X, blk, AL)


def _apply_right(AR, X, blk):
    """sum_{s,t} AR_t X AR_s^dag through one W block; index order
    (ket, bra) matching the right-recursion convention."""
    return jnp.einsum("st,taj,ji,sbi->ab", blk, AR, X, AR.conj())


def _solve_interior_left(AL, blk, rhs):
    """L solving  L - sum_{s,t} blk[s,t] AL_s^dag L AL_t = rhs  — the
    NONSINGULAR interior geometric sum (spectral radius of the blk-weighted
    transfer < 1 for a valid Schur MPO).  Dense (D^2, D^2)."""
    D = AL.shape[1]
    T = jnp.einsum("st,sia,tjb->abij", blk, AL.conj(), AL).reshape(D * D, D * D)
    M = jnp.eye(D * D, dtype=AL.dtype) - T
    return jnp.linalg.solve(M, rhs.reshape(-1)).reshape(D, D)


def _solve_interior_right(AR, blk, rhs):
    D = AR.shape[1]
    T = jnp.einsum("st,tai,sbj->abij", blk, AR, AR.conj()).reshape(D * D, D * D)
    M = jnp.eye(D * D, dtype=AR.dtype) - T
    return jnp.linalg.solve(M, rhs.reshape(-1)).reshape(D, D)


def mpo_environments(AL, AR, C, mpo: MPO, env_solver: str = "dense"):
    """(Ls, Rs, e): stacked left/right MPO block environments
    (chi, D, D) and the energy density.

    Ls[a][i, j]: i contracts the conjugate (bra) layer, j the ket layer;
    Rs[b][i, j]: i the ket layer, j the bra layer — so
    ``energy-ish = sum_a tr(Ls[a] @ C @ Rs[a] @ C^dag)`` type contractions
    close correctly.  The extensive part is subtracted from BOTH singular
    components (Ls[-1], Rs[0]), making the effective Hamiltonians below
    connected."""
    D = AL.shape[1]
    dtype = AL.dtype
    blocks = _wblocks(mpo, dtype)
    chi = mpo.chi
    r = C @ cT(C)
    l = cT(C) @ C
    eye = jnp.eye(D, dtype=dtype)

    Ls = [None] * chi
    Ls[0] = eye
    for b in range(1, chi):
        rhs = jnp.zeros((D, D), dtype)
        for a in range(b):
            if blocks[a][b] is not None:
                rhs = rhs + _apply_left(AL, Ls[a], blocks[a][b])
        if b < chi - 1:
            if blocks[b][b] is None:
                Ls[b] = rhs
            else:
                Ls[b] = _solve_interior_left(AL, blocks[b][b], rhs)
        else:
            e = jnp.trace(rhs @ r).real
            Ls[b] = _solve_left_env(AL, r, rhs - e * eye, solver=env_solver)

    Rs = [None] * chi
    Rs[chi - 1] = eye
    for a in range(chi - 2, -1, -1):
        rhs = jnp.zeros((D, D), dtype)
        for b in range(a + 1, chi):
            if blocks[a][b] is not None:
                rhs = rhs + _apply_right(AR, Rs[b], blocks[a][b])
        if a > 0:
            if blocks[a][a] is None:
                Rs[a] = rhs
            else:
                Rs[a] = _solve_interior_right(AR, blocks[a][a], rhs)
        else:
            eR = jnp.trace(l @ rhs).real
            Rs[a] = _solve_right_env(AR, l, rhs - eR * eye, solver=env_solver)

    return jnp.stack(Ls), jnp.stack(Rs), e


def energy_mpo(AL, C, mpo: MPO) -> jnp.ndarray:
    """Energy density of a left-canonical uMPS under the MPO — the inflow
    into the singular left component, tr(rhs_{chi-1} r).  Agrees with
    `tdvp.energy_density(AL, C, h)` to machine precision for any
    two-site model written as an MPO (tests/test_mpo.py)."""
    D = AL.shape[1]
    dtype = AL.dtype
    blocks = _wblocks(mpo, dtype)
    chi = mpo.chi
    r = C @ cT(C)
    Ls = [None] * chi
    Ls[0] = jnp.eye(D, dtype=dtype)
    for b in range(1, chi):
        rhs = jnp.zeros((D, D), dtype)
        for a in range(b):
            if blocks[a][b] is not None:
                rhs = rhs + _apply_left(AL, Ls[a], blocks[a][b])
        if b == chi - 1:
            return jnp.trace(rhs @ r).real
        Ls[b] = rhs if blocks[b][b] is None else _solve_interior_left(
            AL, blocks[b][b], rhs
        )


def effective_H_AC_mpo(x, Ls, Rs, mpo: MPO, e=None):
    """MPO one-site effective Hamiltonian applied to x (d, D, D):

        (H_AC x)[s, p, q] = sum_{a,b,t} Ls[a][p, p'] W[a,b,s,t]
                            x[t, p', q'] Rs[b][q', q]

    With ``e`` given, the on-site corner block W[0, chi-1] is shifted by
    -e I, making H_AC the CONNECTED effective Hamiltonian (the analogue
    of tdvp.dAC_dC_dt's h - e subtraction): on a variational optimum
    H_AC(AC) = AL H_C(C) exactly, with no constant offset between the
    two — pinned against the two-site path in tests/test_mpo.py."""
    dtype = x.dtype
    blocks = _wblocks(mpo, dtype)
    chi = mpo.chi
    out = jnp.zeros_like(x)
    for a in range(chi):
        for b in range(a, chi):
            blk = blocks[a][b]
            if a == 0 and b == chi - 1 and e is not None:
                shift = e * jnp.eye(mpo.d, dtype=dtype)
                blk = -shift if blk is None else blk - shift
            if blk is None:
                continue
            out = out + jnp.einsum(
                "pi,st,tij,jq->spq", Ls[a], blk, x, Rs[b]
            )
    return out


def effective_H_C_mpo(C, Ls, Rs):
    """(H_C x)[p, q] = sum_a Ls[a][p, p'] x[p', q'] Rs[a][q', q]."""
    return jnp.einsum("api,ij,ajq->pq", Ls, C, Rs)


def dAC_dC_dt_mpo(AL, AR, C, mpo: MPO, env_solver: str = "dense"):
    """(-i H_AC(AC), -i H_C(C), e) — the MPO tangent flow, PHASE-FREE
    like `tdvp.dAC_dC_dt`: the expectation <AC|H_AC|AC> (resp.
    <C|H_C|C>) is subtracted from each flow, which for a two-site model
    equals the 2e (resp. e) shift of the h - e convention EXACTLY — the
    two flows agree array-for-array (tests/test_mpo.py).  For a general
    MPO the overlap count of string placements with the centre site is
    range-dependent, so the subtraction must be the measured expectation,
    not a multiple of e."""
    AC = jnp.einsum("sij,jk->sik", AL, C)
    Ls, Rs, e = mpo_environments(AL, AR, C, mpo, env_solver=env_solver)
    gAC = effective_H_AC_mpo(AC, Ls, Rs, mpo)
    gC = effective_H_C_mpo(C, Ls, Rs)
    lam_AC = jnp.real(jnp.vdot(AC, gAC)) / jnp.real(jnp.vdot(AC, AC))
    lam_C = jnp.real(jnp.vdot(C, gC)) / jnp.real(jnp.vdot(C, C))
    dAC = -1j * (gAC - lam_AC * AC)
    dC = -1j * (gC - lam_C * C)
    return dAC, dC, e


def _tangent_mpo(mpo: MPO, env_solver: str = "dense"):
    """tangent(AL, C) -> (dAC, dC, e) under an MPO Hamiltonian — the MPO
    twin of `tdvp._tangent_dense`, pluggable into the shared generic
    steppers (`tdvp._euler_step` / `tdvp._rk4_step`) and into
    `tdvp.Trajectory(A0, h=mpo)`."""
    def tangent(AL, C):
        AR = jnp.einsum("ij,sjk,kl->sil", _pinv(C), AL, C)
        return dAC_dC_dt_mpo(AL, AR, C, mpo, env_solver=env_solver)

    return tangent


def tdvp_step_mpo(AL, C, mpo: MPO, dt: float, env_solver: str = "dense"):
    """One explicit-Euler TDVP step under an MPO Hamiltonian (the
    gauge-preserving polar retraction is shared with the dense path)."""
    from .tdvp import _euler_step

    return _euler_step(AL, C, dt, _tangent_mpo(mpo, env_solver))


def tdvp_step_rk4_mpo(AL, C, mpo: MPO, dt: float, env_solver: str = "dense"):
    """One classical-RK4 TDVP step under an MPO Hamiltonian (see
    `tdvp.tdvp_step_rk4` for the DPT-stability rationale)."""
    from .tdvp import _rk4_step

    return _rk4_step(AL, C, dt, _tangent_mpo(mpo, env_solver))


def dA_dt_mpo(A, mpo: MPO):
    """Tangent vector for a left-canonical tensor A under an MPO
    Hamiltonian (iMPS.dA_dt with MPO plumbing)."""
    AL, AR, C = mixed_gauge(A)
    dAC, dC, _ = dAC_dC_dt_mpo(AL, AR, C, mpo)
    Cinv = _pinv(C)
    return jnp.einsum(
        "sij,jk->sik", dAC - jnp.einsum("sij,jk->sik", AL, dC), Cinv
    )


def vumps_step_mpo(AL, AR, C, mpo: MPO, k: int = 24,
                   env_solver: str = "dense"):
    """One MPO-VUMPS iteration (mirrors tdvp.vumps_step with MPO
    environments).  Returns (AL, AR, C, e, grad_norm)."""
    d, D, _ = AL.shape
    Ls, Rs, e = mpo_environments(AL, AR, C, mpo, env_solver=env_solver)
    AC = jnp.einsum("sij,jk->sik", AL, C)

    gAC = effective_H_AC_mpo(AC, Ls, Rs, mpo, e=e)
    gC = effective_H_C_mpo(C, Ls, Rs)
    grad = gAC - jnp.einsum("sij,jk->sik", AL, gC)
    grad_norm = jnp.linalg.norm(grad)

    _, ac = _lanczos_ground(
        lambda x: effective_H_AC_mpo(
            x.reshape(d, D, D), Ls, Rs, mpo, e=e
        ).reshape(-1),
        AC.reshape(-1),
        k,
    )
    _, c = _lanczos_ground(
        lambda x: effective_H_C_mpo(x.reshape(D, D), Ls, Rs).reshape(-1),
        C.reshape(-1),
        k,
    )
    ACn = ac.reshape(d, D, D)
    Cn = c.reshape(D, D)

    ALn = _extract_AL(ACn, Cn)
    UAC_r = _polar_right_rows(ACn.transpose(1, 0, 2).reshape(D, d * D))
    UC_r = _polar_right_rows(Cn)
    ARn = (cT(UC_r) @ UAC_r).reshape(D, d, D).transpose(1, 0, 2)
    ph = jnp.exp(-1j * jnp.angle(jnp.trace(Cn)))
    return ALn, ARn, Cn * ph.astype(Cn.dtype), e, grad_norm


import functools as _functools


@_functools.lru_cache(maxsize=32)
def _vumps_mpo_program(mpo_key, D: int, iters: int, k: int,
                       env_solver: str):
    """One compiled MPO-VUMPS program per (MPO bytes, D, iters, k,
    solver).  Same structure as tdvp._vumps_program: float planes in,
    lax.complex in-program, W baked as a host constant."""
    import jax

    chi, d = mpo_key[1], mpo_key[2]
    W = np.frombuffer(mpo_key[0], np.complex128).reshape(chi, chi, d, d)
    mpo = MPO(W)

    @jax.jit
    def run(a0re, a0im):
        A0 = jax.lax.complex(a0re, a0im)
        AL, AR, C = mixed_gauge(A0)

        def body(carry, _):
            AL, AR, C = carry
            AL, AR, C, e, g = vumps_step_mpo(AL, AR, C, mpo, k,
                                             env_solver=env_solver)
            return (AL, AR, C), (e, g)

        (AL, AR, C), (es, gs) = jax.lax.scan(
            body, (AL, AR, C), None, length=iters
        )
        # final energy at the returned AL's TRUE right fixed point (the
        # in-iteration estimator assumes C C^dag is AL's fixed point,
        # which only holds at convergence — see tdvp._vumps_program)
        _, rT = tr.right_fixed_point(AL, AL)
        rT = (rT + cT(rT)) / 2
        rT = rT / jnp.trace(rT)
        Cend = _cholesky_like(rT)
        e = energy_mpo(AL, Cend, mpo)
        return AL, C, e, es, gs

    return run


def _cholesky_like(r):
    """C with C C^dag = r for a PSD r (shared jitter convention with
    tdvp._refresh_C)."""
    D = r.shape[0]
    return jnp.linalg.cholesky(
        r + 32 * jnp.finfo(r.real.dtype).eps * jnp.eye(D, dtype=r.dtype)
    )


def vumps_ground_state_mpo(mpo: MPO, D: int, iters: int = 150, k: int = 24,
                           key=None, A0=None, env_solver: str = "auto"):
    """Ground state of an MPO Hamiltonian by VUMPS — the MPO twin of
    `tdvp.vumps_ground_state`, same contract: returns (AL, C, energy,
    info) with the energy evaluated at the returned AL's true fixed
    point.  Gates models beyond the two-site plumbing: NNN Ising,
    exponentially decaying couplings, anything in Schur form."""
    import jax

    f64 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if A0 is not None:
        a0_dtype = np.dtype(getattr(A0, "dtype", np.complex128))
        ftype = jnp.float32 if a0_dtype in (np.complex64, np.float32) else f64
    else:
        ftype = f64

    d = mpo.d
    if A0 is None:
        key = jax.random.PRNGKey(0) if key is None else key
        k1, k2 = jax.random.split(key)
        a0re = jax.random.normal(k1, (d, D, D), ftype)
        a0im = jax.random.normal(k2, (d, D, D), ftype)
    elif isinstance(A0, np.ndarray):
        a0re = jnp.asarray(np.ascontiguousarray(A0.real), ftype)
        a0im = jnp.asarray(np.ascontiguousarray(A0.imag), ftype)
    else:
        a0re, a0im = jax.jit(
            lambda A: (jnp.real(A).astype(ftype), jnp.imag(A).astype(ftype))
        )(A0)

    if env_solver == "auto":
        env_solver = "dense" if D <= 24 else "gmres"
    mpo_key = (mpo.W.tobytes(), mpo.chi, mpo.d)
    run = _vumps_mpo_program(mpo_key, D, iters, k, env_solver)
    AL, C, e, es, gs = run(a0re, a0im)
    return AL, C, float(e), {"grad_norms": gs, "energies": es}
