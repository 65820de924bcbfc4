"""Quasiparticle excitations on a uMPS ground state (tangent-space ansatz).

|Phi_p(B)> = sum_n e^{ipn} |... AL_{n-1} B_n AR_{n+1} ...> with B = V_L X
left-gauge-fixed (sum_s AL_s^dag B_s = 0), on top of a VUMPS-converged
(AL, AR, C).  The excitation energies at momentum p are the eigenvalues
of the Hermitian effective Hamiltonian H_X = V_L^dag H_eff(V_L X)
(Haegeman et al. quasiparticle ansatz; Vanderstraeten-Haegeman
-Verstraete tangent-space lecture notes).

A capability BEYOND the reference's surface: dispersion relations
epsilon(k) from the same tensors the ground-state stack produces,
validated against the exact TFIM single-particle energy
2 sqrt(1 + g^2 - 2 g cos k) (tests/test_excitations.py).

Diagram bookkeeping (bra disturbance B' fixed at site 0; all terms are
projected by V_L^dag at the end, which kills every diagram whose bra
left index ties DIRECTLY to an AL ket column — the left-gauge
simplification; the ket gauge likewise kills every diagram needing a
bare transferred ket disturbance on the left):

  same-site (n=0): effective_H_AC(B) — h-tilde on both touching bonds
      plus the HL/HR geometric environments (mps.tdvp machinery);
  ket right (n>=1): RB = e^{ip} (1 - e^{ip} T)^{-1}(sum_s B_s AR_s^dag)
      with T(r) = sum_s AL_s r AR_s^dag (dominant pair deflated; the
      seed is exactly orthogonal to it by the gauge), consumed by
      - X1: h on bond (0,1), B at site 1 (right env = I),
      - X2: h on bond (0,1), B at n>=2 (right env = e^{ip} RB),
      - X3: h on bond (-1,0) (right env = RB),
      - X4: h at bonds <= (-2,-1) -> HL . AL . RB;
  ket left (n<=-1): L1 = e^{-ip} G'(l_h1 + l_h2) + e^{-2ip} G'(v) with
      G' = (1 - e^{-ip} T')^{-1}, T'(l) = sum_s AR_s^T l conj(AL_s)
      (= T^dag under transpose; dominant vector vec(C^T)), seeds
      l_h1 (h left of B through HL), l_h2 (h on (n-1, n)),
      v (h on (n, n+1)), consumed by T_E = L1 . AR; plus
      - X5: B at -1 with h on bond (-1,0).

Conventions: A[s, i, j] (left bond i), right env maps r -> sum A r B^dag,
h[(s t), (u v)] two-site matrix with BRA row index (objectives/energy
convention), h-tilde = h - e.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.linalg import cT
from .tdvp import (
    effective_H_AC,
    hamiltonian_environments,
    mixed_gauge,
)


def null_space_VL(AL: jnp.ndarray) -> jnp.ndarray:
    """(d, D, (d-1) D) tensor V_L with sum_s AL_s^dag VL_s = 0 and
    orthonormal columns in the (s, i) row layout (complete-QR completion
    of the left isometry — the differentiable null_space replacement)."""
    d, D, _ = AL.shape
    M = AL.reshape(d * D, D)
    Q, _ = jnp.linalg.qr(M, mode="complete")
    # fix the gauge of the completion deterministically (QR's column
    # phases are arbitrary): not needed for eigenVALUES, kept simple
    return Q[:, D:].reshape(d, D, (d - 1) * D)


def _transfer_mats(AL, AR):
    """Dense (D^2, D^2) mixed transfers T (right-moving) and T'
    (left-moving), row-major vec convention vec(A r B^T) = (A (x) B) vec(r)."""
    d = AL.shape[0]
    T = sum(jnp.kron(AL[s], AR[s].conj()) for s in range(d))
    Tp = sum(jnp.kron(AR[s].T, cT(AL[s])) for s in range(d))
    return T, Tp


def _deflated_solve(M, v_dom, phase, rhs_flat, w_dom=None):
    """(1 - phase * M_deflated)^{-1} rhs with the dominant eigen-direction
    (right vector v_dom, left vector w_dom — defaults to v_dom) projected
    out of both the operator and the right-hand side (pseudo-inverse
    convention: physical seeds are orthogonal to the dominant pair by
    gauge fixing / expectation subtraction; the projection removes the
    p -> 0 singular direction without changing them)."""
    n = M.shape[0]
    if v_dom is None:  # no unit eigenvalue to remove (|spec(M)| < 1)
        return jnp.linalg.solve(jnp.eye(n, dtype=M.dtype) - phase * M, rhs_flat)
    v = v_dom
    w = v_dom if w_dom is None else w_dom
    P = jnp.outer(v, w.conj()) / (w.conj() @ v)
    A = jnp.eye(n, dtype=M.dtype) - phase * (M - P)
    rhs = rhs_flat - P @ rhs_flat
    return jnp.linalg.solve(A, rhs)


def excitation_matrix(AL, AR, C, h, p: float, symmetrize: bool = True,
                      deflate: bool = True) -> jnp.ndarray:
    """Dense Hermitian H_X at momentum p: ((d-1) D^2, (d-1) D^2).

    Eigenvalues are the excitation energies omega(p) above the ground
    state (h's extensive part is subtracted via the energy density).
    symmetrize=False returns the raw diagram sum — Hermitian only up to
    the ground state's convergence, which is what the Hermiticity TEST
    asserts (the symmetrized return would make that check vacuous).

    TOPOLOGICAL (domain-wall) sector: pass AR (and the bra's right
    tensors, implicitly the same) from a DIFFERENT degenerate ground
    state — e.g. the global-X flip of AL's state in the ordered TFIM
    phase — and deflate=False: the mixed AL/AR transfer then has
    spectral radius < 1 (distinct states), so the geometric sums
    converge without the dominant-pair projection, which would
    otherwise remove a physical component (vec(C) is only an
    eigenvector when AL and AR gauge the SAME state)."""
    d, D, _ = AL.shape
    nX = (d - 1) * D * D
    ctype = AL.dtype
    h = h.astype(ctype)

    HL, HR, e = hamiltonian_environments(AL, AR, C, h)
    ht = h - e * jnp.eye(h.shape[0], dtype=ctype)
    h4 = ht.reshape(d, d, d, d)  # [s_bra, t_bra, s_ket, t_ket]

    VL = null_space_VL(AL)
    T, Tp = _transfer_mats(AL, AR)
    vC = C.reshape(-1) if deflate else None
    vCt = C.T.reshape(-1) if deflate else None
    ph = jnp.exp(1j * jnp.asarray(p, jnp.zeros(0, ctype).real.dtype)).astype(ctype)

    def Xs_to_B(Xflat):
        X = Xflat.reshape((d - 1) * D, D)
        return jnp.einsum("sia,aj->sij", VL, X)

    def Heff_B(B):
        # --- same site -------------------------------------------------
        out = effective_H_AC(B, AL, AR, HL, HR, ht)

        # --- ket disturbance right of the bra (n >= 1) ------------------
        rB = jnp.einsum("sij,skj->ik", B, AR.conj())
        RBf = ph * _deflated_solve(T, vC, ph, rB.reshape(-1))
        RB = RBf.reshape(D, D)
        # X1: h on (0,1), B at site 1, right env = I
        out = out + ph * jnp.einsum(
            "uvst,sia,tab,vjb->uij", h4, AL, B, AR.conj()
        )
        # X2: h on (0,1), B at n >= 2, right env = e^{ip} RB
        out = out + ph * jnp.einsum(
            "uvst,sia,tab,bc,vjc->uij", h4, AL, AL, RB, AR.conj()
        )
        # X3: h on (-1,0), right env = RB
        out = out + jnp.einsum(
            "uvst,sab,uai,tbc,cj->vij", h4, AL, AL.conj(), AL, RB
        )
        # X4: h at bonds <= (-2,-1): HL (bra, ket) . AL . RB
        out = out + jnp.einsum("ia,saj,jk->sik", HL, AL, RB)

        # --- ket disturbance left of the bra (n <= -1) -------------------
        # seeds at [j_ket, j_bra]
        l_h1 = jnp.einsum("ba,sai,sbj->ij", HL, B, AL.conj())
        l_h2 = jnp.einsum("uvst,sab,tbi,uac,vcj->ij",
                          h4, AL, B, AL.conj(), AL.conj())
        v_seed = jnp.einsum("uvst,sab,tbi,uac,vcj->ij",
                            h4, B, AR, AL.conj(), AL.conj())
        L1f = _deflated_solve(
            Tp, vCt, 1.0 / ph,
            ((1.0 / ph) * (l_h1 + l_h2)
             + (1.0 / ph ** 2) * v_seed).reshape(-1),
        )
        L1 = L1f.reshape(D, D)  # [j_ket, j_bra]
        out = out + jnp.einsum("ab,saj->sbj", L1, AR)
        # X5: B at -1, h on (-1,0), left env = I, phase e^{-ip}
        out = out + (1.0 / ph) * jnp.einsum(
            "uvst,sab,uai,tbj->vij", h4, B, AL.conj(), AR
        )
        return out

    def column(Xflat):
        HB = Heff_B(Xs_to_B(Xflat))
        return jnp.einsum("sia,sij->aj", VL.conj(), HB).reshape(-1)

    basis = jnp.eye(nX, dtype=ctype)
    HX = jax.vmap(column)(basis).T
    return (HX + cT(HX)) / 2 if symmetrize else HX


def excitation_overlaps(AL, AR, C, O, p: float) -> jnp.ndarray:
    """o_X with o_X[a] = <Phi_p(V_L X_a)| O_p |GS> for the X-basis:
    the one-particle matrix elements of the momentum-space operator
    O_p = sum_n e^{ipn} O_n (O one-site, expectation-subtracted inside).

    Diagram collapse mirrors excitation_matrix: with the ket center AC
    placed at the bra-disturbance site, every O position RIGHT of it
    dies by the bra's left gauge, leaving the on-site term plus a single
    deflated geometric sum over the left AL/AL* transfer."""
    d, D, _ = AL.shape
    ctype = AL.dtype
    O = O.astype(ctype)
    r = C @ cT(C)
    eO = jnp.einsum("st,tij,jk,sik->", O, AL, r, AL.conj())
    Ot = O - eO * jnp.eye(d, dtype=ctype)
    AC = jnp.einsum("sij,jk->sik", AL, C)
    ph = jnp.exp(1j * jnp.asarray(p, jnp.zeros(0, ctype).real.dtype)).astype(ctype)

    # on-site term (O at the bra site)
    o = jnp.einsum("st,tij->sij", Ot, AC)
    # O strictly left: seed l_O [bra, ket], transferred through the
    # AL/AL* column (dominant pair: right vec(I), left vec(r))
    l_O = jnp.einsum("st,sca,tcb->ab", Ot, AL.conj(), AL)
    M_LL = sum(jnp.kron(cT(AL[s]), AL[s].T) for s in range(d))
    L = _deflated_solve(
        M_LL,
        jnp.eye(D, dtype=ctype).reshape(-1),
        1.0 / ph,
        l_O.reshape(-1),
        w_dom=r.reshape(-1),
    ).reshape(D, D)
    o = o + (1.0 / ph) * jnp.einsum("ib,sbj->sij", L, AC)

    VL = null_space_VL(AL)
    return jnp.einsum("sia,sij->aj", VL.conj(), o).reshape(-1)


def spectral_weights(AL, AR, C, h, O, p: float, n_levels: int = 4):
    """(omegas, weights): the lowest one-particle energies at momentum p
    and their spectral weights |<Phi_p(i)| O_p |GS>|^2 — the delta-peak
    strengths of the dynamical structure factor S(p, omega) within the
    single-mode subspace.  Validated against the static structure factor
    sum rule (tests/test_excitations.py)."""
    import numpy as np

    HX = np.asarray(excitation_matrix(AL, AR, C, h, p))
    oX = np.asarray(excitation_overlaps(AL, AR, C, O, p))
    evals, evecs = np.linalg.eigh(HX)
    w = np.abs(evecs.conj().T @ oX) ** 2
    return evals[:n_levels], w[:n_levels]


def dispersion(h, D: int, ps, n_levels: int = 1, iters: int = 250,
               k: int = 32, A0=None, gs=None, deflate: bool = True):
    """omega(p) for each momentum in ps: (len(ps), n_levels).

    gs: optionally a pre-converged (AL, AR, C) triple; otherwise VUMPS
    runs first (mps.tdvp.vumps_ground_state).  CPU x64 recommended (the
    effective matrices are dense D^2-sized builds + eigh)."""
    import numpy as np

    from .tdvp import vumps_ground_state

    if gs is None:
        AL, C, _, _ = vumps_ground_state(h, D, iters=iters, k=k, A0=A0)
        AL, AR, C = jax.jit(mixed_gauge)(AL)
    else:
        AL, AR, C = gs

    # the whole pipeline crosses the jit boundary as float real/imag
    # planes, assembled with lax.complex in-program, and reads back as
    # float planes too
    ftype = jnp.float32 if AL.dtype == jnp.complex64 else jnp.float64
    split = jax.jit(lambda *xs: tuple(
        q for x in xs for q in (jnp.real(x).astype(ftype), jnp.imag(x).astype(ftype))
    ))
    planes = split(AL, AR, C)
    h_host = np.asarray(h)
    hre = jnp.asarray(np.ascontiguousarray(h_host.real), ftype)
    him = jnp.asarray(np.ascontiguousarray(h_host.imag), ftype)

    @jax.jit
    def build(alre, alim, arre, arim, cre, cim, hre, him, p):
        c = jax.lax.complex
        M = excitation_matrix(
            c(alre, alim), c(arre, arim), c(cre, cim), c(hre, him), p,
            deflate=deflate,
        )
        return jnp.real(M), jnp.imag(M)

    out = []
    for p in ps:
        re, im = build(*planes, hre, him, jnp.asarray(float(p), ftype))
        HX = np.asarray(re).astype(np.complex128) + 1j * np.asarray(im)
        out.append(np.linalg.eigvalsh(HX)[:n_levels])
    return np.asarray(out)


def domain_wall_dispersion(h, D: int, ps, n_levels: int = 1,
                           iters: int = 250, k: int = 32, flip=None,
                           key=None):
    """Dispersion of TOPOLOGICAL (domain-wall / kink) excitations in a
    symmetry-broken phase: the ansatz interpolates two degenerate ground
    states, |Phi_p(B)> = sum_n e^{ipn} |.. AL1 B_n AR2 ..> with state 2
    = the on-site ``flip`` unitary (default: Pauli X, the Z2 flip of the
    ordered TFIM phase) applied to state 1.  The bond matrices are
    unchanged by an on-site unitary, so C is shared; the mixed transfer
    has |spectrum| < 1 (distinct states) and the geometric sums run
    undeflated.

    Validated against the exact TFIM fermion dispersion in the ORDERED
    phase (g < 1), where the fermions ARE the kinks
    (tests/test_excitations.py)."""
    import numpy as np

    from .tdvp import vumps_ground_state

    AL, C, _, _ = vumps_ground_state(h, D, iters=iters, k=k, key=key)
    AL, AR, C = jax.jit(mixed_gauge)(AL)
    if flip is None:
        flip = np.array([[0.0, 1.0], [1.0, 0.0]])
    fl = jnp.asarray(np.ascontiguousarray(np.asarray(flip).real))
    # state 2 = flipped state 1 (real flip assumed; X is)
    AR2 = jax.jit(
        lambda F, A: jnp.einsum("st,tij->sij", F.astype(A.dtype), A)
    )(fl, AR)
    return dispersion(h, D, ps, n_levels=n_levels, gs=(AL, AR2, C),
                      deflate=False)
