"""Independent classical baselines: finite-chain ED and iTEBD(chi) TFIM.

The reference validates its D=2 variational energies against tenpy infinite
DMRG at chi_max=2 (scripts/ground_state_finding.py:19-68,
scripts/classical_ground_states.py:4-91).  That baseline matters because it
bounds the *D=2 manifold optimum*, which the exact integral does not: the
integral only bounds the physical energy, so it cannot distinguish "our
optimizer found the D=2 optimum" from "it got close to the exact energy".

tenpy is not available here, so this module provides the same two oracles
from scratch, deliberately in pure numpy/scipy (an INDEPENDENT code path
from the jax framework under test):

- ``tfim_ed_energy``: sparse-Lanczos ground energy of the finite periodic
  chain (exact diagonalization; L = 14 reaches the thermodynamic limit to
  ~1e-6 away from criticality, ~1e-3 at g = 1).
- ``itebd_gs_energy``: imaginary-time iTEBD at fixed bond dimension chi —
  at chi = 2 this converges to the D=2 manifold optimum, the same quantity
  the reference's chi_max=2 DMRG computes.
"""
from __future__ import annotations

import numpy as np

_X = np.array([[0.0, 1.0], [1.0, 0.0]])
_Z = np.array([[1.0, 0.0], [0.0, -1.0]])
_I = np.eye(2)


def tfim_ed_energy(L: int = 14, g: float = 1.0, periodic: bool = True) -> float:
    """Ground-state energy per site of H = -sum Z_i Z_{i+1} - g sum X_i on
    an L-site chain, via sparse Lanczos (scipy eigsh on a LinearOperator —
    no 2^L x 2^L dense matrix is ever built)."""
    import scipy.sparse.linalg as spla

    dim = 2**L

    def matvec(v):
        w = np.zeros_like(v)
        psi = v.reshape((2,) * L)
        # -g X_i: flip bit i
        for i in range(L):
            w -= g * np.swapaxes(np.swapaxes(psi, 0, i)[::-1], 0, i).reshape(-1)
        # -Z_i Z_{i+1}: diagonal
        return w

    # diagonal part precomputed once: -sum_i z_i z_{i+1}
    bits = ((np.arange(dim)[:, None] >> np.arange(L - 1, -1, -1)) & 1).astype(
        np.int64
    )
    z = 1 - 2 * bits  # (+1 for 0, -1 for 1)
    nb = L if periodic else L - 1
    diag = -np.sum(
        z * np.roll(z, -1, axis=1) if periodic else z[:, :-1] * z[:, 1:], axis=1
    ).astype(np.float64)
    assert diag.shape == (dim,) and nb > 0

    def full_matvec(v):
        return matvec(v) + diag * v

    op = spla.LinearOperator((dim, dim), matvec=full_matvec, dtype=np.float64)
    w = spla.eigsh(op, k=1, which="SA", return_eigenvectors=False, maxiter=5000)
    return float(w[0]) / L


def itebd_gs_energy(
    g: float | None = None,
    chi: int = 2,
    dts=(0.1, 0.01, 0.001),
    sweeps_per_dt: int = 2000,
    return_state: bool = False,
    h2: "np.ndarray | None" = None,
):
    """Ground energy per bond on the chi-dimensional uMPS manifold via
    imaginary-time iTEBD (Vidal canonical form, 2-site updates with SVD
    truncation to chi, A/B sublattice alternation, decreasing Trotter step).

    By default the Hamiltonian is TFIM at field g; pass ``h2`` (a 4x4
    two-site matrix, e.g. ``heisenberg().to_matrix()``) for any other
    nearest-neighbour model.  At chi=2 with TFIM this reproduces the
    reference's tenpy DMRG chi_max=2 baseline: the best energy available
    to ANY D=2 matrix product state (with a 2-site unit cell).
    """
    import scipy.linalg as sla

    if h2 is not None:
        h2 = np.asarray(h2)
        if np.iscomplexobj(h2):
            # a silent complex->float cast would drop the imaginary part
            # (wrong Hamiltonian, plausible-looking energy); real-valued
            # Hermitian inputs stored complex are fine
            if np.max(np.abs(h2.imag)) > 1e-12:
                raise ValueError(
                    "itebd_gs_energy: h2 has imaginary entries; this real "
                    "iTEBD supports real-representable Hamiltonians only"
                )
            h2 = h2.real
        h = np.asarray(h2, dtype=float)
    else:
        if g is None:
            raise ValueError("pass g (TFIM field) or h2 (explicit 4x4)")
        h = -np.kron(_Z, _Z) - g * (np.kron(_X, _I) + np.kron(_I, _X)) / 2.0

    rng = np.random.default_rng(0)
    # Vidal form: Gammas[s] (chi, 2, chi), lambdas[s] (chi,)
    G = [rng.normal(size=(chi, 2, chi)) + 0.1 for _ in range(2)]
    lam = [np.ones(chi) / np.sqrt(chi) for _ in range(2)]

    def bond_update(A, la, lb, lc, U):
        """One 2-site imaginary-time update: theta = lb Ga la Gb lc, apply
        U, SVD back, truncate to chi."""
        Ga, Gb = A
        theta = np.einsum(
            "a,aib,b,bjc,c->aijc", lb, Ga, la, Gb, lc, optimize=True
        )
        theta = np.einsum("ijkl,akld->aijd", U.reshape(2, 2, 2, 2), theta)
        m = theta.reshape(chi * 2, 2 * chi)
        u, s, vh = np.linalg.svd(m, full_matrices=False)
        u, s, vh = u[:, :chi], s[:chi], vh[:chi]
        s = s / np.linalg.norm(s)
        Ga_new = np.einsum("a,aib->aib", 1.0 / np.clip(lb, 1e-12, None), u.reshape(chi, 2, chi))
        Gb_new = np.einsum("bjc,c->bjc", vh.reshape(chi, 2, chi), 1.0 / np.clip(lc, 1e-12, None))
        return Ga_new, Gb_new, s

    for dt in dts:
        U = sla.expm(-dt * h)
        for _ in range(sweeps_per_dt):
            # even bond (A-B), then odd bond (B-A)
            G[0], G[1], lam[0] = bond_update(
                (G[0], G[1]), lam[0], lam[1], lam[1], U
            )
            G[1], G[0], lam[1] = bond_update(
                (G[1], G[0]), lam[1], lam[0], lam[0], U
            )

    # energy: expectation of h on both bonds of the 2-site cell
    def bond_energy(Ga, Gb, la, lb, lc):
        theta = np.einsum(
            "a,aib,b,bjc,c->aijc", lb, Ga, la, Gb, lc, optimize=True
        )
        n = np.einsum("aijc,aijc->", theta, theta.conj())
        e = np.einsum(
            "aijc,ijkl,aklc->", theta.conj(), h.reshape(2, 2, 2, 2), theta
        )
        return float((e / n).real)

    e_even = bond_energy(G[0], G[1], lam[0], lam[1], lam[1])
    e_odd = bond_energy(G[1], G[0], lam[1], lam[0], lam[0])
    energy = (e_even + e_odd) / 2
    if return_state:
        return energy, (G, lam)
    return energy


def nnn_ising_ed_energy(
    L: int = 14, g: float = 0.5, J2: float = 0.2, J1: float = 1.0,
    periodic: bool = True,
) -> float:
    """Ground-state energy per site of the next-nearest-neighbour Ising
    chain H = -J1 sum Z_i Z_{i+1} - J2 sum Z_i Z_{i+2} - g sum X_i, via
    sparse Lanczos — the oracle for the MPO layer's beyond-two-site
    models (mps/mpo.mpo_nnn_ising), which no two-site ``h2`` can express
    (so `ed_gs_energy` cannot cover it)."""
    import scipy.sparse.linalg as spla

    dim = 2**L

    def flips(v):
        w = np.zeros_like(v)
        psi = v.reshape((2,) * L)
        for i in range(L):
            w -= g * np.swapaxes(np.swapaxes(psi, 0, i)[::-1], 0, i).reshape(-1)
        return w

    bits = ((np.arange(dim)[:, None] >> np.arange(L - 1, -1, -1)) & 1).astype(
        np.int64
    )
    z = 1 - 2 * bits
    if periodic:
        diag = -J1 * np.sum(z * np.roll(z, -1, axis=1), axis=1) - J2 * np.sum(
            z * np.roll(z, -2, axis=1), axis=1
        )
    else:
        diag = -J1 * np.sum(z[:, :-1] * z[:, 1:], axis=1) - J2 * np.sum(
            z[:, :-2] * z[:, 2:], axis=1
        )
    diag = diag.astype(np.float64)

    op = spla.LinearOperator(
        (dim, dim), matvec=lambda v: flips(v) + diag * v, dtype=np.float64
    )
    w = spla.eigsh(op, k=1, which="SA", return_eigenvectors=False, maxiter=5000)
    return float(w[0]) / L


def ed_gs_energy(h2, L: int = 14, periodic: bool = True) -> float:
    """Ground-state energy per site of H = sum_i h2_{i,i+1} for an
    ARBITRARY Hermitian two-site term h2 ((d^2, d^2), bra-row
    convention), via sparse Lanczos on an L-site chain — the generic
    companion to the TFIM-specific `tfim_ed_energy` (same independent
    numpy/scipy code path, no jax).

    Finite-size accuracy is GAP- and STRUCTURE-dependent, not a fixed
    figure: gapped TFIM reaches the thermodynamic limit to ~1e-6 at
    L=14, but the Neel-ordered XXZ phase converges slowly (measured
    1.2e-2 at L=14, 7.8e-3 at L=16 for delta=2 vs the Yang-Yang value —
    periodic rings gain energy from the cat-state splitting of the
    broken sublattice symmetry).  For symmetry-broken phases prefer the
    integrable oracles (`exact.xxz_gs_energy`) or treat ed_gs_energy as
    a LOWER bracket at finite L."""
    import scipy.sparse.linalg as spla

    h2 = np.asarray(h2)
    h2 = h2.astype(np.complex128 if np.iscomplexobj(h2) else np.float64)
    d = int(round(h2.shape[0] ** 0.5))
    h4 = h2.reshape(d, d, d, d)
    dim = d**L
    bonds = [(i, i + 1) for i in range(L - 1)]
    if periodic:
        bonds.append((L - 1, 0))

    def matvec(v):
        psi = v.reshape((d,) * L)
        w = np.zeros_like(psi)
        for i, j in bonds:
            t = np.moveaxis(psi, (i, j), (0, 1))
            t = np.tensordot(h4, t, axes=([2, 3], [0, 1]))
            w += np.moveaxis(t, (0, 1), (i, j))
        return w.reshape(-1)

    op = spla.LinearOperator((dim, dim), matvec=matvec, dtype=h2.dtype)
    w = spla.eigsh(op, k=1, which="SA", return_eigenvectors=False,
                   maxiter=5000)
    return float(w[0]) / L


def heisenberg_exact_energy(J: float = 1.0) -> float:
    """Bethe-ansatz ground energy per bond of the infinite spin-1/2
    Heisenberg chain in the PAULI convention H = J sum (XX + YY + ZZ):
    E/bond = J (1 - 4 ln 2) (Hulthen 1938; the S.S-convention value
    1/4 - ln 2 times 4).  The oracle for new_tdvp/HeisenbergHam.py:24-25
    workloads."""
    return J * (1.0 - 4.0 * np.log(2.0))


def host_energy_d2(A, h) -> float:
    """f64 host-numpy uMPS energy of a single left-canonical D = 2 tensor
    against a two-site Hamiltonian matrix — the independent validation
    column used by the bench and chip_smoke.py (a device-side f32 energy
    readout can dip below the exact value near criticality; a REPORTED
    error must be one the returned tensor achieves in exact arithmetic).

    Mirrors objectives.energy.energy_exact_env from the tensor (verified
    to 1e-16 on CPU); dense numpy eig for the right fixed point.
    """
    A = np.asarray(A).astype(np.complex128)
    AA = np.einsum("sik,tkj->stij", A, A).reshape(4, 2, 2)
    E = np.einsum("sik,sjl->ijkl", AA, AA.conj()).reshape(4, 4)
    w, vv = np.linalg.eig(E)
    r = vv[:, np.argmax(w.real)].reshape(2, 2)
    r = (r + r.conj().T) / 2
    r = r / np.trace(r)
    return float(
        np.einsum("ts,sij,jk,tik->", np.asarray(h, np.complex128), AA, r, AA.conj()).real
    )
