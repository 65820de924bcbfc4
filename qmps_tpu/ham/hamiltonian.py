"""Pauli-string Hamiltonians (reference: qmps/ground_state.py:66-118).

``Hamiltonian({'ZZ': -1, 'X': l})`` is the TFIM; single-character strings are
split symmetrically across the bond exactly as the reference does
(ground_state.py:73-80), so matrices agree entry-for-entry.
"""
from __future__ import annotations

from itertools import product
from typing import Dict

import jax.numpy as jnp

from ..config import CDTYPE
from ..core.paulis import PAULI, kron_all


class Hamiltonian:
    """Two-site Hamiltonian as a dict of Pauli strings -> couplings."""

    def __init__(self, strings: Dict[str, float] | None = None):
        self.strings = dict(strings) if strings is not None else None
        if self.strings is not None:
            for key, val in list(self.strings.items()):
                if len(key) == 1:
                    self.strings["I" + key] = self.strings.get("I" + key, 0) + val / 2
                    self.strings[key + "I"] = self.strings.get(key + "I", 0) + val / 2
                    del self.strings[key]

    def to_matrix(self):
        """Dense 4x4 matrix as a HOST numpy array.

        Host-side on purpose: Hamiltonian matrices are baked into jitted
        objectives as constants (host arrays embed as literals).
        Traced couplings are not supported here — use e.g.
        parallel.sweep.tfim_matrix for coupling-sweep tracing.
        """
        import numpy as np

        from ..config import NP_CDTYPE

        assert self.strings is not None
        h = np.zeros((4, 4), NP_CDTYPE)
        for js, J in self.strings.items():
            term = PAULI[js[0]]
            for c in js[1:]:
                term = np.kron(term, PAULI[c])
            h = h + complex(J) * term
        return h

    def measure_energy(self, key, psi, qubits=(1, 2), shots: int = 300000):
        """Finite-shot Pauli-string energy estimate on a prepared state
        (reference qmps/ground_state.py:97-108)."""
        from ..objectives.sampling import measure_energy as _me

        return _me(key, self.strings, psi, qubits=qubits, shots=shots)

    def calculate_energy(self, psi, loc: int = 1):
        """Exact <H> on adjacent qubits (loc, loc+1) of a prepared state
        (reference qmps/ground_state.py:110-118)."""
        from ..core.paulis import embed

        n = int(psi.shape[0]).bit_length() - 1
        H = embed(self.to_matrix(), loc, n)
        return jnp.real(psi.conj() @ (H @ psi))

    @classmethod
    def from_matrix(cls, mat) -> "Hamiltonian":
        """Project a 4x4 matrix back onto Pauli strings
        (ground_state.py:90-95)."""
        mat = jnp.asarray(mat, CDTYPE)
        keys = list(PAULI)
        strings = {}
        for a, b in product(keys, keys):
            c = jnp.trace(kron_all([PAULI[a], PAULI[b]]) @ mat) / 4.0
            if a + b != "II":
                strings[a + b] = complex(c)
        out = cls.__new__(cls)
        out.strings = strings
        return out


def as_host_matrix(H):
    """Hamiltonian | array -> host numpy matrix when possible (jit closures
    capture host constants)."""
    import numpy as np

    if isinstance(H, Hamiltonian):
        return H.to_matrix()
    # an MPO with range <= 2 reduces exactly to its bond matrix (so the
    # circuit-TDVP steppers, whose Trotter gate is two-site, accept MPOs
    # too); genuinely longer-range MPOs raise there — route those through
    # mps.tdvp.Trajectory(A0, h=mpo), whose environments handle any range
    from ..mps.mpo import MPO

    if isinstance(H, MPO):
        return H.two_site_matrix()
    if isinstance(H, np.ndarray):
        return H
    return H


def tfim(g: float) -> Hamiltonian:
    """Transverse-field Ising H = -ZZ + g X (per-site field split over bonds)."""
    return Hamiltonian({"ZZ": -1.0, "X": g})


def xy() -> Hamiltonian:
    """XY model (scripts/bond_dimension.py:18)."""
    return Hamiltonian({"XX": 1.0, "YY": 1.0})


def heisenberg(J: float = 1.0) -> Hamiltonian:
    """Isotropic Heisenberg (new_tdvp/HeisenbergHam.py:24-25)."""
    return Hamiltonian({"XX": J, "YY": J, "ZZ": J})


def xxz(delta: float, J: float = 1.0) -> Hamiltonian:
    """Anisotropic Heisenberg H = J sum (XX + YY + delta ZZ): critical
    for |delta| <= 1, gapped Neel-ordered (spontaneously broken Z2
    sublattice symmetry) for delta > 1 — the minimal model whose ground
    state NEEDS the two-site unit cell machinery (block_two_site)."""
    return Hamiltonian({"XX": J, "YY": J, "ZZ": J * delta})


def sublattice_rotate(h):
    """h' = (I (x) R) h (I (x) R)^dag with R = exp(-i pi Y / 2): the
    odd-site sublattice rotation (X -> -X, Z -> -Z, Y -> Y).

    Antiferromagnetic chains (XY, Heisenberg) have Neel-structured
    ground states whose SINGLE-SITE uMPS description makes fixed-point
    solvers oscillate between the two sublattice patterns — VUMPS stalls
    at gradient norm O(1) on the bare Hamiltonians.  In the rotated
    frame the ground state is smoothly translation invariant and the
    same solves converge to machine precision (measured: Heisenberg
    D=16 vs the Bethe value to 1.9e-4 at grad 2e-14; bare form stalls
    at err 3.6e-3 / grad 1.0).  Energies are frame-invariant; operators
    measured on the rotated state must be rotated on odd sites.

    For parity-symmetric h (all the models here) the even-odd and
    odd-even bond rotations agree, so ONE rotated 2-site matrix serves
    the uniform chain.  Returns a HOST numpy matrix (see to_matrix)."""
    import numpy as np

    h = np.asarray(as_host_matrix(h))
    R = np.array([[0.0, -1.0], [1.0, 0.0]])  # exp(-i pi Y / 2), real
    IR = np.kron(np.eye(2), R)
    out = IR @ h @ IR.T.conj()
    return out.real if np.allclose(out.imag, 0) else out


def block_two_site(h, h1=None):
    """Blocked two-CELL Hamiltonian for a 2-site unit cell.

    Sites ...|s0 s1|s2 s3|... are grouped into cells of two; a
    nearest-neighbour chain H = sum_i h_{i,i+1} becomes a
    nearest-neighbour chain of d^2-dimensional cells with the two-cell
    bond term

        h_blk = I_d (x) h (x) I_d              (the inter-cell bond)
              + (h (x) I_{d^2} + I_{d^2} (x) h) / 2   (intra-cell, split
                half-left / half-right so each cell's internal bond is
                counted exactly once in sum_k h_blk(c_k, c_{k+1})).

    An optional ONE-site term h1 (d x d, H1 = sum_i h1_i) is likewise
    absorbed: per cell it is h1 (x) I + I (x) h1, spread half onto each
    adjoining blocked bond.  The blocked energy density (per cell) is
    exactly TWICE the per-site density of the original chain.

    This is how the single-site VUMPS/TDVP machinery reaches states
    with a two-site unit cell (Neel-ordered antiferromagnets, dimerized
    phases) WITHOUT a multi-site solver: the blocked chain is uniform
    even when the original state is only 2-periodic.  Complementary to
    `sublattice_rotate` (a frame change that needs h's parity symmetry;
    blocking needs nothing).  Returns a HOST numpy matrix."""
    import numpy as np

    h = np.asarray(as_host_matrix(h))
    d = int(round(h.shape[0] ** 0.5))
    Id, Id2 = np.eye(d), np.eye(d * d)
    out = np.kron(Id, np.kron(h, Id)) + 0.5 * (
        np.kron(h, Id2) + np.kron(Id2, h)
    )
    if h1 is not None:
        h1 = np.asarray(as_host_matrix(h1))
        cell1 = np.kron(h1, Id) + np.kron(Id, h1)
        out = out + 0.5 * (np.kron(cell1, Id2) + np.kron(Id2, cell1))
    if not np.iscomplexobj(out):
        return out
    # realify only when the imaginary part is pure roundoff RELATIVE to
    # the matrix scale — np.allclose's absolute 1e-8 would silently
    # delete a genuinely weak coupling (wrong Hamiltonian, plausible
    # results; same guard class as itebd_gs_energy's)
    scale = max(1.0, float(np.max(np.abs(out))))
    return out.real if np.max(np.abs(out.imag)) <= 1e-12 * scale else out


def scars_H(mu: float):
    """4-site PXP scars Hamiltonian (scars.py:22-25); returns the dense
    16x16 matrix as HOST numpy (see to_matrix)."""
    import numpy as np

    P = np.array([[0, 0], [0, 1]], dtype=complex)
    Xm = np.array([[0, 1], [1, 0]], dtype=complex)
    n = np.array([[1, 0], [0, 0]], dtype=complex)
    I = np.eye(2, dtype=complex)

    def mt(ops):
        out = ops[0]
        for o in ops[1:]:
            out = np.kron(out, o)
        return out

    from ..config import NP_CDTYPE

    H = 0.5 * (mt([I, P, Xm, P]) + mt([P, Xm, P, I])) + (mu / 4) * (
        mt([I, I, I, n]) + mt([I, I, n, I]) + mt([I, n, I, I]) + mt([n, I, I, I])
    )
    return H.astype(NP_CDTYPE)
