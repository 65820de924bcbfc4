"""Gen-2 brickwork circuit MPS: the direct-contraction engine.

JAX rebuild of new_tdvp/{ClassicalTDVPStripped,BrickWallMPS}.py: a
D=2 uniform MPS whose unit cell is two brickwork layers (U2 on even bonds
feeding U1 on odd bonds).  All diagrams are single jnp.einsum contractions
(XLA picks the schedule; the reference precomputed greedy paths by hand,
new_tdvp/path_calculation_for_myriad.py).

Tensor index convention matches the reference: a 2-qubit gate U reshaped
(2,2,2,2) is U[out1, out2, in1, in2].
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import CDTYPE
from ..core import lie


def param_bricks(params):
    """22 params -> (U1, U2): U1 a full 15-param SU(4), U2 a 7-param
    first-column unitary (ClassicalTDVPStripped.py:146-166)."""
    p2, p1 = params[:7], params[7:]
    U1 = lie.U4(p1)
    U2 = lie.first_column_unitary(p2)
    return U1, U2


def env_M(params):
    """6-param 2x2 environment matrix ansatz M
    (ClassicalTDVPStripped.py:140-143): Z X Z D3 X Z products."""
    a, b, c, d, e, f = (params[i] for i in range(6))

    def Zg(t):
        return jnp.array([[1.0, 0.0], [0.0, 0.0]], CDTYPE) + jnp.exp(
            1j * jnp.pi * t
        ) * jnp.array([[0.0, 0.0], [0.0, 1.0]], CDTYPE)

    def Xg(t):
        c_, s_ = jnp.cos(jnp.pi * t / 2), jnp.sin(jnp.pi * t / 2)
        return jnp.array([[1.0, 0.0], [0.0, 1.0]], CDTYPE) * c_ - 1j * s_ * jnp.array(
            [[0.0, 1.0], [1.0, 0.0]], CDTYPE
        )

    def D3(t):
        return jnp.array([[1.0, 0.0], [0.0, 0.0]], CDTYPE) * jnp.cos(t) + jnp.array(
            [[0.0, 0.0], [0.0, 1.0]], CDTYPE
        ) * jnp.sin(t)

    return Zg(b) @ Xg(c) @ Zg(d) @ D3(a) @ Xg(e) @ Zg(f)


def _planned_path(operands, out):
    """Exact minimal-flop contraction order from the native DP planner
    (qmps_tpu/native), with a greedy fallback."""
    try:
        from ..native import optimal_einsum_path

        dims = {i: 2 for t in operands for i in t}
        p = optimal_einsum_path([list(t) for t in operands], dims, list(out))
        return p[1:] if isinstance(p, list) else p
    except Exception:
        return "greedy"


_MANIFOLD_OPS = [
    [6, 7, 26, 27], [8, 9, 28, 29], [10, 11, 30, 31], [27, 28, 22, 23],
    [29, 30, 24, 25], [22, 23, 24, 25, 18, 19, 20, 21], [26, 12], [31, 17],
    [18, 19, 13, 14], [20, 21, 15, 16], [12, 13, 0, 1], [14, 15, 2, 3],
    [16, 17, 4, 5],
]
_MANIFOLD_PATH = _planned_path(_MANIFOLD_OPS, range(12))


def _t(U):
    return U.reshape(2, 2, 2, 2)


def bw_state(U1, U2, l: int):
    """Dense 2l-qubit brickwork state: U2 layer on all cells, then U1 on the
    interior bonds (BrickWallMPS.py:75-87)."""
    n = 2 * l
    psi = jnp.zeros((2**n,), U1.dtype).at[0].set(1.0)
    from .ir import apply_unitary

    for c in range(l):
        psi = apply_unitary(psi, U2, (2 * c, 2 * c + 1), n)
    for c in range(l - 1):
        psi = apply_unitary(psi, U1, (2 * c + 1, 2 * c + 2), n)
    return psi


def bricks_to_tensor_left(U1, U2) -> jnp.ndarray:
    """Left-leaning brick pair -> blocked MPS tensor A[(d d'), i, j]
    (BrickWallMPS.py:89-98)."""
    u2 = _t(U2)[..., 0, 0]  # (out1, out2) with inputs |00>
    return jnp.tensordot(u2, _t(U1), [[1], [2]]).reshape(2, 4, 2)


def bricks_to_tensor_right(U1, U2) -> jnp.ndarray:
    """Right-leaning brick pair -> blocked MPS tensor (BrickWallMPS.py:100-111)."""
    u2 = _t(U2)[..., 0, 0]
    return jnp.transpose(
        jnp.tensordot(u2, _t(U1), [[0], [3]]).reshape(2, 4, 2), [2, 1, 0]
    )


def bricks_from_tensor(A) -> tuple[jnp.ndarray, jnp.ndarray]:
    """QR + polar splitting of a 1-site MPS tensor into brickwork bricks
    (U1, U2) — the reference's ``Us_from_A``
    (new_tdvp/loschmidt_classical.py:93-141), differentiable (SVD polar +
    QR first-column completion instead of scipy polar + null_space).

    This is an APPROXIMATE initializer, as in the reference: the 2-site
    blocking of a generic injective 1-site uMPS does not lie exactly in the
    left-leaning brickwork manifold (the polar step projects), so the
    returned bricks reproduce the input state only roughly.  Use
    ``algorithms.brickwork_tdvp.compile_tensor_to_bricks`` for the
    gradient-polished warm start (overlap > 0.99 on TFIM ground states).
    """
    from ..embed.unitaries import environment_to_unitary

    B = jnp.tensordot(A, A, [[2], [1]])  # (s1, i, s2, j)
    Bm = B.transpose(1, 0, 3, 2).reshape(2, 8)  # rows = left bond
    C, Dm = jnp.linalg.qr(Bm)  # C (2, 2) unitary, Dm (2, 8)
    D44 = Dm.reshape(2, 2, 2, 2).transpose(1, 2, 0, 3).reshape(4, 4)
    u, s, vh = jnp.linalg.svd(D44)
    U1 = u @ vh  # polar unitary factor -> the U1 brick
    H = (vh.conj().T * s) @ vh  # hermitian factor, absorbed into the column
    c2 = jnp.tensordot(H.reshape(2, 2, 2, 2), C, [[2, 3], [1, 0]]).reshape(4)
    U2 = environment_to_unitary(c2)
    return U1, U2


def right_env_map(U1, U2, U1d, U2d, M) -> jnp.ndarray:
    """One application of the brickwork mixed transfer map to a 2x2 matrix M
    (RightEnvironment.circuit, ClassicalTDVPStripped.py:355-377)."""
    return jnp.einsum(
        _t(U2d), [11, 12, 10, 9],
        _t(U1d), [2, 10, 4, 5],
        M, [9, 8],
        _t(U1), [4, 5, 1, 3],
        _t(U2), [3, 8, 6, 7],
        [2, 1, 11, 12, 6, 7],
    )[:, :, 0, 0, 0, 0]


def right_env_matrix(U1, U2, U1d, U2d) -> jnp.ndarray:
    """The 4x4 matrix of the right transfer map
    (RightEnvironment.exact_environment_circuit,
    ClassicalTDVPStripped.py:399-422)."""
    return jnp.einsum(
        _t(U2d), [4, 5, 8, 7],
        _t(U1d), [3, 8, 9, 10],
        _t(U1), [9, 10, 0, 11],
        _t(U2), [11, 6, 1, 2],
        [1, 2, 4, 5, 3, 0, 7, 6],
    )[0, 0, 0, 0, :, :, :, :].reshape(4, 4)


def left_env_matrix(U1, U2, U1d, U2d) -> jnp.ndarray:
    """The 4x4 matrix of the left transfer map
    (LeftEnvironment.exact_environment_circuit,
    ClassicalTDVPStripped.py:331-339)."""
    return jnp.einsum(
        _t(U2d), [3, 4, 7, 8],
        _t(U1d), [8, 5, 9, 10],
        _t(U1), [9, 10, 11, 2],
        _t(U2), [6, 11, 0, 1],
        [0, 1, 4, 3, 2, 5, 6, 7],
    )[0, 0, 0, 0, :, :, :, :].reshape(4, 4)


def exact_right_env(U1, U2, U1d, U2d):
    """Dominant (eta, r) of the right transfer map
    (ClassicalTDVPStripped.py:424-431) via the differentiable dense solver."""
    from ..mps.transfer import dominant_eig_dense

    Mmat = right_env_matrix(U1, U2, U1d, U2d)
    eta, v = dominant_eig_dense(Mmat)
    return eta, v.reshape(2, 2)


def exact_left_env(U1, U2, U1d, U2d):
    from ..mps.transfer import dominant_eig_dense

    Mmat = left_env_matrix(U1, U2, U1d, U2d)
    eta, v = dominant_eig_dense(Mmat)
    return eta, v.reshape(2, 2)


def env_from_M(M, U2, U2d) -> jnp.ndarray:
    """Convert a mid-bond environment matrix M to the cell-boundary right
    environment by the half-cell U2 contraction (the reference's
    find_env_from_M, new_tdvp/loschmidt_classical.py:318-336).  The
    conversion damps M-ansatz error components off the dominant eigenspace:
    measured over the 100-run ensemble, the boundary environments agree
    with the exact solve ~4x better than the raw M's do."""
    return jnp.einsum(
        _t(U2d), [2, 3, 5, 7],
        M, [7, 6],
        _t(U2), [4, 6, 0, 1],
        [0, 1, 2, 3, 4, 5],
    )[0, 0, 0, 0, :, :]


def manifold_overlap(U1, U2, U1d, U2d, Mr, Ml, W) -> jnp.ndarray:
    """The 13-tensor TDVP overlap contraction <psi(U')| Ml (x) W (x) Mr |psi(U)>
    (ManifoldOverlap.circuit, ClassicalTDVPStripped.py:239-275) — the gen-2
    hot kernel (2.26 ms numpy / 0.87 ms jax-jit in the reference,
    new_tdvp/output_results.txt)."""
    W8 = W.reshape(2, 2, 2, 2, 2, 2, 2, 2)
    out = jnp.einsum(
        _t(U2d), [6, 7, 26, 27],
        _t(U2d), [8, 9, 28, 29],
        _t(U2d), [10, 11, 30, 31],
        _t(U1d), [27, 28, 22, 23],
        _t(U1d), [29, 30, 24, 25],
        W8, [22, 23, 24, 25, 18, 19, 20, 21],
        Ml, [26, 12],
        Mr, [31, 17],
        _t(U1), [18, 19, 13, 14],
        _t(U1), [20, 21, 15, 16],
        _t(U2), [12, 13, 0, 1],
        _t(U2), [14, 15, 2, 3],
        _t(U2), [16, 17, 4, 5],
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
        optimize=_MANIFOLD_PATH,
    )
    return out[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]


def expectation_2site(U1, U2, O) -> jnp.ndarray:
    """<O> for a 2-qubit operator on the 4-qubit brickwork window
    (OverlapCalculator.qbt2_exp_val, ClassicalTDVPStripped.py:511-544)."""
    U1d, U2d = _t(U1.conj().T), _t(U2.conj().T)
    O4 = O.reshape(2, 2, 2, 2)
    out = jnp.einsum(
        U2d, [4, 5, 8, 9],
        U2d, [6, 7, 10, 11],
        U1d, [9, 10, 12, 13],
        O4, [12, 13, 14, 15],
        _t(U1), [14, 15, 16, 17],
        _t(U2), [8, 16, 0, 1],
        _t(U2), [17, 11, 2, 3],
        [4, 5, 6, 7, 0, 1, 2, 3],
        optimize='greedy',
    )
    return out[0, 0, 0, 0, 0, 0, 0, 0].real


def expectation_4site(U1, U2, O) -> jnp.ndarray:
    """<O> for a 4-qubit operator on the 6-qubit brickwork window
    (OverlapCalculator.qbt4_exp_val, ClassicalTDVPStripped.py:464-496)."""
    U1d, U2d = _t(U1.conj().T), _t(U2.conj().T)
    O8 = O.reshape(2, 2, 2, 2, 2, 2, 2, 2)
    out = jnp.einsum(
        U2d, [6, 7, 12, 13],
        U2d, [8, 9, 14, 15],
        U2d, [10, 11, 16, 17],
        U1d, [13, 14, 18, 19],
        U1d, [15, 16, 20, 21],
        O8, [18, 19, 20, 21, 22, 23, 24, 25],
        _t(U1), [22, 23, 26, 27],
        _t(U1), [24, 25, 28, 29],
        _t(U2), [12, 26, 0, 1],
        _t(U2), [27, 28, 2, 3],
        _t(U2), [29, 17, 4, 5],
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
        optimize='greedy',
    )
    return out[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0].real
