"""The reference's circuit-identity battery (qmps/new_time_evolve.py:53-184,
duplicated at scripts/loschmidt.py:71-202), rebuilt on the JAX stack.

These identities tie *everything* together: Bell-pair readout of embedded
environments, mixed-transfer fixed points, state-unitary embeddings and the
circuit compiler.  Each asserts a circuit amplitude against a closed-form
transfer-matrix quantity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmps_tpu.core import gates as g
from qmps_tpu.core.paulis import I2, X, Y, Z
from qmps_tpu.circuits.ir import circuit_state, dagger_ops
from qmps_tpu.embed import (
    put_env_on_left_site,
    put_env_on_right_site,
    tensor_to_unitary,
)
from qmps_tpu.mps.imps import Map, iMPS, merge
from qmps_tpu.objectives.overlap import (
    hadamard_test_amplitude,
    tdvp_objective,
    tdvp_objective_circuit,
)

PAULIS = [I2, X, Y, Z]


@pytest.fixture(scope="module")
def states():
    A = iMPS.random(jax.random.PRNGKey(0), 2, 2).left_canonicalise()[0]
    B = iMPS.random(jax.random.PRNGKey(1), 2, 2).left_canonicalise()[0]
    return A, B


def amp(ops, n):
    return complex(circuit_state(ops, n)[0])


class TestEnvReadoutIdentities:
    def test_right_env_readout(self, states):
        """2 psi[0] = Tr(g r): Bell pair + R + g (new_time_evolve.py:100-108)."""
        A, B = states
        x, r = Map(A, B).right_fixed_point()
        R = put_env_on_left_site(r)
        for P in PAULIS:
            ops = [
                (g.H, (1,)),
                (g.CNOT, (1, 2)),
                (R, (2, 3)),
                (P, (1,)),
                (g.CNOT, (1, 2)),
                (g.H, (1,)),
            ]
            got = 2 * amp(ops, 4)
            want = complex(jnp.trace(P @ r))
            np.testing.assert_allclose(got, want, atol=1e-8)

    def test_right_env_one_transfer(self, states):
        """2 psi[0] = x Tr(g r) after one U ... U'^dag sandwich
        (new_time_evolve.py:110-119)."""
        A, B = states
        x, r = Map(A, B).right_fixed_point()
        U = tensor_to_unitary(A)
        Ud = tensor_to_unitary(B)
        R = put_env_on_left_site(r)
        for P in PAULIS:
            ops = (
                [
                    (g.H, (1,)),
                    (g.CNOT, (1, 2)),
                    (U, (0, 1)),
                    (R, (2, 3)),
                    (P, (0,)),
                ]
                + dagger_ops([(Ud, (0, 1))])
                + [(g.CNOT, (1, 2)), (g.H, (1,))]
            )
            got = 2 * amp(ops, 4)
            want = complex(x * jnp.trace(P @ r))
            np.testing.assert_allclose(got, want, atol=1e-8)

    def test_right_env_two_transfers(self, states):
        """2 psi[0] = x^2 Tr(g r) (new_time_evolve.py:121-134)."""
        A, B = states
        x, r = Map(A, B).right_fixed_point()
        U = tensor_to_unitary(A)
        Ud = tensor_to_unitary(B)
        R = put_env_on_left_site(r)
        for P in PAULIS:
            ops = (
                [
                    (g.H, (2,)),
                    (g.CNOT, (2, 3)),
                    (U, (1, 2)),
                    (U, (0, 1)),
                    (R, (3, 4)),
                    (P, (0,)),
                ]
                + dagger_ops([(Ud, (0, 1))])
                + dagger_ops([(Ud, (1, 2))])
                + [(g.CNOT, (2, 3)), (g.H, (2,))]
            )
            got = 2 * amp(ops, 5)
            want = complex(x**2 * jnp.trace(P @ r))
            np.testing.assert_allclose(got, want, atol=1e-8)

    def test_left_env_readout(self, states):
        """2 psi[0] = Tr(g l.conj()) for the left embedding
        (new_time_evolve.py:137-146)."""
        A, B = states
        _, l = Map(A, B).left_fixed_point()
        L = put_env_on_right_site(l.conj().T)
        for P in PAULIS:
            ops = [
                (g.H, (1,)),
                (g.CNOT, (1, 2)),
                (L, (0, 1)),
                (P, (2,)),
                (g.CNOT, (1, 2)),
                (g.H, (1,)),
            ]
            got = 2 * amp(ops, 3)
            want = complex(jnp.trace(P @ l.conj()))
            np.testing.assert_allclose(got, want, atol=1e-8)

    def test_left_env_one_transfer(self, states):
        """2 psi[0] = x Tr(g l.conj()) (new_time_evolve.py:148-159)."""
        A, B = states
        x, _ = Map(A, B).right_fixed_point()
        _, l = Map(A, B).left_fixed_point()
        U = tensor_to_unitary(A)
        Ud = tensor_to_unitary(B)
        L = put_env_on_right_site(l.conj().T)
        for P in PAULIS:
            ops = (
                [
                    (g.H, (2,)),
                    (g.CNOT, (2, 3)),
                    (U, (1, 2)),
                    (L, (0, 1)),
                    (P, (3,)),
                ]
                + dagger_ops([(Ud, (1, 2))])
                + [(g.CNOT, (2, 3)), (g.H, (2,))]
            )
            got = 2 * amp(ops, 4)
            want = complex(x * jnp.trace(P @ l.conj()))
            np.testing.assert_allclose(got, want, atol=1e-8)

    def test_full_sandwich(self, states):
        """2 psi[0] = x^2 Tr(l^dag r): the complete 6-qubit overlap circuit
        (new_time_evolve.py:174-184)."""
        A, B = states
        x, r = Map(A, B).right_fixed_point()
        _, l = Map(A, B).left_fixed_point()
        U = tensor_to_unitary(A)
        Ud = tensor_to_unitary(B)
        R = put_env_on_left_site(r)
        L = put_env_on_right_site(l.conj().T)
        ops = (
            [
                (g.H, (3,)),
                (g.CNOT, (3, 4)),
                (U, (2, 3)),
                (U, (1, 2)),
                (L, (0, 1)),
                (R, (4, 5)),
            ]
            + dagger_ops([(Ud, (1, 2))])
            + dagger_ops([(Ud, (2, 3))])
            + [(g.CNOT, (3, 4)), (g.H, (3,))]
        )
        got = 2 * amp(ops, 6)
        want = complex(x**2 * jnp.trace(l.conj().T @ r))
        np.testing.assert_allclose(got, want, atol=1e-8)


class TestTDVPObjective:
    def test_circuit_equals_fast_path(self, states):
        """The reference's circuit objective equals -|x| (fast path), since
        sqrt(2) psi[0] = x^2 for the normalized fixed point."""
        A, B = states
        from qmps_tpu.ham import Hamiltonian
        from jax.scipy.linalg import expm

        W = expm(-1j * Hamiltonian({"ZZ": -1.0, "X": 1.0}).to_matrix() * 0.05)
        fast = float(tdvp_objective(A, B, W))
        circ = float(tdvp_objective_circuit(A, B, W))
        np.testing.assert_allclose(fast, circ, atol=1e-8)

    def test_amplitude_is_x(self, states):
        """2 psi[0] = x Tr(r^dag r) = x for the Bell-form TDVP circuit."""
        A, B = states
        W = jnp.eye(4, dtype=jnp.complex128)
        from qmps_tpu.objectives.overlap import mixed_transfer_with_gate
        from qmps_tpu.mps import transfer as tr

        WAA, BB = mixed_transfer_with_gate(A, B, W)
        x, r = tr.right_fixed_point(WAA, BB)
        got = complex(hadamard_test_amplitude(A, B, W, r))
        np.testing.assert_allclose(got, complex(x), atol=1e-8)

    def test_identity_gate_self_overlap_is_one(self, states):
        """W = I, B = A: perfect overlap, objective = -1."""
        A, _ = states
        W = jnp.eye(4, dtype=jnp.complex128)
        np.testing.assert_allclose(float(tdvp_objective(A, A, W)), -1.0, atol=1e-9)
