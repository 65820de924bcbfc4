"""Hardware-native (sqrt-iSWAP) gate compilations for Google-style devices.

JAX rebuild of experiments/Jamie.py:13-168: each gate is a dense
unitary composed through the circuit compiler, so the whole native-gate
calibration stack is jittable and differentiable.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import gates as g
from ..core.paulis import X, Y
from .ir import circuit_unitary


def K_gate(theta):
    """K(theta): number-conserving 2-qubit rotation from two sqrt-iSWAPs
    (experiments/Jamie.py:38-55); equals exp(-i theta (XX+YY)/2) up to frame."""
    ops = [
        (g.rz(-jnp.pi / 4), (0,)),
        (g.rz(jnp.pi / 4), (1,)),
        (g.SQRT_ISWAP, (0, 1)),
        (g.rz(theta), (0,)),
        (g.rz(-theta), (1,)),
        (g.SQRT_ISWAP_INV, (0, 1)),
        (g.rz(jnp.pi / 4), (0,)),
        (g.rz(-jnp.pi / 4), (1,)),
    ]
    return circuit_unitary(ops, 2)


def expYY_gate(gamma):
    """exp(i gamma YY) from K gates (experiments/Jamie.py:57-70)."""
    ops = [
        (K_gate(gamma), (0, 1)),
        (X, (1,)),
        (K_gate(-gamma), (0, 1)),
        (X, (1,)),
    ]
    return circuit_unitary(ops, 2)


def V_env_gate(params):
    """3-param hardware-native environment ansatz (experiments/Jamie.py:72-86)."""
    gamma, psi, phi = params[0], params[1], params[2]
    ops = [
        (expYY_gate(gamma), (0, 1)),
        (g.rx(psi), (1,)),
        (g.rz(phi), (1,)),
    ]
    return circuit_unitary(ops, 2)


def CPHASE_gate(phi, alpha, xi1, xi2):
    """CPHASE from two sqrt-iSWAPs (experiments/Jamie.py:88-109)."""
    ops = [
        (g.rz(-phi / 2), (0,)),
        (g.rz(-phi / 2), (1,)),
        (g.rx(xi1), (0,)),
        (g.rx(xi2), (1,)),
        (g.SQRT_ISWAP_INV, (0, 1)),
        (g.rx(-2 * alpha), (0,)),
        (g.SQRT_ISWAP_INV, (0, 1)),
        (g.rx(xi1), (0,)),
        (g.rx(-xi2), (1,)),
    ]
    return circuit_unitary(ops, 2)


def TFIM_trotter_gate(J, gval, xi1, xi2, alpha):
    """One TFIM Trotter step in the native gate set
    (experiments/Jamie.py:121-146)."""
    ops = [
        (Y, (0,)),
        (Y, (1,)),
        (K_gate(J), (0, 1)),
        (X, (1,)),
        (K_gate(J), (0, 1)),
        (X, (0,)),
        (CPHASE_gate(gval, alpha, xi1, xi2), (0, 1)),
        (X, (0,)),
        (X, (1,)),
        (CPHASE_gate(gval, alpha, xi1, xi2), (0, 1)),
        (Y, (0,)),
        (Y, (1,)),
    ]
    return circuit_unitary(ops, 2)


def right_environment_gate(params):
    """3-param right-environment ansatz (experiments/Jamie.py:148-167)."""
    th, psi, phi = params[0], params[1], params[2]
    ops = [
        (g.rz(psi), (1,)),
        (g.rx(phi), (1,)),
        (g.rx(th), (0,)),
        (g.SWAP @ g.CNOT @ g.SWAP, (0, 1)),  # CNOT controlled on qubit 1
        (g.rx(th), (0,)),
        (g.rx(-phi), (1,)),
        (g.rz(-psi), (1,)),
    ]
    return circuit_unitary(ops, 2)


def ry_sqrtiswap_layer_gate(depth: int, params):
    """Repeated [ry, ry, sqrt-iSWAP] layers (experiments/Jamie.py:13-35)."""
    ops = []
    params = jnp.asarray(params).reshape(depth, 2)
    for i in range(depth):
        ops += [
            (g.ry(params[i, 0]), (0,)),
            (g.ry(params[i, 1]), (1,)),
            (g.SQRT_ISWAP, (0, 1)),
        ]
    return circuit_unitary(ops, 2)
