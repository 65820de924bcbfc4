"""Riemannian optimization on the isometry (Stiefel) manifold.

For large bond dimension the su(2D) global chart (expm of an
anti-hermitian parameter vector) becomes the bottleneck and conditions
badly.  Here the variational object is the MPS isometry itself,
iso in St(dD, D) = {V : V^dag V = I}: Euclidean gradient -> tangent
projection -> adam-style step -> polar retraction (SVD), all jittable and
dense-matmul shaped (the SVD is on a (dD, D) matrix).

This is the 'Riemannian optimization of unitaries' stage of the build plan
(SURVEY section 7 B5; the reference's polar trick appears at
new_tdvp/loschmidt_classical.py:133-136).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..core.linalg import cT


def _project_tangent(V, G):
    """Project a Euclidean gradient G onto the tangent space of St at V:
    G - V sym(V^dag G)."""
    VG = cT(V) @ G
    sym = (VG + cT(VG)) / 2
    return G - V @ sym


def _retract(V):
    """Polar retraction back onto the manifold."""
    u, _, vh = jnp.linalg.svd(V, full_matrices=False)
    return u @ vh


def stiefel_minimize(
    loss: Callable,
    V0: jnp.ndarray,
    steps: int = 300,
    lr: float = 0.1,
    momentum: float = 0.9,
):
    """Minimize loss(V) over isometries V (orthonormal columns).

    Heavy-ball momentum in the tangent space with polar retraction; the
    momentum is re-projected after each retraction (vector transport by
    projection).  Returns (V, history); history has length steps+1, with
    hist[k] = loss at iterate k and hist[-1] the loss of the RETURNED V
    (so reported energies are achieved by the returned state, never a
    best-of-history no iterate realizes).
    """

    vg = jax.value_and_grad(lambda V: loss(V), holomorphic=False)

    @jax.jit
    def run(V0):
        def step(carry, _):
            V, M = carry
            val, G = vg(V)
            # Wirtinger gradient for real loss of complex V: steepest
            # descent direction is conj(G)
            G = G.conj()
            T = _project_tangent(V, G)
            M = momentum * M + T
            V = _retract(V - lr * M)
            M = _project_tangent(V, M)
            return (V, M), val

        (V, _), hist = jax.lax.scan(
            step, (V0, jnp.zeros_like(V0)), None, length=steps
        )
        hist = jnp.concatenate([hist, loss(V)[None]])
        return V, hist

    return run(V0)


def isometry_energy(V, h, D: int, dense: bool, power_iters: int = 120):
    """Energy density of the uMPS whose tensor is the (dD, D) isometry V.

    Rows of V are indexed (i, s) — V.reshape(D, d, D) gives A[s, i, j]
    after a transpose — matching ``unitary_to_tensor``'s column slice.
    The environment fixed point is dense repeated-squaring when ``dense``
    else the matvec Krylov path (restarted Arnoldi + GMRES adjoint).
    Shared by the direct Stiefel optimizer below and the deep-brickwork
    ansatz (algorithms/ground_state.ground_state_deep_brickwork)."""
    from ..mps import transfer as tr
    from ..mps.imps import merge

    d = 2
    A = V.reshape(D, d, D).transpose(1, 0, 2)  # iso rows (i, s) -> (s, i, j)
    _, r = tr.right_fixed_point(A, A, dense=dense, iters=40 if dense else power_iters)
    r = (r + cT(r)) / 2
    r = r / jnp.trace(r)
    A2 = merge(A, A)
    return jnp.einsum("ts,sij,jk,tik->", h.astype(A.dtype), A2, r, A2.conj()).real


def isometry_energy_warm(V, h, D: int, r0, iters: int = 24, bwd: str = "auto"):
    """(energy, r): ``isometry_energy`` with environment recycling — the
    fixed point is warm-started at r0 (the previous optimizer step's
    environment) via ``transfer.right_eigpair_warm`` instead of being
    rebuilt from scratch.  The returned r is unit-Frobenius, fed back as
    the next step's r0 (stop-gradient it at the call site).  ``bwd``
    selects the implicit-adjoint solver (see right_eigpair_warm); vmapped
    consumers at D >= 16 must pass "gmres" — the "auto" LU branch
    materializes a (D^2+1)^2 system PER BATCH ELEMENT (8.6 GB at D=32 for
    a 1024-point sweep)."""
    from ..mps import transfer as tr
    from ..mps.imps import merge

    d = 2
    A = V.reshape(D, d, D).transpose(1, 0, 2)
    if bwd == "unroll":
        # plain AD through the warm iterations — the vmapped-small-D
        # fast path (the implicit LU adjoint is pivot-sequential under
        # vmap; see transfer.right_eigpair_warm_unroll)
        _, r = tr.right_eigpair_warm_unroll(A, A, r0, iters)
    else:
        _, r = tr.right_eigpair_warm(A, A, r0, iters, bwd)
    rh = (r + cT(r)) / 2
    rh = rh / jnp.trace(rh)
    A2 = merge(A, A)
    e = jnp.einsum("ts,sij,jk,tik->", h.astype(A.dtype), A2, rh, A2.conj()).real
    return e, r


@functools.lru_cache(maxsize=32)
def _recycled_program(D: int, steps: int, lr: float, momentum: float,
                      recycle_iters: int):
    """One compiled recycled-descent program per configuration, H traced
    as float planes (every g of a phase scan reuses one executable — a
    fresh jit wrapper per call would re-trace the whole scan each time)."""

    def loss_env(V, r, hre, him, iters):
        return isometry_energy_warm(V, jax.lax.complex(hre, him), D, r, iters)

    vg = jax.value_and_grad(
        lambda V, r, hre, him: loss_env(
            V, jax.lax.stop_gradient(r), hre, him, recycle_iters
        ),
        has_aux=True,
    )

    @jax.jit
    def run(key, hre, him):
        # init INSIDE the program: one dispatch per call instead of
        # several eager draws
        k1, k2 = jax.random.split(key)
        ftype = hre.dtype
        V0, _ = jnp.linalg.qr(
            jax.lax.complex(
                jax.random.normal(k1, (2 * D, D), ftype),
                jax.random.normal(k2, (2 * D, D), ftype),
            )
        )
        r0 = jnp.eye(D, dtype=V0.dtype)
        r0 = r0 / jnp.linalg.norm(r0)

        def step(carry, _):
            V, M, r = carry
            (val, r_new), G = vg(V, r, hre, him)
            G = G.conj()
            T = _project_tangent(V, G)
            M = momentum * M + T
            V = _retract(V - lr * M)
            M = _project_tangent(V, M)
            # r_new is unit-Frobenius by construction (right_eigpair_warm)
            return (V, M, r_new), val

        (V, _, r), hist = jax.lax.scan(
            step, (V0, jnp.zeros_like(V0), r0), None, length=steps
        )
        # boosted final refinement: hist[-1] is the returned state's energy
        # to machine precision (residual 1e-15 at 200 iterations), never
        # the recycled residual
        final, _ = loss_env(V, r, hre, him, 200)
        hist = jnp.concatenate([hist, final[None]])
        return V, hist

    return run


def default_dense_env_max_D() -> int:
    """Largest bond dimension for which the cold per-step environment
    solve uses dense repeated squaring rather than the matvec Krylov path.
    On the CPU 8: matvec is ~13x faster at D=16 there (13.5 s against
    172 s for 300 steps).  On a GPU 32, from one timing of both solvers'
    cold steps at D=16 and D=32 (PERF.md)."""
    return 8 if jax.default_backend() == "cpu" else 32


def ground_state_riemannian(
    h: jnp.ndarray,
    D: int,
    steps: int = 400,
    lr: float = 0.08,
    key=None,
    dense_env_max_D: int | None = None,
    power_iters: int | None = None,
    recycle: bool = True,
    recycle_iters: int = 24,
):
    """Variational uMPS ground state at bond dimension D, optimizing the
    (d D, D) isometry directly.

    The environment fixed point uses the dense repeated-squaring solver up
    to dense_env_max_D and the matvec Krylov path above it (dense transfer
    matrices are D^2 x D^2; the matvec path is restarted Arnoldi forward +
    fixed-shape GMRES implicit adjoint, core/krylov.py, both fixed-shape
    under lax.scan).  The default crossover is `default_dense_env_max_D`.

    recycle=True (default): environment recycling — the fixed point is
    carried through the optimizer scan and refined with ``recycle_iters``
    cheap operator-form power matvecs per step instead of being resolved
    from scratch (transfer.right_eigpair_warm; gradients via the implicit
    c-gauge adjoint at the recycled pair); converged errors match the
    cold path.  recycle=False keeps the cold per-step solver (the oracle
    path the recycled one is tested against).

    Returns (A, energy, history); ``energy`` is evaluated at the returned
    A (= hist[-1]), not the best value seen during optimization.
    """
    d = 2
    key = jax.random.PRNGKey(0) if key is None else key

    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    if recycle:
        if dense_env_max_D is not None or power_iters is not None:
            # these knobs configure the COLD per-step solver only; silently
            # ignoring them would hand the caller a different solver than
            # the one they tuned (e.g. forcing the Krylov path for a test)
            raise ValueError(
                "dense_env_max_D/power_iters configure the cold per-step "
                "solver; pass recycle=False to use them"
            )
        import numpy as _np

        h_host = _np.asarray(h)  # real/imag planes as float jit arguments
        run = _recycled_program(D, steps, float(lr), 0.9, recycle_iters)
        V, hist = run(
            key,
            jnp.asarray(_np.ascontiguousarray(h_host.real), ftype),
            jnp.asarray(_np.ascontiguousarray(h_host.imag), ftype),
        )
    else:
        if dense_env_max_D is None:
            dense_env_max_D = default_dense_env_max_D()
        if power_iters is None:
            power_iters = 120
        k1, k2 = jax.random.split(key)
        # build V0 inside one jit from real normal draws (one program, and
        # V0 stays device-resident)
        @jax.jit
        def _init(xre, xim):
            V0, _ = jnp.linalg.qr(jax.lax.complex(xre, xim))
            return V0

        V0 = _init(
            jax.random.normal(k1, (d * D, D), ftype),
            jax.random.normal(k2, (d * D, D), ftype),
        )
        dense = D <= dense_env_max_D

        def energy(V):
            return isometry_energy(V, h, D, dense, power_iters)

        V, hist = stiefel_minimize(energy, V0, steps=steps, lr=lr)
    A = V.reshape(D, d, D).transpose(1, 0, 2)
    return A, float(hist[-1]), hist
