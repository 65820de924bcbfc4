"""Transfer-operator fixed points as batched, differentiable JAX programs.

The reference gets environments from dense scipy eigensolves
(qmps/tools.py:176-182 via xmps TransferMatrix.eigs;
new_tdvp/ClassicalTDVPStripped.py:424-431) — non-differentiable, CPU-only,
unbatchable.  Here fixed points come from two jit/vmap/grad-compatible
solvers:

- ``dominant_eig_dense``: repeated squaring of the dense transfer matrix.
  log2-convergent (error ~ gap^(2^iters)), so ~30 matmuls give machine
  precision for any spectral gap; dense-matmul work for D <= 64.
- ``dominant_eig_power``: scan-based power iteration in matvec form,
  O(d D^3) per step, for large D where the dense D^2 x D^2 operator is too
  big to materialize.

Both are plain compositions of matmuls, so reverse-mode AD works out of
the box; on top of that, the dense path ships exact implicit-function
adjoints (``dominant_eigval_dense`` for eigenvalue-only consumers and
``dominant_eigpair_cgauge`` with a holomorphic c^T v = 1 gauge for the full
pair), so gradients cost one bordered linear solve instead of a backward
pass through the squaring iteration — and are *more* accurate (validated
against finite differences).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax.numpy as jnp
from jax import lax


# generic dense eigensolvers live in core.linalg (no MPS content; keeping
# them there preserves the core -> mps layering — core.krylov needs them
# too); re-exported here because this module is their historical home
from ..core.linalg import (  # noqa: E402, F401
    _chirp,
    dominant_eig_dense,
    spectral_radius_dense,
)


def _match_vma(x: jnp.ndarray, *like: jnp.ndarray) -> jnp.ndarray:
    """Promote x to the union of ``like``'s varying-manual-axes.

    Inside shard_map, a replicated constant (e.g. a cold-start fixed
    point jnp.eye) entering a scan whose body mixes in device-varying
    operands fails the carry type check — input carry unvarying, output
    varying.  pcast(..., to='varying') is the sanctioned zero-cost
    promotion; outside shard_map every vma set is empty and this is the
    identity."""
    import jax

    target = set(jax.typeof(x).vma)
    for y in like:
        target |= set(jax.typeof(y).vma)
    extra = tuple(sorted(target - set(jax.typeof(x).vma)))
    return lax.pcast(x, extra, to="varying") if extra else x


def right_matvec(A: jnp.ndarray, B: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """(E r) = sum_s A[s] r B[s]^dag  — right action of the mixed transfer
    operator E^A_B (xmps Map convention)."""
    return jnp.einsum("sij,jk,slk->il", A, r, B.conj())


def left_matvec(A: jnp.ndarray, B: jnp.ndarray, l: jnp.ndarray) -> jnp.ndarray:
    """(l E) = sum_s A[s]^dag l B[s] — left action."""
    return jnp.einsum("sji,jk,skl->il", A.conj(), l, B)


def transfer_dense(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Dense (D_A D_B, D_A D_B) matrix E with E @ vec(r) = vec(sum A r B^dag)."""
    return jnp.einsum("sik,sjl->ijkl", A, B.conj()).reshape(
        A.shape[1] * B.shape[1], A.shape[2] * B.shape[2]
    )


def dominant_eig_power(
    matvec: Callable[[jnp.ndarray], jnp.ndarray], v0: jnp.ndarray, iters: int = 200
):
    """Dominant eigenpair by power iteration in operator form.

    For matvecs with complex dominant eigenvalue the iterate's phase rotates,
    but the Rayleigh quotient converges; we return (lam, v) with |v| = 1.
    """

    def step(v, _):
        w = matvec(v)
        return w / jnp.linalg.norm(w), None

    v0 = v0 / jnp.linalg.norm(v0)
    v, _ = lax.scan(step, v0, None, length=iters)
    w = matvec(v)
    lam = jnp.vdot(v, w)
    return lam, v


import jax


@jax.custom_vjp
def dominant_eigval_dense(E: jnp.ndarray) -> jnp.ndarray:
    """Dominant eigenvalue only, with an implicit-function adjoint.

    The eigenvalue is gauge-free, so its adjoint is exact and cheap:
    dlam = (w^dag dE v) / (w^dag v) with v, w the right/left dominant
    eigenvectors — no backward pass through the squaring iteration.  Use
    this in objectives that consume only lam (the fast TDVP overlap paths);
    eigenvector consumers use ``dominant_eigpair_cgauge`` below.
    """
    lam, _ = dominant_eig_dense(E)
    return lam


def _dom_eigval_fwd(E):
    lam, v = dominant_eig_dense(E)
    _, w = dominant_eig_dense(jnp.swapaxes(E, -1, -2).conj())  # E^dag w = conj(lam) w
    return lam, (lam, v, w)


def _dom_eigval_bwd(res, lam_ct):
    lam, v, w = res
    denom = jnp.vdot(w, v)  # w^dag v
    Ebar = lam_ct * jnp.outer(w.conj(), v) / denom
    return (Ebar,)


dominant_eigval_dense.defvjp(_dom_eigval_fwd, _dom_eigval_bwd)


@jax.custom_vjp
def dominant_eigpair_cgauge(E: jnp.ndarray, c: jnp.ndarray):
    """(lam, v) with the holomorphic gauge c^T v = 1.

    Fixing the eigenvector scale by a LINEAR functional (not a norm) makes
    (lam, v) locally holomorphic in E, so the implicit-function adjoint is
    exact and gauge-unambiguous: the backward pass is one bordered
    (n+1)-dim linear solve instead of differentiating the squaring
    iteration.  Callers apply their own (differentiable) gauge map on top —
    e.g. hermitian rotation + Frobenius normalization in
    ``right_fixed_point``.
    """
    lam, v = dominant_eig_dense(E)
    return lam, v / (c @ v)


def _eigpair_fwd(E, c):
    lam, v = dominant_eigpair_cgauge(E, c)
    return (lam, v), (E, lam, v, c)


def _eigpair_bwd(res, cts):
    E, lam, v, c = res
    lam_ct, v_ct = cts
    n = E.shape[0]
    # J = [[E - lam I, -v], [c^T, 0]] from d(Ev - lam v) = 0, d(c^T v) = 0;
    # solve J^T [xi; mu] = [v_ct; lam_ct], then Ebar = -outer(xi, v)
    JT = jnp.zeros((n + 1, n + 1), E.dtype)
    JT = JT.at[:n, :n].set((E - lam * jnp.eye(n, dtype=E.dtype)).T)
    JT = JT.at[:n, n].set(c)
    JT = JT.at[n, :n].set(-v)
    rhs = jnp.concatenate([v_ct, jnp.reshape(lam_ct, (1,))])
    xi = jnp.linalg.solve(JT, rhs)[:n]
    return (-jnp.outer(xi, v), None)


dominant_eigpair_cgauge.defvjp(_eigpair_fwd, _eigpair_bwd)


def _krylov_dims(n: int, iters: int) -> tuple[int, int]:
    """(k, restarts) for an Arnoldi budget of ~iters matvecs."""
    k = min(n, 48)
    restarts = max(2, iters // max(k, 1))
    return k, restarts


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _right_eigpair_matvec(A: jnp.ndarray, B: jnp.ndarray, iters: int):
    """(lam, vec(r)) of the mixed transfer map in matvec form (large D),
    c-gauged like the dense version; forward = restarted Arnoldi (resolves
    near-degenerate spectra where power iteration stalls), implicit adjoint
    via a fixed-shape bordered GMRES solve (the backward pass never
    differentiates the iteration and never materializes the dense E)."""
    from ..core.krylov import dominant_eigpair_arnoldi

    D1, D2 = A.shape[1], B.shape[1]
    k, restarts = _krylov_dims(D1 * D2, iters)
    lam, v = dominant_eigpair_arnoldi(
        lambda r: right_matvec(A, B, r.reshape(D1, D2)).reshape(-1),
        jnp.eye(max(D1, D2), dtype=A.dtype)[:D1, :D2].reshape(-1),
        k=k,
        restarts=restarts,
    )
    c = _chirp(D1 * D2, A.dtype)
    return lam, v / (c @ v)


def _rem_fwd(A, B, iters):
    lam, v = _right_eigpair_matvec(A, B, iters)
    return (lam, v), (A, B, lam, v)


def _rem_bwd(iters, res, cts):
    from ..core.krylov import gmres_solve

    A, B, lam, v = res
    lam_ct, v_ct = cts
    D1, D2 = A.shape[1], B.shape[1]
    n = D1 * D2
    c = _chirp(n, A.dtype)

    def Emv(x):
        return right_matvec(A, B, x.reshape(D1, D2)).reshape(-1)

    def ETmv(x):
        # E^T x = conj(E^dag conj(x)); E^dag is the left action
        return left_matvec(A, B, x.conj().reshape(D1, D2)).reshape(-1).conj()

    # bordered solve: [[ (E - lam)^T, c ], [ -v^T, 0 ]] [xi; mu] = [v_ct; lam_ct]
    def op(z):
        xi, mu = z[:n], z[n]
        top = ETmv(xi) - lam * xi + mu * c
        bot = -(v @ xi)
        return jnp.concatenate([top, jnp.reshape(bot, (1,))])

    rhs = jnp.concatenate([v_ct, jnp.reshape(lam_ct, (1,))])
    k, restarts = _krylov_dims(n + 1, max(iters, 400))
    sol, _ = gmres_solve(op, rhs, k=k, restarts=restarts)
    xi = sol[:n].reshape(D1, D2)
    rmat = v.reshape(D1, D2)
    # <Ebar, dE> with dE v = vec(dA r B^dag + A r dB^dag):
    # total = -xi^T (dE v)  ->  pull back to A and B
    Abar = -jnp.einsum("il,jk,slk->sij", xi, rmat, B.conj())
    Bbar = -jnp.einsum("il,sij,jk->slk", xi, A, rmat).conj()
    return Abar, Bbar


_right_eigpair_matvec.defvjp(_rem_fwd, _rem_bwd)


def right_fixed_point(A: jnp.ndarray, B: jnp.ndarray, dense: bool = True, iters: int = 40):
    """Dominant (lam, r) of r -> sum_s A[s] r B[s]^dag, r as a (D, D) matrix.

    r is phase-normalized to hermitian with unit Frobenius norm and
    nonnegative trace (the gauge the circuit embeddings expect; see
    qmps/time_evolve_tools.py:38-74 where embeddings divide by |q|_F).
    """
    from ..core.linalg import rotate_to_hermitian

    D1, D2 = A.shape[1], B.shape[1]
    if dense:
        E = transfer_dense(A, B)
        lam, v = dominant_eigpair_cgauge(E, _chirp(D1 * D2, E.dtype))
    else:
        lam, v = _right_eigpair_matvec(A, B, max(iters, 200))
    r = rotate_to_hermitian(v.reshape(D1, D2))
    return lam, r / jnp.linalg.norm(r)


# ---------------------------------------------------------------------------
# Recycled fixed points (environment recycling across optimizer steps)
# ---------------------------------------------------------------------------


def _power_forward(A, B, r0, iters: int):
    """Normalized right power iteration from r0 + Rayleigh quotient —
    the ONE forward body shared by right_eigpair_warm (implicit adjoint)
    and right_eigpair_warm_unroll (plain AD): the unroll path's gradient
    claim ("exact gradient of the quantity actually evaluated") holds
    only while the two forwards are numerically identical."""

    def it(r, _):
        w = right_matvec(A, B, r)
        return w / jnp.linalg.norm(w), None

    start = _match_vma(r0 / jnp.linalg.norm(r0), A, B)
    r, _ = jax.lax.scan(it, start, None, length=iters)
    lam = jnp.einsum("ij,ij->", r.conj(), right_matvec(A, B, r))
    return lam, r


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def right_eigpair_warm(
    A: jnp.ndarray, B: jnp.ndarray, r0: jnp.ndarray, iters: int = 24,
    bwd: str = "auto",
):
    """Dominant (lam, r) of the right transfer action, warm-started at r0.

    The DMRG/TDVP environment-recycling move: inside an optimizer scan
    the fixed point moves O(lr) per step, so ``iters`` cheap operator-form
    matvecs (O(d D^3) each) from the previous step's ``r`` replace the
    from-scratch dense squaring chain (40 matmuls of the D^2 x D^2 matrix)
    with identical converged energies (optim/riemann.py consumes this).

    Forward: normalized power iteration from r0 (for A == B the map is
    completely positive, the dominant eigenvalue real positive — power
    iteration is exact-phase and monotone).  Backward: the implicit
    c-gauge adjoint evaluated at the returned pair — a bordered linear
    solve, LU on the materialized E for n = D_A D_B <= 1024 (one (n+1)^2
    solve beats GMRES's sequential orthogonalization chain at these
    sizes), restarted-GMRES matvec form above (never builds E; the
    ``core.krylov`` fixed-shape solver).  r0 gets a zero cotangent: at
    convergence the fixed point does not depend on the start vector —
    callers recycle r without creating a cross-step backward chain.

    Returns (lam, r) with r unit-Frobenius, phase as produced by the
    iteration (positive for A == B with a PSD start).
    """
    del bwd
    return _power_forward(A, B, r0, iters)


def _warm_fwd(A, B, r0, iters, bwd):
    lam, r = right_eigpair_warm(A, B, r0, iters, bwd)
    # r0 rides the residuals only for its aval: the bwd's zero cotangent
    # must match r0's shape/dtype exactly (custom_vjp aval check), and r0
    # may differ from r (e.g. complex64 start under x64)
    return (lam, r), (A, B, lam, r, r0)


def _warm_bwd(iters, bwd, res, cts):
    from ..core.krylov import gmres_solve

    A, B, lam, r, r0 = res
    lam_ct, r_ct = cts
    D1, D2 = A.shape[1], B.shape[1]
    n = D1 * D2
    v = r.reshape(-1)
    c = v.conj()  # linear gauge functional: c^T v = |v|^2 = 1 at the point
    rhs = jnp.concatenate([r_ct.reshape(-1), jnp.reshape(lam_ct, (1,))])
    use_lu = n <= 1024 if bwd == "auto" else (bwd == "lu")
    # bordered system: [[(E - lam I)^T, c], [-v^T, 0]] [xi; mu] = [rbar; lambar]
    if use_lu:
        E = transfer_dense(A, B)
        M = jnp.zeros((n + 1, n + 1), E.dtype)
        M = M.at[:n, :n].set(
            jnp.swapaxes(E, -1, -2) - lam * jnp.eye(n, dtype=E.dtype)
        )
        M = M.at[:n, n].set(c)
        M = M.at[n, :n].set(-v)
        sol = jnp.linalg.solve(M, rhs)
    else:
        def ETmv(x):
            # E^T x = conj(E^dag conj(x)); E^dag is the left action
            return left_matvec(A, B, x.conj().reshape(D1, D2)).reshape(-1).conj()

        def op(z):
            xi, mu = z[:n], z[n]
            top = ETmv(xi) - lam * xi + mu * c
            bot = -(v @ xi)
            return jnp.concatenate([top, jnp.reshape(bot, (1,))])

        # budget PROPORTIONAL to the forward's recycle budget (~4x its
        # matvecs), not the cold adjoint's 400: the gradient is evaluated
        # at the RECYCLED pair, itself only O(power-residual) off the true
        # fixed point, so solving the bordered system to machine precision
        # buys nothing: a 400-matvec budget costs ~4x per step with
        # converged errors unchanged.  k=32 rather than _krylov_dims's
        # k=48: the same matvec total with less orthogonalization per cycle
        k = min(n + 1, 32)
        restarts = max(3, -(-4 * iters // k))
        sol, _ = gmres_solve(op, rhs, k=k, restarts=restarts)
    xi = sol[:n].reshape(D1, D2)
    # <Ebar, dE> = -xi^T (dE v) pulled back through dE v = vec(dA r B^dag
    # + A r dB^dag)
    Abar = -jnp.einsum("il,jk,slk->sij", xi, r, B.conj())
    Bbar = -jnp.einsum("il,sij,jk->slk", xi, A, r).conj()
    return Abar, Bbar, jnp.zeros_like(r0)


right_eigpair_warm.defvjp(_warm_fwd, _warm_bwd)


def right_eigpair_warm_unroll(A, B, r0, iters: int = 24):
    """``right_eigpair_warm`` with PLAIN reverse-mode AD through the
    power iterations instead of the implicit bordered-solve adjoint.

    Rationale: under vmap the implicit adjoint's batched (D^2+1)^2
    complex LU is pivot-sequential and dominates the whole optimizer step
    (most of a D=8, B=1024 deep-brickwork sweep step), while the
    batched-GMRES form is slower again (orthogonalization chain).  Backward through ``iters`` matvecs is
    pure batched matmuls (~2x the forward's cost) and computes the EXACT
    gradient of the quantity actually evaluated — the iters-step-refined
    energy from a stop-gradient start — which is the loss the recycled
    optimizer descends; at convergence (residual -> 0) it coincides with
    the implicit gradient.  The implicit form stays the right tool for
    CONVERGED-point gradients at small spectral gaps (docs/DESIGN.md 4b).
    """
    return _power_forward(A, B, r0, iters)


def left_fixed_point(A: jnp.ndarray, B: jnp.ndarray, dense: bool = True, iters: int = 40):
    """Dominant (lam, l) of l -> sum_s A[s]^dag l B[s]."""
    from ..core.linalg import rotate_to_hermitian

    D1, D2 = A.shape[1], B.shape[1]
    if dense:
        # left action of E is the right action of (A^dag-tensors, B^dag-tensors)
        Ad = jnp.swapaxes(A, 1, 2).conj()
        Bd = jnp.swapaxes(B, 1, 2).conj()
        E = transfer_dense(Ad, Bd)
        lam, v = dominant_eigpair_cgauge(E, _chirp(D1 * D2, E.dtype))
    else:
        from ..core.krylov import dominant_eigpair_arnoldi

        k, restarts = _krylov_dims(D1 * D2, max(iters, 200))
        lam, v = dominant_eigpair_arnoldi(
            lambda l: left_matvec(A, B, l.reshape(D1, D2)).reshape(-1),
            jnp.eye(max(D1, D2), dtype=A.dtype)[:D1, :D2].reshape(-1),
            k=k,
            restarts=restarts,
        )
    l = rotate_to_hermitian(v.reshape(D1, D2))
    return lam, l / jnp.linalg.norm(l)
