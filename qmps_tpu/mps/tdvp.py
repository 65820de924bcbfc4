"""Classical TDVP for uniform MPS (the xmps iTDVP / dA_dt replacement).

The reference leans on xmps for the classical time-evolution baselines it
cross-validates every quantum circuit against (tests/test_time_evolve.py,
qmps/loschmidts/mps_loschmidts.py, scripts/classical_time_evolution.py).
This module provides that capability in JAX: mixed-gauge tangent-space
TDVP with the infinite geometric Hamiltonian sums solved as dense
regularized linear systems (differentiable, jit/vmap-safe; D^2 x D^2 solves
are dense-matmul work for the D <= 64 regime this framework targets).

Conventions: two-site Hamiltonian h with h[(u v), (s t)] = <u v| h |s t>;
mixed gauge (AL, AR, C), AC = AL C; right fixed point of AL's transfer is
r = C C^dag (unit trace), left fixed point of AR's is l = C^dag C.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..core.linalg import cT
from . import transfer as tr


def mixed_gauge(A):
    """(AL, AR, C) for an arbitrary uMPS tensor — delegates to iMPS.mixed
    so there is exactly ONE mixed-gauge implementation (two parallel
    copies with divergent inverse/jitter handling once disagreed on
    near-singular states)."""
    from .imps import iMPS

    return iMPS([A]).mixed()


def _two_site(X):
    """Blocked 2-site tensor AL2[s, t] = AL_s AL_t, shape (d, d, D, D)."""
    return jnp.einsum("sij,tjk->stik", X, X)


def _h4(h):
    """h[(uv),(st)] -> h4[u, v, s, t] (rows (u,v), cols (s,t)); the
    physical dimension is inferred from h's (static) shape, so the same
    machinery serves spin chains (d=2) and BLOCKED two-site cells
    (d=4, see ham.block_two_site)."""
    d = int(round(h.shape[0] ** 0.5))
    return h.reshape(d, d, d, d)


def energy_density(AL, C, h):
    """<h> per site in mixed gauge."""
    r = C @ cT(C)
    AL2 = _two_site(AL)
    return jnp.einsum(
        "uvia,stib,ba,uvst->", AL2.conj(), AL2, r, _h4(h)
    ).real


def _solve_left_env(AL, r, rhs, solver: str = "dense", k: int = 48,
                    restarts: int = 8):
    """x solving  x - E_L(x) + tr(x r) I = rhs  (E_L(x) = sum AL^dag x AL);
    the rank-1 term removes the unit eigenvalue so the system is regular.

    solver="dense" materializes the (D^2, D^2) matrix — O(D^6), fine to
    D ~ 16-32 and cheap to differentiate; solver="gmres" runs the
    fixed-shape restarted GMRES on the matvec (O(d D^3) per step),
    which is what makes VUMPS at D = 32-64 tractable."""
    D = AL.shape[1]
    if solver == "gmres":
        from ..core.krylov import gmres_solve

        eye = jnp.eye(D, dtype=AL.dtype)

        def mv(v):
            x = v.reshape(D, D)
            ELx = jnp.einsum("sia,sjb,ij->ab", AL.conj(), AL, x)
            return (x - ELx + jnp.trace(x @ r) * eye).reshape(-1)

        x, _ = gmres_solve(mv, rhs.reshape(-1), k=k, restarts=restarts)
        return x.reshape(D, D)
    EL = jnp.einsum("sia,sjb->abij", AL.conj(), AL).reshape(D * D, D * D)
    corr = jnp.outer(jnp.eye(D, dtype=AL.dtype).reshape(-1), r.T.reshape(-1))
    M = jnp.eye(D * D, dtype=AL.dtype) - EL + corr
    return jnp.linalg.solve(M, rhs.reshape(-1)).reshape(D, D)


def _solve_right_env(AR, l, rhs, solver: str = "dense", k: int = 48,
                     restarts: int = 8):
    """x solving  x - E_R(x) + tr(l x) I = rhs  (E_R(x) = sum AR x AR^dag).

    The rank-1 row is the functional x -> tr(l x) in row-major vec form:
    tr(l x) = sum_ij l[i,j] x[j,i] = l.T.flat . x.flat — the transpose is
    load-bearing (l.flat encodes tr(l^T x); for complex l the difference
    shifted HR by a complex multiple of I.  It cancelled in dA_dt's
    dAC - AL dC, which is why the TDVP trajectories were right, but any
    direct consumer of HR / H_C saw the shift).  See _solve_left_env for
    the dense/gmres split."""
    D = AR.shape[1]
    if solver == "gmres":
        from ..core.krylov import gmres_solve

        eye = jnp.eye(D, dtype=AR.dtype)

        def mv(v):
            x = v.reshape(D, D)
            ERx = jnp.einsum("sai,sbj,ij->ab", AR, AR.conj(), x)
            return (x - ERx + jnp.trace(l @ x) * eye).reshape(-1)

        x, _ = gmres_solve(mv, rhs.reshape(-1), k=k, restarts=restarts)
        return x.reshape(D, D)
    ER = jnp.einsum("sai,sbj->abij", AR, AR.conj()).reshape(D * D, D * D)
    corr = jnp.outer(jnp.eye(D, dtype=AR.dtype).reshape(-1), l.T.reshape(-1))
    M = jnp.eye(D * D, dtype=AR.dtype) - ER + corr
    return jnp.linalg.solve(M, rhs.reshape(-1)).reshape(D, D)


def hamiltonian_environments(AL, AR, C, h, env_solver: str = "dense"):
    """(HL, HR, e): summed Hamiltonian environments left/right of a site,
    extensive part (energy density e) subtracted.  env_solver selects
    the geometric-sum linear solver: "dense" (O(D^6), differentiable,
    D <= ~32) or "gmres" (O(d D^3) per step; the D = 32-64 VUMPS path)."""
    h4 = _h4(h)
    r = C @ cT(C)
    l = cT(C) @ C
    AL2 = _two_site(AL)
    AR2 = _two_site(AR)

    # contribution of h on the two sites immediately left (boundary = I):
    hL = jnp.einsum("uvia,stib,uvst->ab", AL2.conj(), AL2, h4)
    e = jnp.trace(hL @ r).real
    hL = hL - e * jnp.eye(hL.shape[0], dtype=hL.dtype)
    HL = _solve_left_env(AL, r, hL, solver=env_solver)

    # contribution of h on the two sites immediately right (boundary = I):
    hR = jnp.einsum("stak,uvbk,uvst->ab", AR2, AR2.conj(), h4)
    hR = hR - jnp.trace(l @ hR) * jnp.eye(hR.shape[0], dtype=hR.dtype)
    HR = _solve_right_env(AR, l, hR, solver=env_solver)
    return HL, HR, e


def energy_variance_density(AL, r, h, env_solver: str = "dense",
                            k: int = 48, restarts: int = 8):
    """Per-site energy variance sigma^2 = lim_N (<H^2> - <H>^2) / N — the
    oracle-free convergence certificate: sigma^2 = 0 iff the uMPS is an
    exact eigenstate of H = sum_n h_{n,n+1}, and for an optimized state
    the energy error obeys |E - E_0| <= sigma^2 / gap, so a per-point
    variance readout certifies sweep convergence with no exact integral
    in the loop (the reference has no analogue; it validates only
    against closed-form oracles, scripts/ground_state_finding.py:70-72).

    With h~ = h - e the shifted bond term, by translation invariance

        sigma^2 = <h~_0 h~_0> + 2 Re <h~_0 h~_1> + 2 Re sum_{d>=2} <h~_0 h~_d>

    (both operator orders of each unordered pair combine to 2 Re since h
    is Hermitian).  The d >= 2 tail is the same regularized geometric sum
    as `hamiltonian_environments`: HL = sum_m E_L^m(hL~) via
    `_solve_left_env`, then one shifted bond window capped with r.  All
    terms are O(d^3 D^3) einsums except the solve (dense O(D^6) or
    GMRES O(d D^3) per matvec — vmap-safe for batched sweep
    certificates).

    AL left-canonical (d, D, D); r its right fixed point (unit trace,
    r = C C^dag — only r enters, not C).  Returns a real scalar >= 0
    (up to solver tolerance).
    """
    d = AL.shape[0]
    h4 = _h4(h)
    AL2 = _two_site(AL)

    hL = jnp.einsum("uvia,stib,uvst->ab", AL2.conj(), AL2, h4)
    e = jnp.trace(hL @ r).real
    eyed = jnp.eye(d * d, dtype=h.dtype)
    ht = h - e.astype(h.dtype) * eyed
    ht4 = _h4(ht)

    # d = 0: <h~^2> on one bond
    t0 = jnp.einsum(
        "uvia,stib,ba,uvst->", AL2.conj(), AL2, r, _h4(ht @ ht)
    ).real

    # d = 1: overlapping windows on three sites, O3 = (h~ x I)(I x h~)
    AL3 = jnp.einsum("uvik,wkj->uvwij", AL2, AL)
    eye1 = jnp.eye(d, dtype=h.dtype)
    O3 = jnp.kron(ht, eye1) @ jnp.kron(eye1, ht)
    t1 = jnp.einsum(
        "uvwia,stqib,ba,uvwstq->",
        AL3.conj(), AL3, r, O3.reshape((d,) * 6),
    ).real

    # d >= 2: geometric sum of the shifted left environment, then one
    # shifted window capped with r
    hLs = hL - e.astype(hL.dtype) * jnp.eye(hL.shape[0], dtype=hL.dtype)
    HL = _solve_left_env(AL, r, hLs, solver=env_solver, k=k,
                         restarts=restarts)
    tail = jnp.einsum(
        "uvia,stjb,ij,ba,uvst->", AL2.conj(), AL2, HL, r, ht4
    ).real

    return t0 + 2.0 * t1 + 2.0 * tail


def effective_H_AC(AC, AL, AR, HL, HR, h):
    """One-site effective Hamiltonian H_AC applied to AC."""
    h4 = _h4(h)
    # h on (site-1, site): sum h4[u,v,t,s] AL_u^dag AL_t AC_s -> component v
    a = jnp.einsum("uia,tij,sjk,uvts->vak", AL.conj(), AL, AC, h4)
    # h on (site, site+1): sum h4[u,v,s,t] AC_s AR_t AR_v^dag -> component u
    b = jnp.einsum("sij,tjk,vlk,uvst->uil", AC, AR, AR.conj(), h4)
    c = jnp.einsum("ij,sjk->sik", HL, AC)
    d = jnp.einsum("sij,jk->sik", AC, HR)
    return a + b + c + d


def effective_H_C(C, AL, AR, HL, HR, h):
    """Zero-site effective Hamiltonian H_C applied to the center matrix."""
    h4 = _h4(h)
    a = jnp.einsum("uia,sij,jk,tkl,vml,uvst->am", AL.conj(), AL, C, AR, AR.conj(), h4)
    return a + HL @ C + C @ HR


def dAC_dC_dt(AL, AR, C, h, env_solver: str = "dense"):
    """(-i H_AC(AC), -i H_C(C), energy density).

    The energy density is subtracted from h everywhere (local terms and the
    geometric sums), so the flow is phase-free: on a variational ground
    state dAC = AL dC exactly (zero physical tangent)."""
    AC = jnp.einsum("sij,jk->sik", AL, C)
    HL, HR, e = hamiltonian_environments(AL, AR, C, h, env_solver=env_solver)
    h_shift = h - e * jnp.eye(h.shape[0], dtype=h.dtype)
    dAC = -1j * effective_H_AC(AC, AL, AR, HL, HR, h_shift)
    dC = -1j * effective_H_C(C, AL, AR, HL, HR, h_shift)
    return dAC, dC, e


def dA_dt(A, h):
    """Tangent vector for a left-canonical tensor A (xmps iMPS.dA_dt
    analogue): B = (dAC - AL dC) C^{-1}, in A's left gauge."""
    AL, AR, C = mixed_gauge(A)
    dAC, dC, _ = dAC_dC_dt(AL, AR, C, h)
    Cinv = _pinv(C)
    return jnp.einsum("sij,jk->sik", dAC - jnp.einsum("sij,jk->sik", AL, dC), Cinv)


def _polar_left(M):
    u, _, vh = jnp.linalg.svd(M, full_matrices=False)
    return u @ vh


def _pinv(C, rcond: float = 1e-6):
    """SVD pseudo-inverse with relative cutoff — the standard TDVP guard
    against near-singular center matrices (states whose effective rank is
    below D make inv(C) arbitrarily ill-conditioned and blow up the flow)."""
    u, s, vh = jnp.linalg.svd(C)
    cut = rcond * s[0]
    sinv = jnp.where(s > cut, 1.0 / jnp.maximum(s, cut), 0.0)
    return cT(vh) @ (sinv[:, None] * cT(u))


def _refresh_C(ALn):
    """C from the right fixed point of a (new) left-isometric AL — keeps
    the gauge exact after a retraction (shared by both steppers)."""
    D = ALn.shape[1]
    _, r = tr.right_fixed_point(ALn, ALn)
    r = (r + cT(r)) / 2
    r = r / jnp.trace(r)
    return jnp.linalg.cholesky(
        r + 32 * jnp.finfo(r.real.dtype).eps * jnp.eye(D, dtype=r.dtype)
    )


def _euler_step(AL, C, dt: float, tangent):
    """Generic explicit-Euler TDVP step: ``tangent(AL, C) -> (dAC, dC, e)``
    supplies the flow (dense two-site h or MPO — mps/mpo.tdvp_step_mpo),
    the gauge-preserving polar retraction is shared."""
    dAC, dC, e = tangent(AL, C)
    AC = jnp.einsum("sij,jk->sik", AL, C) + dt * dAC
    ALn = _extract_AL(AC, C + dt * dC)
    return ALn, _refresh_C(ALn), e


def _tangent_dense(h, env_solver: str = "dense"):
    """tangent(AL, C) for a dense two-site h: AR from the center gauge,
    then the phase-free mixed-gauge flow."""
    def tangent(AL, C):
        AR = jnp.einsum("ij,sjk,kl->sil", _pinv(C), AL, C)
        return dAC_dC_dt(AL, AR, C, h, env_solver=env_solver)

    return tangent


def tdvp_step(AL, C, h, dt: float):
    """One explicit-Euler TDVP step in mixed gauge with polar re-extraction
    of AL (AL <- polar(AC') polar(C')^dag): gauge-preserving by
    construction."""
    return _euler_step(AL, C, dt, _tangent_dense(h))


def _extract_AL(AC, C2):
    """AL <- polar(AC) polar(C)^dag (gauge-preserving retraction)."""
    d, D, _ = AC.shape
    UAC = _polar_left(AC.transpose(1, 0, 2).reshape(D * d, D))
    UC = _polar_left(C2)
    return (UAC @ cT(UC)).reshape(D, d, D).transpose(1, 0, 2)


def _rk4_step(AL, C, dt: float, tangent):
    """Generic classical-RK4 TDVP step (see tdvp_step_rk4 for the physics
    rationale); ``tangent(AL, C) -> (dAC, dC, e)`` as in `_euler_step`."""
    AC0 = jnp.einsum("sij,jk->sik", AL, C)
    k1AC, k1C, e = tangent(AL, C)

    def stage(aAC, aC):
        ACi, Ci = AC0 + aAC, C + aC
        return tangent(_extract_AL(ACi, Ci), Ci)

    k2AC, k2C, _ = stage(0.5 * dt * k1AC, 0.5 * dt * k1C)
    k3AC, k3C, _ = stage(0.5 * dt * k2AC, 0.5 * dt * k2C)
    k4AC, k4C, _ = stage(dt * k3AC, dt * k3C)

    AC = AC0 + (dt / 6.0) * (k1AC + 2 * k2AC + 2 * k3AC + k4AC)
    C2 = C + (dt / 6.0) * (k1C + 2 * k2C + 2 * k3C + k4C)
    ALn = _extract_AL(AC, C2)
    return ALn, _refresh_C(ALn), e


def tdvp_step_rk4(AL, C, h, dt: float):
    """One classical RK4 TDVP step in mixed gauge.

    The tangent (dAC, dC) is evaluated at four stage points; each stage
    re-extracts a left-isometric AL from (AC_i, C_i) by polar retraction so
    the tangent is always evaluated on the manifold.  4x the per-step cost
    of `tdvp_step`, but stable at time steps where explicit Euler freezes
    at dynamical phase transitions (the Schmidt-degenerate points): Euler
    at dt = 2e-3 stalls the g 1.5 -> 0.2 quench at the first DPT, RK4 at
    the same dt tracks the exact rate function through it."""
    return _rk4_step(AL, C, dt, _tangent_dense(h))


@dataclasses.dataclass
class Trajectory:
    """xmps iTDVP.Trajectory analogue: integrate the TDVP flow and report
    Loschmidt echoes (qmps/loschmidts/mps_loschmidts.py:13-27).

    ``h`` may be a dense two-site Hamiltonian matrix OR an `mps.mpo.MPO`
    — the reference's classical comparison drives xmps TDVP with an MPO
    Hamiltonian (`MPO_TFI`, qmps/loschmidts/mps_loschmidts.py:9-27), and
    finite-range / exponentially-decaying models (mpo_nnn_ising,
    mpo_exp_decay) have no two-site form at all.  For a two-site model
    the two plumbing paths agree array-for-array (tests/test_mpo.py:
    mpo_from_two_site(h) trajectories match the dense path to 1e-10).
    ``env_solver`` picks the geometric-sum solver for the MPO/dense
    environments ("dense" O(D^6) below D~32, "gmres" above).

    Match D to the initial state's entanglement: Schmidt values below
    the `_pinv` rcond (1e-6) make the truncated C-inverse corrupt the
    flow rather than guard it (measured on the NNN-Ising g=0.5 ground
    state: D=4 — smallest Schmidt 1e-4 — tracks L=12 ED to 1e-5 over
    t <= 0.4, while D=6/8 — Schmidt 1e-7/1e-8 — deviate at 1e-2 / NaN;
    tests/test_mpo.py::test_nnn_quench_matches_finite_ed)."""

    A0: jnp.ndarray
    h: object  # dense (d^2, d^2) matrix or mps.mpo.MPO
    env_solver: str = "dense"

    def eulerint(self, T: float, n_steps: int):
        """Integrate the flow with a jitted lax.scan of Euler steps."""
        return self._integrate(T, n_steps, _euler_step)

    def rk4int(self, T: float, n_steps: int):
        """Integrate with classical RK4 stages: 4x the per-step cost of
        `eulerint` but stable at the coarse time steps where explicit Euler
        stalls at dynamical phase transitions (see `tdvp_step_rk4`)."""
        return self._integrate(T, n_steps, _rk4_step)

    def _tangent(self):
        from .mpo import MPO, _tangent_mpo  # deferred: mpo imports tdvp

        if isinstance(self.h, MPO):
            return _tangent_mpo(self.h, env_solver=self.env_solver)
        return _tangent_dense(self.h, env_solver=self.env_solver)

    def _integrate(self, T: float, n_steps: int, stepper):
        import jax

        dt = T / n_steps
        AL, AR, C = mixed_gauge(self.A0)
        tangent = self._tangent()

        @jax.jit
        def run(AL, C):
            def step(carry, _):
                AL, C = carry
                ALn, Cn, e = stepper(AL, C, dt, tangent)
                return (ALn, Cn), (ALn, e)

            (ALf, Cf), (ALs, es) = jax.lax.scan(step, (AL, C), None, length=n_steps)
            return ALs, es

        ALs, es = run(AL, C)
        self.ALs = jnp.concatenate([AL[None], ALs])  # (n_steps+1, d, D, D)
        self.es = es
        return self

    def loschmidts(self):
        """|<psi_0 | psi_t>|^2 per site along the trajectory (vmapped)."""
        import jax

        A0 = self.ALs[0]

        def ov(A):
            lam, _ = tr.right_fixed_point(A, A0)
            return jnp.abs(lam) ** 2

        return jax.vmap(ov)(self.ALs[1:])


# -- VUMPS: the variational uniform MPS ground-state solver -------------------
#
# The effective-Hamiltonian machinery above (hamiltonian_environments,
# effective_H_AC, effective_H_C, polar extraction) is exactly the VUMPS
# kit of Zauner-Stauber et al., PRB 97, 045145 (2018): per iteration,
# solve the GROUND eigenvector of H_AC and H_C at fixed environments and
# re-extract (AL, AR) by polar decompositions.  Unlike gradient descent
# on a parametrization, VUMPS converges to the D-OPTIMAL state (gradient
# norm -> 1e-8 and below) even at criticality, where descent methods
# stall on the flat entanglement-tail directions (measured: recycled
# Riemannian descent plateaus at energy error ~2e-4 at D=8/g=1; VUMPS
# reaches the D=8 variational optimum).  The reference has no analogue —
# its best ground-state engine is Nelder-Mead over circuit parameters.
# Everything here is fixed-shape and jittable: Lanczos runs as a
# lax.scan with full reorthogonalization against a (k, n) basis.


def _lanczos_ground(matvec, v0, k: int):
    """(theta, v): approximate SMALLEST eigenpair of a Hermitian operator
    by k-step Lanczos with full reorthogonalization (fixed shapes; the
    small tridiagonal problem is solved dense with eigh)."""
    import jax

    n = v0.shape[0]
    dtype = v0.dtype
    rtype = jnp.zeros(0, dtype).real.dtype
    v0 = v0 / jnp.linalg.norm(v0)

    def step(carry, j):
        V, alpha, beta, v, vprev, b_prev, active = carry
        w = matvec(v) - b_prev * vprev
        a = jnp.real(jnp.vdot(v, w))
        w = w - a * v
        # full reorthogonalization: Lanczos loses orthogonality exactly
        # when it converges; one Gram-Schmidt pass against the whole basis
        # keeps the tridiagonal problem meaningful at k ~ 32
        w = w - V.T @ (V.conj() @ w)
        b = jnp.linalg.norm(w)
        # dtype-aware breakdown threshold: at convergence the
        # reorthogonalized residual is pure roundoff at the scale of the
        # recurrence (|a| + b_prev); a fixed 1e-12 admits f32 noise
        # vectors as Krylov directions (observed: D=4 VUMPS diverging in
        # float32 from random starts while float64 converged)
        ok = b > 64 * jnp.finfo(rtype).eps * (jnp.abs(a) + b_prev + 1.0)
        vn = jnp.where(ok, w / jnp.where(ok, b, 1.0), jnp.zeros_like(w))
        V = V.at[j].set(jnp.where(active, v, jnp.zeros_like(v)))
        alpha = alpha.at[j].set(jnp.where(active, a, 0.0))
        beta = beta.at[j].set(jnp.where(active & ok, b, 0.0))
        mask = jnp.where(active, True, False)
        return (V, alpha, beta, vn, v, b, active & ok), mask

    V0 = jnp.zeros((k, n), dtype)
    (V, alpha, beta, _, _, _, _), mask = jax.lax.scan(
        step,
        (V0, jnp.zeros(k, rtype), jnp.zeros(k, rtype), v0,
         jnp.zeros_like(v0), jnp.zeros((), rtype),
         jnp.ones((), bool)),
        jnp.arange(k),
    )
    # after a breakdown (the Krylov space is exhausted — common at
    # convergence), the remaining tridiagonal rows are zero-coupled
    # padding: give them a diagonal ABOVE the active block's Gershgorin
    # bound so their spurious eigenpairs sort to the top of the spectrum,
    # never competing with the ground value.  The pad is DATA-DERIVED
    # (not a 1e30 literal): eigh's accuracy is absolute in ||T||, so a
    # huge pad would wash out the small ground eigenvalue — fatally in
    # float32, where eps * 1e30 is astronomically larger than theta.
    pad = 1.0 + 2.0 * (jnp.max(jnp.abs(alpha)) + jnp.max(beta))
    alpha = jnp.where(mask, alpha, pad)
    T = (
        jnp.diag(alpha)
        + jnp.diag(beta[: k - 1], 1)
        + jnp.diag(beta[: k - 1], -1)
    ).astype(dtype)
    evals, evecs = jnp.linalg.eigh(T)
    s = evecs[:, 0]  # eigh sorts ascending: column 0 = ground state
    v = V.T @ s.astype(dtype)
    return evals[0], v / jnp.linalg.norm(v)


def _polar_right_rows(M):
    """Orthonormal-ROWS polar factor of a wide matrix (U Vh of its SVD)."""
    u, _, vh = jnp.linalg.svd(M, full_matrices=False)
    return u @ vh


def vumps_step(AL, AR, C, h, k: int = 24, env_solver: str = "dense"):
    """One VUMPS iteration: ground eigenvectors of H_AC and H_C at fixed
    Hamiltonian environments, then gauge re-extraction

        AL' = polar_l(AC') polar_l(C')^dag,
        AR' = polar_r(C')^dag polar_r(AC'),

    (minimizers of |AC' - AL C'| / |AC' - C AR| over isometries).
    Returns (AL, AR, C, e, grad_norm); grad_norm = |H_AC(AC) - AL H_C(C)|
    is the tangent-space gradient norm (zero exactly at the variational
    optimum), evaluated at the INCOMING state."""
    d, D, _ = AL.shape
    HL, HR, e = hamiltonian_environments(AL, AR, C, h, env_solver=env_solver)
    h_shift = h - e * jnp.eye(h.shape[0], dtype=h.dtype)
    AC = jnp.einsum("sij,jk->sik", AL, C)

    gAC = effective_H_AC(AC, AL, AR, HL, HR, h_shift)
    gC = effective_H_C(C, AL, AR, HL, HR, h_shift)
    grad = gAC - jnp.einsum("sij,jk->sik", AL, gC)
    grad_norm = jnp.linalg.norm(grad)

    _, ac = _lanczos_ground(
        lambda x: effective_H_AC(
            x.reshape(d, D, D), AL, AR, HL, HR, h_shift
        ).reshape(-1),
        AC.reshape(-1),
        k,
    )
    _, c = _lanczos_ground(
        lambda x: effective_H_C(
            x.reshape(D, D), AL, AR, HL, HR, h_shift
        ).reshape(-1),
        C.reshape(-1),
        k,
    )
    ACn = ac.reshape(d, D, D)
    Cn = c.reshape(D, D)

    ALn = _extract_AL(ACn, Cn)
    UAC_r = _polar_right_rows(ACn.transpose(1, 0, 2).reshape(D, d * D))
    UC_r = _polar_right_rows(Cn)
    ARn = (cT(UC_r) @ UAC_r).reshape(D, d, D).transpose(1, 0, 2)
    # C carries an arbitrary eigenvector phase; the SVD gauge of the next
    # mixed() call doesn't care, but keep it deterministic for tests
    ph = jnp.exp(-1j * jnp.angle(jnp.trace(Cn)))
    return ALn, ARn, Cn * ph.astype(Cn.dtype), e, grad_norm


import functools as _functools


@_functools.lru_cache(maxsize=32)
def _vumps_program(D: int, iters: int, k: int, env_solver: str = "dense"):
    """One compiled VUMPS program per configuration.  Everything —
    gauge fixing included — runs INSIDE the jit; the state enters as
    float real/imag planes (lax.complex'd in-program) and H as float
    planes."""
    import jax

    @jax.jit
    def run(a0re, a0im, hre, him):
        A0 = jax.lax.complex(a0re, a0im)
        AL, AR, C = mixed_gauge(A0)
        hc = jax.lax.complex(hre, him).astype(AL.dtype)

        def body(carry, _):
            AL, AR, C = carry
            AL, AR, C, e, g = vumps_step(AL, AR, C, hc, k,
                                         env_solver=env_solver)
            return (AL, AR, C), (e, g)

        (AL, AR, C), (es, gs) = jax.lax.scan(
            body, (AL, AR, C), None, length=iters
        )
        # final energy at the RETURNED AL's TRUE right fixed point — the
        # in-iteration estimator tr(h_L C C^dag) assumes C C^dag is AL's
        # fixed point, which only holds at convergence: at grad ~2e-3 it
        # reported energies BELOW the exact ground energy (measured
        # -2e-5 at D=32 where the true returned-state error is +5.7e-6).
        # es keeps the cheap estimator as a convergence history.
        _, rT = tr.right_fixed_point(AL, AL)
        rT = (rT + cT(rT)) / 2
        rT = rT / jnp.trace(rT)
        AL2 = _two_site(AL)
        e = jnp.einsum(
            "uvia,stib,ba,uvst->", AL2.conj(), AL2, rT, _h4(hc)
        ).real
        return AL, C, e, es, gs

    return run


def vumps_ground_state(h, D: int, iters: int = 150, k: int = 24, key=None,
                       A0=None, env_solver: str = "auto"):
    """D-optimal uMPS ground state of the two-site Hamiltonian h by VUMPS.

    Returns (AL, C, energy, info) with info = {"grad_norms": (iters,),
    "energies": (iters,)}; energy is evaluated at the returned AL's
    TRUE transfer fixed point (strictly variational even when the run
    stops before machine convergence), while info["energies"] is the
    cheap in-iteration estimator tr(h_L C C^dag) — a convergence
    history, biased when grad > 0.  Fixed iteration count keeps the whole solver one
    compiled lax.scan program per (D, iters, k) — check
    info["grad_norms"][-1] for convergence; ~1e-6 by iteration 100 at
    D=8, g=1 in f64.  A0 (e.g. a lower-D solution grown by bond
    embedding) may be a complex device array: it is split into float
    planes by a jitted device-side op, never transferred to the host."""
    import jax
    import numpy as np

    h_host = np.asarray(h)
    # working precision follows the inputs (A0's dtype wins, then h's),
    # falling back to the session default — so a complex64 chain stays
    # complex64 even under global x64.  A0's dtype is read WITHOUT
    # jnp.asarray (no transfer just to learn a dtype)
    f64 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if A0 is not None:
        a0_dtype = np.dtype(getattr(A0, "dtype", np.float64))
        ftype = jnp.float32 if a0_dtype in (np.complex64, np.float32) else f64
    else:
        ftype = (
            jnp.float32 if h_host.dtype in (np.float32, np.complex64) else f64
        )
    hre = jnp.asarray(np.ascontiguousarray(h_host.real), ftype)
    him = jnp.asarray(np.ascontiguousarray(h_host.imag), ftype)

    if A0 is None:
        d = int(round(h_host.shape[0] ** 0.5))
        key = jax.random.PRNGKey(0) if key is None else key
        k1, k2 = jax.random.split(key)
        a0re = jax.random.normal(k1, (d, D, D), ftype)
        a0im = jax.random.normal(k2, (d, D, D), ftype)
    elif isinstance(A0, np.ndarray):
        # host array: split on the HOST — a complex numpy array through
        # jnp (transfer or jit arg) is the rule-6 silent failure
        a0re = jnp.asarray(np.ascontiguousarray(A0.real), ftype)
        a0im = jnp.asarray(np.ascontiguousarray(A0.imag), ftype)
    else:
        # device array: split device-side (complex DEVICE arrays are fine
        # as jit ARGUMENTS — DESIGN.md rule 8 — only transfers/closures
        # are not)
        a0re, a0im = jax.jit(
            lambda A: (jnp.real(A).astype(ftype), jnp.imag(A).astype(ftype))
        )(A0)

    if env_solver == "auto":
        # dense geometric-sum solves are O(D^6): past D ~ 24 the
        # fixed-shape restarted GMRES (O(d D^3) per step) wins and is
        # the only tractable route at D = 64
        env_solver = "dense" if D <= 24 else "gmres"
    run = _vumps_program(D, iters, k, env_solver)
    AL, C, e, es, gs = run(a0re, a0im, hre, him)
    return AL, C, float(e), {"grad_norms": gs, "energies": es}


def vumps_ground_state_converged(h, D: int, tol: float = 3e-4,
                                 chunk_iters: int = 150, max_iters: int = 600,
                                 k: int = 48, key=None, A0=None,
                                 env_solver: str = "auto"):
    """VUMPS run to a GRADIENT-NORM knee instead of a fixed window.

    The fixed-iteration program (`vumps_ground_state`) is one compiled
    lax.scan — and the knob that decides whether the knee is reachable
    at all is the LANCZOS DEPTH ``k``, not the window: an f32 attribution
    grid at D=32 (both env solvers) put k=24 on a grad floor of ~5e-4 (f64 err ~1e-5) that 900 iterations
    never broke, while k=48 passed grad 1.3e-4 / f64 err 1.8e-7 within
    150 iterations — the per-iteration eigensolve residual is
    re-injected each step and shallow subspaces recycle it forever.
    (k=32 DIVERGED outright from the probe seed — f32 Lanczos between
    the two regimes can lock onto a wrong basin; prefer 48.)  Default
    k=48 accordingly.  This wrapper reuses THE SAME compiled chunk
    program in a host loop, warm-restarting from the returned AL (a
    device array — re-entering costs one mixed_gauge), and stops at the
    first chunk whose final gradient norm is <= tol or at
    ``max_iters``.

    Returns (AL, C, e, info); info adds to the fixed-window contract:
    - "grad_norms"/"energies": concatenated over all chunks run;
    - "total_iters": iterations actually executed;
    - "iters_to_knee": first 1-based iteration with grad <= tol, or -1
      if the run ended above tol (an f32 plateau or too-small window —
      callers should report, not assume).
    """
    import numpy as np

    grad_hist, e_hist = [], []
    AL = C = e = None
    warm = A0
    total = 0
    while total < max_iters:
        AL, C, e, info = vumps_ground_state(
            h, D, iters=chunk_iters, k=k, key=key, A0=warm,
            env_solver=env_solver,
        )
        grad_hist.append(np.asarray(info["grad_norms"]))
        e_hist.append(np.asarray(info["energies"]))
        total += chunk_iters
        if grad_hist[-1][-1] <= tol:
            break
        warm = AL
    gs = np.concatenate(grad_hist)
    below = np.nonzero(gs <= tol)[0]
    info = {
        "grad_norms": gs,
        "energies": np.concatenate(e_hist),
        "total_iters": total,
        "iters_to_knee": int(below[0]) + 1 if below.size else -1,
    }
    return AL, C, e, info


@_functools.lru_cache(maxsize=32)
def _variance_program(D: int, d: int, k: int, restarts: int,
                      env_solver: str):
    import jax

    @jax.jit
    def run(AL, hre, him):
        h = jax.lax.complex(hre, him).astype(AL.dtype)
        _, r = tr.right_fixed_point(AL, AL)
        r = (r + cT(r)) / 2
        r = r / jnp.trace(r)
        return energy_variance_density(AL, r, h, env_solver=env_solver,
                                       k=k, restarts=restarts)

    return run


def variance_certificate(AL, h, env_solver: str = "auto", k: int = 48,
                         restarts: int = 8) -> float:
    """Oracle-free convergence certificate of a left-canonical state:
    the per-site energy variance sigma^2 of AL under the two-site h,
    evaluated at AL's TRUE right fixed point (`energy_variance_density`
    with the r recomputed — callers hand in just the state).  sigma^2 =
    0 iff AL is an exact eigenstate; |E - E_0| <= sigma^2 / gap.  AL may
    be a complex DEVICE array (jit argument — DESIGN.md rule 8); h is a
    host matrix, split into float planes like every other entry point."""
    import numpy as np

    d, D, _ = AL.shape
    if env_solver == "auto":
        env_solver = "dense" if D <= 24 else "gmres"
    h_host = np.asarray(h)
    # working precision follows the STATE (the certificate is about AL)
    ftype = np.float32 if np.dtype(AL.dtype) == np.complex64 else np.float64
    hre = jnp.asarray(np.ascontiguousarray(h_host.real), ftype)
    him = jnp.asarray(np.ascontiguousarray(h_host.imag), ftype)
    run = _variance_program(int(D), int(d), k, restarts, env_solver)
    return float(np.asarray(run(AL, hre, him)))


def vumps_ground_state_cell2(h, D: int, iters: int = 150, k: int = 24,
                             key=None, A0=None):
    """Two-site unit-cell VUMPS by cell blocking.

    Blocks the chain into d^2-dimensional cells (ham.block_two_site) and
    runs the single-site solver on the blocked chain — this is how the
    bare (un-rotated) antiferromagnets converge: their Neel-ordered
    ground states are only 2-periodic, which stalls single-site VUMPS at
    gradient norm O(1), but the blocked chain is uniform.  Returns
    (AL_cell, C, e, info) with AL_cell of shape (d^2, D, D) — one tensor
    per CELL — and e, info["energies"] already divided by 2, i.e. per
    ORIGINAL site.  Split AL_cell into two site tensors with
    `split_cell`.  A0, if given, must be a blocked (d^2, D, D) tensor."""
    import numpy as np

    from ..ham.hamiltonian import block_two_site

    h_host = np.asarray(h)
    hb = block_two_site(h_host)
    # preserve the caller's working precision: vumps_ground_state infers
    # f32-vs-f64 planes from h's dtype, and block_two_site promotes to
    # float64 numpy
    if h_host.dtype in (np.float32, np.complex64):
        hb = hb.astype(np.complex64 if hb.dtype.kind == "c" else np.float32)
    AL, C, e2, info = vumps_ground_state(hb, D, iters=iters, k=k, key=key,
                                         A0=A0)
    info = dict(info)
    info["energies"] = info["energies"] / 2.0
    return AL, C, e2 / 2.0, info


def split_cell(A_cell, D_max: int | None = None):
    """(A1, A2, s): split a blocked cell tensor (d^2, D, D) into two
    site tensors A1 (d, D, m), A2 (d, m, D) by SVD of the bond inside
    the cell.

    With D_max=None the split is EXACT (m = d*D up to numerical rank):
    einsum('sim,tmj->stij', A1, A2) reassembles A_cell[(s t), i, j];
    s are the bare singular values of the reshaped tensor.

    With D_max, the truncation keeps the D_max largest SCHMIDT
    directions of the internal cut: for a LEFT-CANONICAL A_cell the
    cut's Schmidt coefficients are the singular values of A_cell with
    its right virtual leg weighted by a factor F with F F^dag = r (the
    right fixed point of the cell's transfer map) — SVDing the bare
    tensor instead keeps gauge-large but physically light directions
    (measured on the blocked TFIM state: principal-subspace overlap
    0.9958 != 1 against the r-weighted cut).  The right leg is
    unweighted after the SVD, so A1 . A2 approximates A_cell in the
    ORIGINAL gauge; returned s are the (unit-norm) Schmidt values."""
    dd, Dl, Dr = A_cell.shape
    d = int(round(dd ** 0.5))
    A4 = A_cell.reshape(d, d, Dl, Dr)
    if D_max is None:
        M = A4.transpose(0, 2, 1, 3).reshape(d * Dl, d * Dr)
        u, s, vh = jnp.linalg.svd(M, full_matrices=False)
        m = s.shape[0]
        sq = jnp.sqrt(s).astype(A_cell.dtype)
        A1 = (u * sq[None, :]).reshape(d, Dl, m)
        A2 = (sq[:, None] * vh).reshape(m, d, Dr).transpose(1, 0, 2)
        return A1, A2, s

    from .imps import _cholesky_psd

    _, r = tr.right_fixed_point(A_cell, A_cell)
    r = (r + cT(r)) / 2
    r = r / jnp.trace(r)
    F = _cholesky_psd(r)
    Mw = jnp.einsum("stij,jk->sitk", A4, F).reshape(d * Dl, d * Dr)
    u, s, vh = jnp.linalg.svd(Mw, full_matrices=False)
    m = min(D_max, s.shape[0])
    sq = jnp.sqrt(s[:m]).astype(A_cell.dtype)
    A1 = (u[:, :m] * sq[None, :]).reshape(d, Dl, m)
    A2w = (sq[:, None] * vh[:m, :]).reshape(m, d, Dr)
    A2 = jnp.einsum("mtk,kj->tmj", A2w, _pinv(F))
    return A1, A2, s[:m]
