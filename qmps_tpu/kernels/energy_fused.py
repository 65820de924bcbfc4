"""Fully fused batched D = 2 ground-state ENERGY objective.

The config-4 phase-diagram sweep's per-step cost is value_and_grad of
energy_exact_env(ansatz(p), h(g)) per point (objectives/energy.py:30-42;
the reference's per-point optimization is its
scripts/ground_state_finding.py:100-154).  As plain XLA the
energy-from-tensor pipeline — blocked transfer build, right fixed point,
<h> contraction, and the fixed point's implicit adjoint — is a 48-step
scan of batched 4x4 complex products plus a K=24 series: on the order of
a hundred small launches per optimizer step.  This module fuses the
whole objective for D = 2: forward AND backward are one Pallas launch
each (Triton route), every batch element's component planes held in
registers for the whole solve.

Math (per element; A left-canonical by construction — it comes from
unitary_to_tensor of a unitary, so sum_s A_s^dag A_s = I exactly):

  AA[(s1 s2)] = A_s1 A_s2                        (2x2 bond blocks)
  E[(i j), (k l)] = sum_s AA[s, i, k] conj(AA[s, j, l])
  (lam, v) = dominant right eigenpair of E       (lam = 1 analytically)
  r = herm(v) / tr(herm(v)),  herm(M) = (M + M^dag)/2
  e = Re sum_{t,s} h[t, s] tr_bond( AA_s r AA_t^dag )

Backward: e depends on A directly (three AA slots) and through r.  The
eigenVECTOR adjoint is NOT rank-1 (unlike the eigenvalue-only TDVP
objective): with T = lam I - E singular along (v, u^dag), u = vec(I)
exactly (left-canonicality gives u^dag E = lam u^dag), the cotangent
back through v = eig(E) is

  Ebar = z v^T,   T^T z = P^T vbar   (P deflates the gauge direction)

solved in LOG time by the product-form geometric series
  (I - X)^{-1} = prod_k (I + X^(2^k)),  X = (E^T - lam w v^T/(v^T w))/lam
(w = conj(u); spectral radius |lam_2/lam| < 1 for injective MPS, so K
doublings cover 2^K series terms — near-critical gaps ~0.99 converge at
K ~ 24 where a plain Neumann sum needs thousands of terms).  All chain
pieces (trace-normalization quotient, hermitization projector, the
transposed E-build, the transposed AA-build) are closed-form plane
contractions; validated against jax.grad of objectives.energy
.energy_exact_env to 1e-10 (tests/test_energy_fused.py).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["energy_objective_fused", "default_engine"]

#: batch elements per Triton program, and the warps that share them
#: (one element per thread); no sweep over (BLOCK, warps) yet (PERF.md)
BLOCK = 32
NUM_WARPS = 1


# ---------------------------------------------------------------------------
# XLA reference implementation (the kernel's specification, the engine
# off the GPU, and the test oracle glue)
# ---------------------------------------------------------------------------


def _build(As):
    """(B, 2, 2, 2) -> AA (B, 4, 2, 2), E (B, 4, 4)."""
    AA = jnp.einsum("bsik,btkj->bstij", As, As).reshape(-1, 4, 2, 2)
    E = jnp.einsum("bsik,bsjl->bijkl", AA, AA.conj()).reshape(-1, 4, 4)
    return AA, E


def _energy_from_parts(AA, r2, hs):
    """e = Re sum h[t,s] AA[s,i,j] r2[j,k] conj(AA[t,i,k])."""
    T = jnp.einsum("bsij,bjk,btik->bts", AA, r2, AA.conj())
    return jnp.einsum("bts,bts->b", hs.astype(T.dtype), T).real


def _r_chain(v):
    """v (B, 4) raw eigenvector -> r2 (B, 2, 2) hermitized trace-1."""
    r0 = v.reshape(-1, 2, 2)
    r1 = (r0 + jnp.swapaxes(r0, -1, -2).conj()) / 2.0
    tau = jnp.trace(r1, axis1=-2, axis2=-1)
    return r1 / tau[:, None, None]


def _eig_right_xla(E, iters):
    """Dominant right eigenpair by normalized repeated squaring (the same
    algorithm as the kernel's solve; jittable, any backend)."""
    def step(M, _):
        M2 = M @ M
        n = jnp.sqrt(jnp.sum(jnp.abs(M2) ** 2, axis=(-2, -1), keepdims=True))
        return M2 / jnp.maximum(n, 1e-30), None

    Mk, _ = jax.lax.scan(step, E / 2.0, None, length=iters)
    # dominant column (E^(2^k) -> lam^(2^k) v u^dag): pick the largest
    j = jnp.argmax(jnp.sum(jnp.abs(Mk), axis=-2), axis=-1)
    v = jnp.take_along_axis(Mk, j[:, None, None], axis=-1)[..., 0]
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    lam = jnp.einsum("bi,bij,bj->b", v.conj(), E, v)  # Rayleigh (v normed)
    return lam, v


def _trace_phase(v):
    """Rotate a unit eigenvector v (B, 4) = vec(r) so that tr(r) is real
    and positive.  The energy is invariant to v's phase, but the
    hermitization herm(e^{i phi} rho) = cos(phi) rho loses all of rho to
    cancellation as phi -> pi/2: in float32 an arbitrary phase costs up to
    ~1e-4 in the energy.  Any fixed phase is a valid eigenvector for the
    adjoint below (its deflation removes the gauge direction)."""
    t = v[:, 0] + v[:, 3]
    return v * (jnp.conj(t) / jnp.maximum(jnp.abs(t), 1e-30))[:, None]


def _energy_fwd_xla(As, hs, iters):
    AA, E = _build(As)
    lam, v = _eig_right_xla(E, iters)
    v = _trace_phase(v)
    r2 = _r_chain(v)
    e = _energy_from_parts(AA, r2, hs)
    return e, lam, v


def _series_apply_T(E, lam, v, q, K):
    """z = (lam I - E^T + lam w v^T/(v^T w))^{-1} P^T q via the
    product-form geometric series; w = vec(I) (left-canonical A).

    P^T projects q onto the solvable subspace (v^T q = 0 after
    projection): q <- q - w (v^T q)/(v^T w).
    """
    B = q.shape[0]
    w = jnp.zeros((4,), q.dtype).at[0].set(1.0).at[3].set(1.0)  # vec(I)
    vw = jnp.einsum("bi,i->b", v, w)
    q = q - jnp.einsum("bi,bi->b", v, q)[:, None] / vw[:, None] * w[None, :]
    # X = (E^T - lam w v^T / (v^T w)) / lam ;  z = (1/lam) sum X^k q
    X = (
        jnp.swapaxes(E, -1, -2)
        - lam[:, None, None] * w[None, :, None] * v[:, None, :] / vw[:, None, None]
    ) / lam[:, None, None]

    def step(carry, _):
        x, M = carry
        return (x + jnp.einsum("bij,bj->bi", M, x), M @ M), None

    (z, _), _ = jax.lax.scan(step, (q, X), None, length=K)
    return z / lam[:, None]


def _energy_bwd_xla(As, hs, lam, v, ct, K=24):
    """Hand-derived adjoint: returns (Abar, hbar) in the JAX pairing
    convention (de = Re sum Abar dA for the complex leaf)."""
    AA, E = _build(As)
    r0 = v.reshape(-1, 2, 2)
    r1 = (r0 + jnp.swapaxes(r0, -1, -2).conj()) / 2.0
    tau = jnp.trace(r1, axis1=-2, axis2=-1)
    r2 = r1 / tau[:, None, None]
    ctc = ct.astype(As.dtype)

    # ---- direct energy-contraction terms ----
    # e = Re S, S = sum h[t,s] AA[s,i,j] r2[j,k] conj(AA[t,i,k])
    T = jnp.einsum("bsij,bjk,btik->bts", AA, r2, AA.conj())
    hbar = T * ctc[:, None, None]
    h_ = hs.astype(As.dtype)
    # pairs dAA (ket slot):
    AAbar_d = jnp.einsum("b,bts,bjk,btik->bsij", ctc, h_, r2, AA.conj())
    # pairs conj(dAA) (bra slot) -> conjugate partner:
    AAbar_d = AAbar_d + jnp.einsum(
        "b,bts,bsij,bjk->btik", ctc, h_, AA, r2
    ).conj()
    # pairs dr2:
    r2bar = jnp.einsum("b,bts,bsij,btik->bjk", ctc, h_, AA, AA.conj())

    # ---- r2 = r1 / tau ----
    inner = jnp.einsum("bjk,bjk->b", r2bar, r1)
    r1bar = r2bar / tau[:, None, None] - (inner / tau**2)[:, None, None] * jnp.eye(
        2, dtype=As.dtype
    )[None]
    # ---- r1 = (r0 + r0^dag)/2 ----
    r0bar = (r1bar + jnp.swapaxes(r1bar, -1, -2).conj()) / 2.0
    vbar = r0bar.reshape(-1, 4)

    # ---- v = dominant eigvec of E (implicit adjoint, deflated series) ----
    z = _series_apply_T(E, lam, v, vbar, K)
    Ebar = z[:, :, None] * v[:, None, :]  # Ebar[(ij),(kl)] = z_(ij) v_(kl)

    # ---- E build: E = sum_s AA[s,i,k] conj(AA[s,j,l]) ----
    Eb = Ebar.reshape(-1, 2, 2, 2, 2)  # (B, i, j, k, l)
    AAbar_E = jnp.einsum("bijkl,bsjl->bsik", Eb, AA.conj())
    AAbar_E = AAbar_E + jnp.einsum("bijkl,bsik->bsjl", Eb, AA).conj()

    # ---- AA build: AA[(s1 s2), i, j] = sum_k A[s1,i,k] A[s2,k,j] ----
    G = (AAbar_d + AAbar_E).reshape(-1, 2, 2, 2, 2)  # (B, s1, s2, i, j)
    Abar = jnp.einsum("zstaj,ztbj->zsab", G, As) + jnp.einsum(
        "ztsib,ztia->zsab", G, As
    )
    return Abar, hbar


# ---------------------------------------------------------------------------
# Pallas kernels (Triton route): the same math on component planes, whole
# objective (and whole adjoint) each in ONE launch.  A plane is the (BLOCK,)
# vector of one real scalar component across the program's batch elements;
# every helper below is an unrolled stream of elementwise FMAs on planes.
# ---------------------------------------------------------------------------


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _plane_AA(are, aim):
    """AA[(s1 s2), i, j] = sum_k A[s1, i, k] A[s2, k, j] as a plane dict
    (the two-site blocking)."""
    aa = {}
    for s1 in range(2):
        for s2 in range(2):
            for i in range(2):
                for j in range(2):
                    sr = si = None
                    for k in range(2):
                        pr, pi = _cmul(
                            are[s1 * 4 + i * 2 + k], aim[s1 * 4 + i * 2 + k],
                            are[s2 * 4 + k * 2 + j], aim[s2 * 4 + k * 2 + j],
                        )
                        sr = pr if sr is None else sr + pr
                        si = pi if si is None else si + pi
                    aa[(s1 * 2 + s2, i, j)] = (sr, si)
    return aa


def _chirps(N: int):
    """Two fixed pseudo-random start vectors as python scalar pairs (they
    inline into the kernel as constants)."""
    c1 = [(math.cos(0.7 * j + 0.3), math.sin(1.3 * j + 1.1)) for j in range(N)]
    c2 = [(math.cos(1.9 * j + 0.8), math.sin(0.5 * j + 2.0)) for j in range(N)]
    return c1, c2


def _solve_planes(iters, m_re, m_im):
    """Dominant eigenpair of a batch of 4x4 matrices given as 16 re/im
    planes: ``iters`` Frobenius-normalized squarings (error ~
    |lam2/lam1|^(2^iters)), the eigenvector from applying the converged
    power to two fixed chirps (the larger result wins, per element), and
    the eigenvalue as the Rayleigh quotient with the ORIGINAL matrix.
    Returns (lre, lim, vre, vim) with v unit-norm."""
    N = 4

    def body(_, carry):
        e_re = list(carry[: N * N])
        e_im = list(carry[N * N :])
        r_re, r_im = [], []
        for a in range(N):
            for b in range(N):
                sre = sim = None
                for k in range(N):
                    pr, pi = _cmul(e_re[a * N + k], e_im[a * N + k],
                                   e_re[k * N + b], e_im[k * N + b])
                    sre = pr if sre is None else sre + pr
                    sim = pi if sim is None else sim + pi
                r_re.append(sre)
                r_im.append(sim)
        n2 = sum(rr * rr + ii * ii for rr, ii in zip(r_re, r_im))
        inv = jax.lax.rsqrt(jnp.maximum(n2, 1e-30))
        return tuple(rr * inv for rr in r_re) + tuple(ii * inv for ii in r_im)

    carry = jax.lax.fori_loop(0, iters, body, tuple(m_re) + tuple(m_im))
    e_re, e_im = list(carry[: N * N]), list(carry[N * N :])

    # E^(2^k) ~ lam^(2^k) v w^dag: applying it to any vector not orthogonal
    # to w yields v
    def apply_chirp(c):
        vre, vim = [], []
        for i in range(N):
            are = aim = None
            for j in range(N):
                pr, pi = _cmul(e_re[i * N + j], e_im[i * N + j], *c[j])
                are = pr if are is None else are + pr
                aim = pi if aim is None else aim + pi
            vre.append(are)
            vim.append(aim)
        return vre, vim

    c1, c2 = _chirps(N)
    v1re, v1im = apply_chirp(c1)
    v2re, v2im = apply_chirp(c2)
    n1 = sum(r * r + i2 * i2 for r, i2 in zip(v1re, v1im))
    n2 = sum(r * r + i2 * i2 for r, i2 in zip(v2re, v2im))
    use1 = n1 >= n2
    vre = [jnp.where(use1, a, b) for a, b in zip(v1re, v2re)]
    vim = [jnp.where(use1, a, b) for a, b in zip(v1im, v2im)]
    inv = jax.lax.rsqrt(jnp.maximum(jnp.maximum(n1, n2), 1e-30))
    vre = [r * inv for r in vre]
    vim = [i2 * inv for i2 in vim]

    # Rayleigh quotient with the original E (v unit norm)
    lre = lim = None
    for i in range(N):
        wr = wi = None
        for j in range(N):
            pr, pi = _cmul(m_re[i * N + j], m_im[i * N + j], vre[j], vim[j])
            wr = pr if wr is None else wr + pr
            wi = pi if wi is None else wi + pi
        # conj(v_i) * w_i
        pr, pi = _cmul(vre[i], -vim[i], wr, wi)
        lre = pr if lre is None else lre + pr
        lim = pi if lim is None else lim + pi
    return lre, lim, vre, vim


def _plane_E(aa):
    """E[(i j),(k l)] = sum_s AA[s,i,k] conj(AA[s,j,l]): 16 plane pairs."""
    e_re = [None] * 16
    e_im = [None] * 16
    for i in range(2):
        for j in range(2):
            for k in range(2):
                for l in range(2):
                    sr = si = None
                    for s in range(4):
                        xr, xi = aa[(s, i, k)]
                        yr, yi = aa[(s, j, l)]
                        pr, pi = _cmul(xr, xi, yr, -yi)
                        sr = pr if sr is None else sr + pr
                        si = pi if si is None else si + pi
                    e_re[(i * 2 + j) * 4 + (k * 2 + l)] = sr
                    e_im[(i * 2 + j) * 4 + (k * 2 + l)] = si
    return e_re, e_im


def _plane_r_chain(vre, vim):
    """v (4 plane pairs) -> r2 dict[(a, b)], tau (re, im), den=1/|tau|^2."""
    r1 = {}
    for a in range(2):
        for b in range(2):
            # r1[a,b] = (r0[a,b] + conj(r0[b,a])) / 2
            r1[(a, b)] = (
                (vre[a * 2 + b] + vre[b * 2 + a]) * 0.5,
                (vim[a * 2 + b] - vim[b * 2 + a]) * 0.5,
            )
    tre = r1[(0, 0)][0] + r1[(1, 1)][0]
    tim = r1[(0, 0)][1] + r1[(1, 1)][1]
    den = 1.0 / jnp.maximum(tre * tre + tim * tim, 1e-30)
    r2 = {}
    for a in range(2):
        for b in range(2):
            xr, xi = r1[(a, b)]
            r2[(a, b)] = (
                (xr * tre + xi * tim) * den,
                (xi * tre - xr * tim) * den,
            )
    return r1, r2, (tre, tim), den


def _plane_M_T(aa, r2):
    """M[s,i,k] = sum_j AA[s,i,j] r2[j,k]; T[t,s] = sum_ik M[s,i,k]
    conj(AA[t,i,k])."""
    M = {}
    for s in range(4):
        for i in range(2):
            for k in range(2):
                sr = si = None
                for j in range(2):
                    ar, ai = aa[(s, i, j)]
                    rr, ri = r2[(j, k)]
                    pr, pi = _cmul(ar, ai, rr, ri)
                    sr = pr if sr is None else sr + pr
                    si = pi if si is None else si + pi
                M[(s, i, k)] = (sr, si)
    T = {}
    for t in range(4):
        for s in range(4):
            sr = si = None
            for i in range(2):
                for k in range(2):
                    mr, mi = M[(s, i, k)]
                    ar, ai = aa[(t, i, k)]
                    pr, pi = _cmul(mr, mi, ar, -ai)
                    sr = pr if sr is None else sr + pr
                    si = pi if si is None else si + pi
            T[(t, s)] = (sr, si)
    return M, T


def _hget(hre_ref, him_ref):
    """h[t, s] accessor over the 16 entries, each loaded once.  A shared
    h is a (16,) operand and each entry a scalar; a batched h is
    (16, BLOCK) planes.  The arithmetic broadcasts either way."""
    hre = [hre_ref[k] for k in range(16)]
    him = [him_ref[k] for k in range(16)]
    return lambda t, s: (hre[t * 4 + s], him[t * 4 + s])


def _energy_fwd_kernel(
    iters, with_v,
    are_ref, aim_ref, hre_ref, him_ref,
    *out_refs,
):
    are = [are_ref[k] for k in range(8)]
    aim = [aim_ref[k] for k in range(8)]
    hget = _hget(hre_ref, him_ref)

    aa = _plane_AA(are, aim)
    e_re, e_im = _plane_E(aa)
    lre, lim, vre, vim = _solve_planes(iters, e_re, e_im)
    # tr(r) real and positive (see _trace_phase)
    tre, tim = vre[0] + vre[3], vim[0] + vim[3]
    inv = jax.lax.rsqrt(jnp.maximum(tre * tre + tim * tim, 1e-30))
    vre, vim = (
        [(x * tre + y * tim) * inv for x, y in zip(vre, vim)],
        [(y * tre - x * tim) * inv for x, y in zip(vre, vim)],
    )
    _, r2, _, _ = _plane_r_chain(vre, vim)
    _, T = _plane_M_T(aa, r2)

    e = None
    for t in range(4):
        for s in range(4):
            hr, hi = hget(t, s)
            tr_, ti_ = T[(t, s)]
            term = hr * tr_ - hi * ti_
            e = term if e is None else e + term

    out_refs[0][...] = e
    if with_v:
        out_refs[1][...] = lre
        out_refs[2][...] = lim
        for i in range(4):
            out_refs[3][i] = vre[i]
            out_refs[4][i] = vim[i]


def _energy_bwd_kernel(
    K,
    are_ref, aim_ref, hre_ref, him_ref,
    vre_ref, vim_ref, lre_ref, lim_ref, ct_ref,
    oar, oai, ohr, ohi,
):
    are = [are_ref[k] for k in range(8)]
    aim = [aim_ref[k] for k in range(8)]
    hget = _hget(hre_ref, him_ref)
    vre = [vre_ref[i] for i in range(4)]
    vim = [vim_ref[i] for i in range(4)]
    lre, lim = lre_ref[...], lim_ref[...]
    ct = ct_ref[...]

    aa = _plane_AA(are, aim)
    e_re, e_im = _plane_E(aa)
    r1, r2, (tre, tim), den = _plane_r_chain(vre, vim)
    M, T = _plane_M_T(aa, r2)

    # hbar[t, s] = ct * T[t, s]  (complex; real-h consumers take the real
    # plane — the XLA side casts)
    for t in range(4):
        for s in range(4):
            tr_, ti_ = T[(t, s)]
            ohr[t * 4 + s] = ct * tr_
            ohi[t * 4 + s] = ct * ti_

    # ---- direct AA pullbacks ----
    # Q[s,i,k] = sum_t h[t,s] conj(AA[t,i,k]) serves both
    #   AAbar_d1[s,i,j] = ct sum_k r2[j,k] Q[s,i,k]
    #   r2bar[j,k]     = ct sum_{s,i} AA[s,i,j] Q[s,i,k]
    # and AAbar_d2[t,i,k] = ct conj( sum_s h[t,s] M[s,i,k] )
    Q = {}
    for s in range(4):
        for i in range(2):
            for k in range(2):
                sr = si = None
                for t in range(4):
                    hr, hi = hget(t, s)
                    ar, ai = aa[(t, i, k)]
                    pr, pi = _cmul(hr, hi, ar, -ai)
                    sr = pr if sr is None else sr + pr
                    si = pi if si is None else si + pi
                Q[(s, i, k)] = (sr, si)
    G = {}
    for s in range(4):
        for i in range(2):
            for j in range(2):
                sr = si = None
                for k in range(2):
                    rr, ri = r2[(j, k)]
                    qr, qi = Q[(s, i, k)]
                    pr, pi = _cmul(rr, ri, qr, qi)
                    sr = pr if sr is None else sr + pr
                    si = pi if si is None else si + pi
                G[(s, i, j)] = (ct * sr, ct * si)
    for t in range(4):
        for i in range(2):
            for k in range(2):
                sr = si = None
                for s in range(4):
                    hr, hi = hget(t, s)
                    mr, mi = M[(s, i, k)]
                    pr, pi = _cmul(hr, hi, mr, mi)
                    sr = pr if sr is None else sr + pr
                    si = pi if si is None else si + pi
                gr, gi = G[(t, i, k)]
                G[(t, i, k)] = (gr + ct * sr, gi - ct * si)  # + conj

    r2bar = {}
    for j in range(2):
        for k in range(2):
            sr = si = None
            for s in range(4):
                for i in range(2):
                    ar, ai = aa[(s, i, j)]
                    qr, qi = Q[(s, i, k)]
                    pr, pi = _cmul(ar, ai, qr, qi)
                    sr = pr if sr is None else sr + pr
                    si = pi if si is None else si + pi
            r2bar[(j, k)] = (ct * sr, ct * si)

    # ---- r1bar = r2bar / tau - (sum r2bar*r1)/tau^2 * I ----
    inr = ini = None
    for a in range(2):
        for b in range(2):
            br, bi = r2bar[(a, b)]
            xr, xi = r1[(a, b)]
            pr, pi = _cmul(br, bi, xr, xi)
            inr = pr if inr is None else inr + pr
            ini = pi if ini is None else ini + pi
    # inner / tau^2 = inner * conj(tau)^2 * den^2
    t2r, t2i = _cmul(tre, -tim, tre, -tim)
    c2r, c2i = _cmul(inr, ini, t2r * den * den, t2i * den * den)
    r1bar = {}
    for a in range(2):
        for b in range(2):
            br, bi = r2bar[(a, b)]
            # divide by tau: * conj(tau) * den
            dr = (br * tre + bi * tim) * den
            di = (bi * tre - br * tim) * den
            if a == b:
                dr = dr - c2r
                di = di - c2i
            r1bar[(a, b)] = (dr, di)

    # ---- r0bar = (r1bar + conj(r1bar^T))/2 -> vbar (4 comps) ----
    vbar = [None] * 4
    for a in range(2):
        for b in range(2):
            xr, xi = r1bar[(a, b)]
            yr, yi = r1bar[(b, a)]
            vbar[a * 2 + b] = ((xr + yr) * 0.5, (xi - yi) * 0.5)

    # ---- project onto the solvable subspace: q = vbar - (v.q)/(v.w) w,
    # w = vec(I) (comps 0 and 3) ----
    vqr = vqi = None
    for i in range(4):
        pr, pi = _cmul(vre[i], vim[i], vbar[i][0], vbar[i][1])
        vqr = pr if vqr is None else vqr + pr
        vqi = pi if vqi is None else vqi + pi
    vwr = vre[0] + vre[3]
    vwi = vim[0] + vim[3]
    wden = 1.0 / jnp.maximum(vwr * vwr + vwi * vwi, 1e-30)
    # alpha = (v.q)/(v.w)
    ar_ = (vqr * vwr + vqi * vwi) * wden
    ai_ = (vqi * vwr - vqr * vwi) * wden
    q = list(vbar)
    for i in (0, 3):
        q[i] = (q[i][0] - ar_, q[i][1] - ai_)

    # ---- X = (E^T - lam w v^T/(v.w)) / lam ;  z = (1/lam) sum_k X^k q ----
    lden = 1.0 / jnp.maximum(lre * lre + lim * lim, 1e-30)
    X_re = [None] * 16
    X_im = [None] * 16
    for i in range(4):
        for j in range(4):
            xr = e_re[j * 4 + i]  # E^T
            xi = e_im[j * 4 + i]
            if i in (0, 3):
                # minus lam * v_j / (v.w): lam cancels with the outer /lam
                # only partially — keep explicit: s_ij = lam * w_i v_j / vw
                pr, pi = _cmul(lre, lim, vre[j], vim[j])
                qr = (pr * vwr + pi * vwi) * wden
                qi = (pi * vwr - pr * vwi) * wden
                xr = xr - qr
                xi = xi - qi
            # divide by lam
            X_re[i * 4 + j] = (xr * lre + xi * lim) * lden
            X_im[i * 4 + j] = (xi * lre - xr * lim) * lden

    def body(_, carry):
        x_re = list(carry[:4])
        x_im = list(carry[4:8])
        m_re = list(carry[8:24])
        m_im = list(carry[24:40])
        nx_re, nx_im = [], []
        for i in range(4):
            sr, si = x_re[i], x_im[i]
            for j in range(4):
                pr, pi = _cmul(m_re[i * 4 + j], m_im[i * 4 + j], x_re[j], x_im[j])
                sr = sr + pr
                si = si + pi
            nx_re.append(sr)
            nx_im.append(si)
        nm_re, nm_im = [], []
        for a in range(4):
            for b in range(4):
                sr = si = None
                for k in range(4):
                    pr, pi = _cmul(
                        m_re[a * 4 + k], m_im[a * 4 + k],
                        m_re[k * 4 + b], m_im[k * 4 + b],
                    )
                    sr = pr if sr is None else sr + pr
                    si = pi if si is None else si + pi
                nm_re.append(sr)
                nm_im.append(si)
        return tuple(nx_re) + tuple(nx_im) + tuple(nm_re) + tuple(nm_im)

    carry = (
        tuple(p[0] for p in q) + tuple(p[1] for p in q)
        + tuple(X_re) + tuple(X_im)
    )
    carry = jax.lax.fori_loop(0, K, body, carry)
    z = []
    for i in range(4):
        xr, xi = carry[i], carry[4 + i]
        z.append(((xr * lre + xi * lim) * lden, (xi * lre - xr * lim) * lden))

    # ---- Ebar = z v^T (rank 1) ;  pull back through the E build ----
    # AAbar_E1[s,i,k] = sum_{j,l} z[(ij)] v[(kl)] conj(AA[s,j,l])
    #                 = sum_j z[(ij)] W1[s,j,k],  W1 = sum_l v[(kl)] conj(AA[s,j,l])
    # AAbar_E2[s,j,l] = conj( sum_i z[(ij)] W2[s,i,l] ),
    #                   W2 = sum_k v[(kl)] AA[s,i,k]
    for s in range(4):
        W1, W2 = {}, {}
        for a in range(2):
            for b in range(2):
                w1r = w1i = w2r = w2i = None
                for c in range(2):
                    ar2, ai2 = aa[(s, a, c)]
                    pr, pi = _cmul(vre[b * 2 + c], vim[b * 2 + c], ar2, -ai2)
                    w1r = pr if w1r is None else w1r + pr
                    w1i = pi if w1i is None else w1i + pi
                    ar2, ai2 = aa[(s, a, c)]
                    pr, pi = _cmul(vre[c * 2 + b], vim[c * 2 + b], ar2, ai2)
                    w2r = pr if w2r is None else w2r + pr
                    w2i = pi if w2i is None else w2i + pi
                W1[(a, b)] = (w1r, w1i)  # W1[s, j=a, k=b]
                W2[(a, b)] = (w2r, w2i)  # W2[s, i=a, l=b]
        for i in range(2):
            for k in range(2):
                sr = si = None
                for j in range(2):
                    pr, pi = _cmul(z[i * 2 + j][0], z[i * 2 + j][1], *W1[(j, k)])
                    sr = pr if sr is None else sr + pr
                    si = pi if si is None else si + pi
                gr, gi = G[(s, i, k)]
                G[(s, i, k)] = (gr + sr, gi + si)
        for j in range(2):
            for l in range(2):
                sr = si = None
                for i in range(2):
                    pr, pi = _cmul(z[i * 2 + j][0], z[i * 2 + j][1], *W2[(i, l)])
                    sr = pr if sr is None else sr + pr
                    si = pi if si is None else si + pi
                gr, gi = G[(s, j, l)]
                G[(s, j, l)] = (gr + sr, gi - si)  # + conj

    # ---- AA build pullback: Abar[s,a,b] = sum_{t,j} G[(s t),a,j] A[t,b,j]
    #                                    + sum_{t,i} G[(t s),i,b] A[t,i,a] --
    for s in range(2):
        for a in range(2):
            for b in range(2):
                sr = si = None
                for t in range(2):
                    for j in range(2):
                        gr, gi = G[(s * 2 + t, a, j)]
                        pr, pi = _cmul(gr, gi, are[t * 4 + b * 2 + j], aim[t * 4 + b * 2 + j])
                        sr = pr if sr is None else sr + pr
                        si = pi if si is None else si + pi
                    for i in range(2):
                        gr, gi = G[(t * 2 + s, i, b)]
                        pr, pi = _cmul(gr, gi, are[t * 4 + i * 2 + a], aim[t * 4 + i * 2 + a])
                        sr = sr + pr
                        si = si + pi
                oar[s * 4 + a * 2 + b] = sr
                oai[s * 4 + a * 2 + b] = si


def _planes(x, ncomp, Bp):
    """(B, ...) complex -> component-major (ncomp, Bp) float32 re/im
    planes, zero-padded along the batch (a zero element runs through
    every clamped division and comes out finite; it is sliced off)."""
    B = x.shape[0]
    flat = x.reshape(B, ncomp).T
    pad = ((0, 0), (0, Bp - B))
    return (jnp.pad(jnp.real(flat).astype(jnp.float32), pad),
            jnp.pad(jnp.imag(flat).astype(jnp.float32), pad))


def _h_operands(hs, As, Bp, block):
    """(hre, him, spec): per-element h as 16 planes, or a shared h as one
    (16,) operand that every program reads whole."""
    if hs.ndim == 3:
        hre, him = _planes(hs.astype(As.dtype), 16, Bp)
        return hre, him, pl.BlockSpec((16, block), lambda i: (0, i))
    hre = jnp.real(hs).astype(jnp.float32).reshape(16)
    him = jnp.imag(hs).astype(jnp.float32).reshape(16)
    return hre, him, pl.BlockSpec((16,), lambda i: (0,))


def _launch(kernel, args, in_specs, out_specs, out_shape, Bp, block,
            num_warps, interpret):
    return pl.pallas_call(
        kernel,
        grid=(Bp // block,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name=kernel.func.__name__,
    )(*args)


def _fwd_pallas(As, hs, iters, with_v, interpret=False, block=BLOCK,
                num_warps=NUM_WARPS):
    """Launch the forward kernel.  As (B, 2, 2, 2); hs (4, 4) shared or
    (B, 4, 4).  Returns e [, lam, v]."""
    B = As.shape[0]
    Bp = B + (-B) % block
    are, aim = _planes(As, 8, Bp)
    hre, him, hspec = _h_operands(hs, As, Bp, block)

    def pspec(n):
        return pl.BlockSpec((n, block), lambda i: (0, i))

    sspec = pl.BlockSpec((block,), lambda i: (i,))
    plane = lambda *n: jax.ShapeDtypeStruct(n + (Bp,), jnp.float32)
    out_specs, out_shape = [sspec], [plane()]
    if with_v:
        out_specs += [sspec, sspec, pspec(4), pspec(4)]
        out_shape += [plane(), plane(), plane(4), plane(4)]

    outs = _launch(
        functools.partial(_energy_fwd_kernel, iters, with_v),
        (are, aim, hre, him),
        [pspec(8), pspec(8), hspec, hspec], out_specs, out_shape,
        Bp, block, num_warps, interpret,
    )
    e = outs[0][:B]
    if not with_v:
        return e
    lam = jax.lax.complex(outs[1], outs[2])[:B]
    v = jax.lax.complex(outs[3], outs[4]).T[:B]
    return e, lam, v


def _bwd_pallas(As, hs, lam, v, ct, K=24, interpret=False, block=BLOCK,
                num_warps=NUM_WARPS):
    """Launch the backward kernel; returns (Abar, hbar_complex (B,4,4))."""
    B = As.shape[0]
    Bp = B + (-B) % block
    are, aim = _planes(As, 8, Bp)
    hre, him, hspec = _h_operands(hs, As, Bp, block)
    vre, vim = _planes(v, 4, Bp)
    lre, lim = _planes(lam, 1, Bp)
    ctp, _ = _planes(ct.astype(jnp.complex64), 1, Bp)

    def pspec(n):
        return pl.BlockSpec((n, block), lambda i: (0, i))

    sspec = pl.BlockSpec((block,), lambda i: (i,))
    plane = lambda n: jax.ShapeDtypeStruct((n, Bp), jnp.float32)
    outs = _launch(
        functools.partial(_energy_bwd_kernel, K),
        (are, aim, hre, him, vre, vim, lre[0], lim[0], ctp[0]),
        [pspec(8), pspec(8), hspec, hspec, pspec(4), pspec(4)] + [sspec] * 3,
        [pspec(8), pspec(8), pspec(16), pspec(16)],
        [plane(8), plane(8), plane(16), plane(16)],
        Bp, block, num_warps, interpret,
    )

    def reassemble(re, im, shape):
        zz = jax.lax.complex(re, im).T[:B]
        return zz.reshape((B,) + shape).astype(As.dtype)

    Abar = reassemble(outs[0], outs[1], (2, 2, 2))
    hbar = reassemble(outs[2], outs[3], (4, 4))
    return Abar, hbar


# ---------------------------------------------------------------------------
# public face
# ---------------------------------------------------------------------------

ENGINES = ("pallas", "xla")


def default_engine(engine: str | None = None) -> str:
    """Resolve an energy engine: the Triton kernel where the default
    backend is a GPU, the XLA specification elsewhere."""
    if engine is None:
        return "pallas" if jax.default_backend() == "gpu" else "xla"
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES} or None, got {engine!r}")
    return engine


def energy_objective_fused(
    As: jnp.ndarray,
    hs: jnp.ndarray,
    iters: int = 48,
    interpret: bool = False,
    engine: str | None = None,
) -> jnp.ndarray:
    """Batched D = 2 uMPS energy with exact environments: (B, 2, 2, 2)
    left-canonical tensors + per-point (B, 4, 4) (or shared (4, 4))
    two-site Hamiltonian matrices -> (B,) energies.

    Equals objectives.energy.energy_exact_env(tensor_to_unitary-inverse)
    elementwise; the gradient is the hand-derived implicit adjoint (one
    deflated log-time series solve instead of differentiating the
    fixed-point iteration).  REQUIRES left-canonical As (true for any
    unitary_to_tensor output): the left fixed point is hardcoded to the
    identity.

    engine="pallas": whole objective one Triton kernel launch, whole
    adjoint a second (float32 component planes); ``interpret=True`` runs
    the kernels in the Pallas interpreter (tests, no GPU).  engine="xla":
    the same math as traced XLA in the caller's precision — the kernel's
    specification and the x64 test oracle.  engine=None picks
    ``default_engine()``.
    """
    if As.ndim != 4 or As.shape[1:] != (2, 2, 2):
        raise ValueError(f"As must be (B, 2, 2, 2) D=2 tensors, got {As.shape}")
    hs = jnp.asarray(hs)
    if hs.shape not in ((4, 4), (As.shape[0], 4, 4)):
        raise ValueError(
            f"hs must be (4, 4) or (B, 4, 4) with B={As.shape[0]}, got {hs.shape}"
        )
    return _energy(As, hs, iters, interpret, default_engine(engine))


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def _energy(As, hs, iters, interpret, engine):
    if engine == "pallas":
        return _fwd_pallas(As, hs, iters, with_v=False, interpret=interpret)
    e, _, _ = _energy_fwd_xla(As, _broadcast_h(hs, As.shape[0]), iters)
    return e


def _broadcast_h(hs, B):
    if hs.ndim == 2:
        hs = jnp.broadcast_to(hs[None], (B, 4, 4))
    return hs


def _fwd(As, hs, iters, interpret, engine):
    if engine == "pallas":
        e, lam, v = _fwd_pallas(As, hs, iters, with_v=True, interpret=interpret)
    else:
        e, lam, v = _energy_fwd_xla(As, _broadcast_h(hs, As.shape[0]), iters)
    return e, (As, hs, lam, v)


def _bwd(iters, interpret, engine, res, ct):
    As, hs, lam, v = res
    if engine == "pallas":
        Abar, hbar = _bwd_pallas(As, hs, lam, v, ct, interpret=interpret)
    else:
        Abar, hbar = _energy_bwd_xla(As, _broadcast_h(hs, As.shape[0]), lam, v, ct)
    if hs.ndim == 2:
        hbar = jnp.sum(hbar, axis=0)
    if not jnp.iscomplexobj(hs):
        hbar = hbar.real
    return Abar, hbar.astype(hs.dtype)


_energy.defvjp(_fwd, _bwd)
