"""Sharded phase-diagram sweeps.

The reference's scaling story is joblib/cluster job arrays over (g, D, p,
noise, seed) points (SURVEY.md section 2.9).  Here a sweep is one XLA
program: vmap over the sweep axis inside each device, shard_map over the
mesh across devices — a 1000-point TFIM phase diagram is a single
compiled+sharded call (BASELINE.json config 4).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from ..circuits import ansatze
from ..core.paulis import I2, X, Z
from ..objectives.energy import energy_exact_env


def tfim_matrix(g):
    """Traceable TFIM 2-site matrix -ZZ + g (XI + IX)/2."""
    return -jnp.kron(Z, Z) + g / 2.0 * (jnp.kron(X, I2) + jnp.kron(I2, X))


def _optimize_one(g, p0, build, steps: int, lr: float):
    """One full adam ground-state optimization, scan-jitted."""
    h = tfim_matrix(g)
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.05)
    opt = optax.adam(sched)

    def loss(p):
        return energy_exact_env(build(p), h)

    vg = jax.value_and_grad(loss)

    def step(carry, _):
        p, s = carry
        v, gr = vg(p)
        up, s = opt.update(gr, s)
        return (optax.apply_updates(p, up), s), v

    (p, _), hist = jax.lax.scan(step, (p0, opt.init(p0)), None, length=steps)
    return loss(p), p


def _recycled_loss_env(build, D: int):
    """(p, r, iters) -> (energy, r_new) with the warm fixed-point solver —
    shared by the recycled per-point optimizer and the refine-pass
    evaluator so both report energies from the same solve."""
    from ..embed.unitaries import unitary_to_tensor
    from ..optim.riemann import isometry_energy_warm

    # vmapped sweeps use plain AD through the warm iterations: the LU
    # bordered adjoint materializes a (D^2+1)^2 system per batch element
    # AND its pivoting serializes under vmap (measured 49 ms of a 59 ms
    # step at D=8 B=1024), the batched-GMRES form is 3x worse again;
    # backward-through-matvecs is pure batched matmuls and is the exact
    # gradient of the refined energy actually descended
    # (transfer.right_eigpair_warm_unroll)
    bwd = "unroll"

    def loss_env(h, p, r, iters):
        A = unitary_to_tensor(build(p))
        V = A.transpose(1, 0, 2).reshape(2 * D, D)  # rows (i, s)
        return isometry_energy_warm(V, h, D, r, iters, bwd)

    return loss_env


def _optimize_one_recycled(g, p0, build, D: int, steps: int, lr: float,
                           recycle_iters: int = 24, final_iters: int = 200):
    """_optimize_one with environment recycling: the fixed point rides the
    adam scan and is refined with ``recycle_iters`` operator-form power
    matvecs per step (transfer.right_eigpair_warm through
    isometry_energy_warm; implicit c-gauge adjoint for gradients) instead
    of the from-scratch dense squaring chain — the move that bought 7-10x
    on the single-chain ladder, vmapped over sweep points here.  The
    returned energy is a boosted ``final_iters`` evaluation at the
    returned parameters, never the recycled residual."""
    from ..algorithms.ground_state import _recycled_opt_scan_core, _recycled_r0

    h = tfim_matrix(g)
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.05)
    opt = optax.adam(sched)
    _loss = _recycled_loss_env(build, D)

    def loss_env(p, r, iters):
        return _loss(h, p, r, iters)

    core = _recycled_opt_scan_core(loss_env, opt, steps, recycle_iters, final_iters)
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    p, _, e = core(p0, _recycled_r0(D, ftype))
    return e, p


def _evaluate_one(g, p, build, D: int, recycle: bool, final_iters: int = 200):
    """Energy of fixed parameters p at field g — the refine-pass verbatim
    evaluator, using the same final solve as the optimizer's returned
    energy so the two are comparable elementwise."""
    h = tfim_matrix(g)
    if recycle:
        from ..algorithms.ground_state import _recycled_r0

        ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        e, _ = _recycled_loss_env(build, D)(h, p, _recycled_r0(D, ftype), final_iters)
        return e
    return energy_exact_env(build(p), h)


def _nested_restart_normals(key, restarts: int, shape, ftype):
    """(re, im) standard-normal draws of shape (shape[0], restarts, *rest)
    where slot s's draw depends only on (key, s) — NOT on ``restarts`` —
    so the restart sets NEST: best-of-(k+1) can never lose to best-of-k
    at the same key (test_stiefel_sweep.py::test_stiefel_restarts_pick_
    best_basin caught the flat (n*restarts,)-shaped draw violating this
    by convergence wiggles ~2e-5).  Used by the Stiefel engine, where
    the monotonicity property is asserted; the chart/fused engines keep
    their original flat draws (their published accuracy claims were
    measured against those streams and nothing asserts nesting there)."""
    kw = {} if ftype is None else {"dtype": ftype}
    # two independent branch keys, then fold the slot index into each —
    # flat offsets (101+s / 201+s) would collide at restarts > 100 and
    # correlate slot 100's real stream with slot 0's imaginary one
    kre, kim = jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)
    re = jnp.stack(
        [jax.random.normal(jax.random.fold_in(kre, s), shape, **kw)
         for s in range(restarts)], axis=1)
    im = jnp.stack(
        [jax.random.normal(jax.random.fold_in(kim, s), shape, **kw)
         for s in range(restarts)], axis=1)
    return re, im


_SWEEP_CACHE: dict = {}


def sweep_ground_states(
    gs: jnp.ndarray,
    D: int = 2,
    ansatz: str = "suN",
    steps: int = 300,
    lr: float = 0.05,
    key=None,
    mesh: Mesh | None = None,
    restarts: int = 1,
    refine_passes: int = 0,
    recycle: bool | None = None,
    point_chunk: int | None = None,
    warm_params: jnp.ndarray | None = None,
):
    """Ground-state energies for a batch of field values g.

    vmap within a device; with a mesh, shard the g-axis across devices via
    shard_map (collectives-free: points are independent, so the sweep rides
    pure data parallelism — the natural mapping of this workload onto ICI).

    refine_passes > 0 runs that many ADIABATIC-CONTINUATION passes after
    the random-start sweep: each point is re-optimized warm-started from
    its neighbors' converged parameters (both sweep directions, elementwise
    best kept).  The ground state is continuous in g away from level
    crossings, so a point stuck in a bad basin inherits a good one from a
    neighbor; the passes reuse the already-compiled program (no recompile,
    ~2 extra program calls per pass).

    recycle (default: on for D >= 4) switches the per-point optimizer to
    environment recycling (_optimize_one_recycled): at D = 2 the dense
    4x4 env solve is already negligible next to the expm chart, while at
    D >= 4 the from-scratch D^2 x D^2 squaring chain dominates each step.

    warm_params (n, n_params), if given, replaces restart slot 0's random
    initialization — the hook for bond-growth continuation
    (`sweep_ground_states_grown`) and any other informed start.  With
    restarts >= 2 the remaining slots stay random, so a bad warm start
    can never LOSE to the plain sweep at equal restarts; at the default
    restarts=1 the warm start replaces the ONLY slot and there is no
    random fallback (acceptable for growth, whose slot-0 start provably
    reproduces the previous rung's energy).

    point_chunk bounds how many points one program call carries; the
    chunks run sequentially through the SAME compiled program and are
    concatenated on the host (points are independent, so this changes
    nothing but the dispatch count).  Defaults to 8192 // D points for
    D >= 16, a working-set bound not yet re-derived for the GPU (ROADMAP
    A7).  Pick n as a multiple of point_chunk to avoid compiling a
    remainder-shaped program.

    Returns (energies, params): (n,) and (n, n_params).
    """
    if ansatz == "suN":
        build = lambda p: ansatze.full_state_suN(p, D)
        n_params = (2 * D) ** 2 - 1
    elif ansatz == "deep_bw":
        # brick-wall MPS unitary (circuits/brickwork_deep.py): depth-(n+1)
        # wall of SU(4) KAK bricks — ~depth*n*19 params instead of (2D)^2,
        # the chart-free large-D sweep engine (BASELINE config 4 at D > 2)
        from ..circuits.brickwork_deep import (
            _n_qubits,
            brick_wall_unitary,
            n_brick_params,
        )

        nq = _n_qubits(D)
        depth = nq + 1
        build = lambda p: brick_wall_unitary(p, nq, depth)
        n_params = n_brick_params(nq, depth)
    elif ansatz == "full15":
        build = ansatze.shallow_full_state
        n_params = 15
    else:
        builder = ansatze.STATE_ANSATZE[ansatz]
        build = lambda p: builder(D, p)
        n_params = 2 * 2  # depth-2 default for shallow families

    key = jax.random.PRNGKey(0) if key is None else key
    p0s = jax.random.normal(key, (gs.shape[0], restarts, n_params)) * 0.5
    if warm_params is not None:
        warm_params = jnp.asarray(warm_params, p0s.dtype)
        if warm_params.shape != (gs.shape[0], n_params):
            raise ValueError(
                f"warm_params must be {(gs.shape[0], n_params)}, "
                f"got {warm_params.shape}"
            )
        p0s = p0s.at[:, 0, :].set(warm_params)
    if recycle is None:
        recycle = D >= 4

    # cache the compiled programs: rebuilding the closure every call would
    # re-trace and re-compile
    cache_key = (D, ansatz, steps, lr, mesh, restarts, recycle)
    cached = _SWEEP_CACHE.get(cache_key)
    if cached is None:
        if recycle:
            opt_one = lambda g, p0: _optimize_one_recycled(g, p0, build, D, steps, lr)
        else:
            opt_one = lambda g, p0: _optimize_one(g, p0, build, steps, lr)

        def per_point(g, p0r):
            # independent restarts per point; keep the best basin
            es, ps = jax.vmap(lambda p0: opt_one(g, p0))(p0r)
            i = jnp.argmin(es)
            return es[i], ps[i]

        from .mesh import shard_over_sweep

        fn = jax.jit(shard_over_sweep(jax.vmap(per_point), mesh))
        eval_fn = jax.jit(
            shard_over_sweep(
                jax.vmap(lambda g, p: _evaluate_one(g, p, build, D, recycle)), mesh
            )
        )
        _SWEEP_CACHE[cache_key] = (fn, eval_fn)
    else:
        fn, eval_fn = cached

    if point_chunk is None and D >= 16:
        # bounds the per-call working set (~D^2 per point); ROADMAP A7
        point_chunk = max(64, 8192 // D)

    def run(gv, p0v):
        n = gv.shape[0]
        if not point_chunk or n <= point_chunk:
            return fn(gv, p0v)
        outs = [
            fn(gv[i : i + point_chunk], p0v[i : i + point_chunk])
            for i in range(0, n, point_chunk)
        ]
        return (jnp.concatenate([o[0] for o in outs]),
                jnp.concatenate([o[1] for o in outs]))

    def run_eval(gv, pv):
        n = gv.shape[0]
        if not point_chunk or n <= point_chunk:
            return eval_fn(gv, pv)
        return jnp.concatenate(
            [
                eval_fn(gv[i : i + point_chunk], pv[i : i + point_chunk])
                for i in range(0, n, point_chunk)
            ]
        )

    es, ps = run(gs, p0s)
    for k in range(refine_passes):
        for shift in (1, -1):
            p_nb = jnp.roll(ps, shift, axis=0)
            # (a) VERBATIM neighbor evaluation: the ground state is
            # continuous in g, so a good neighbor's parameters carry an
            # excess energy of only O(dg^2) at this point — this hop is
            # what actually heals an ATTRACTIVE bad basin, where (b)'s
            # full re-optimization can wander back to the bad minimum
            # before its scan ends (observed at D=32 near g~1.85: the
            # polished pass returned err 0.13 from warm starts whose
            # initial energy was already ~1e-4)
            e_nb = run_eval(gs, p_nb)
            better = e_nb < es
            es = jnp.where(better, e_nb, es)
            ps = jnp.where(better[:, None], p_nb, ps)
            # (b) polished re-optimization from the neighbor's basin
            p0n = jnp.broadcast_to(
                p_nb[:, None, :], (ps.shape[0], restarts, ps.shape[-1])
            )
            if restarts > 1:
                # diversify the extra restart slots: identical copies of
                # the neighbor would waste (restarts-1)/restarts of the
                # pass; jittered copies explore the basin's neighborhood
                jit_key = jax.random.fold_in(key, 1000 + 2 * k + (shift > 0))
                noise = 0.05 * jax.random.normal(jit_key, p0n.shape, p0n.dtype)
                p0n = p0n + noise.at[:, 0, :].set(0.0)  # slot 0 stays exact
            e2, p2 = run(gs, p0n)
            better = e2 < es
            es = jnp.where(better, e2, es)
            ps = jnp.where(better[:, None], p2, ps)
    return es, ps


def sweep_ground_states_grown(
    gs: jnp.ndarray,
    D: int,
    steps: int = 300,
    lr: float = 0.05,
    key=None,
    mesh: Mesh | None = None,
    restarts: int = 1,
    refine_passes: int = 0,
    D_start: int = 2,
    stage_steps: int | None = None,
    eps: float = 4e-2,
    point_chunk: int | None = None,
    return_stages: bool = False,
):
    """Bond-growth continuation sweep: optimize the whole g-grid at
    D_start, embed every point's converged su(2D') parameters into
    su(4D') (`core.lie.grow_su_params`, the reference's insu2N+fixindices
    warm start of scripts/bond_dimension.py:24-49 at sweep scale), and
    repeat up the ladder D_start -> 2 D_start -> ... -> D.

    The embedded start reproduces the smaller-D state's energy exactly
    (up to the eps nudge off the singular point), so every point enters
    the larger manifold inside a good basin — this heals the ATTRACTIVE
    bad basins that neighbor-continuation refine passes cannot (observed
    at D=32 near g ~ 1.85, where re-optimization wanders back to the bad
    minimum: the basin is a property of the random start's region, and
    growth never visits it).  Slot 0's STARTING energy equals the
    previous rung's optimum (up to the eps nudge), so each rung enters
    at least as good as the last; the returned energy can still sit a
    convergence-noise margin (~1e-4) above it at points the smaller D
    already solved, because adam's final iterate is not monotone.

    suN ansatz only (the embedding lives in the expm chart).
    ``stage_steps`` bounds the intermediate-D optimizations (default:
    ``steps``); refine passes run only at the final D.  Returns
    (energies, params) at D; with return_stages=True, also a
    {D': (energies, params)} dict of every rung.
    """
    if D_start < 2 or D & (D - 1) or D_start & (D_start - 1) or D < D_start:
        raise ValueError("D and D_start must be powers of two with D >= D_start >= 2")
    if stage_steps is not None and stage_steps < 1:
        # an explicit 0 used to be silently reinterpreted as "full steps";
        # the optimizer scan needs >= 1 step, so reject it loudly instead
        raise ValueError(f"stage_steps must be >= 1, got {stage_steps}")
    from ..core.lie import grow_su_params

    key = jax.random.PRNGKey(0) if key is None else key
    ladder = []
    d = D_start
    while d <= D:
        ladder.append(d)
        d *= 2
    stages = {}
    warm = None
    es = ps = None
    for i, d in enumerate(ladder):
        final = d == D
        es, ps = sweep_ground_states(
            gs,
            D=d,
            ansatz="suN",
            steps=steps if final else (steps if stage_steps is None else stage_steps),
            lr=lr,
            key=jax.random.fold_in(key, i),
            mesh=mesh,
            restarts=restarts,
            refine_passes=refine_passes if final else 0,
            # a user-supplied chunk applies to EVERY rung (an explicit
            # smaller chunk chosen to dodge a worker crash must also hold
            # at intermediate D >= 16 rungs); None keeps each rung's
            # internal per-D default
            point_chunk=point_chunk,
            warm_params=warm,
        )
        if return_stages:
            stages[d] = (es, ps)
        if not final:
            # host-side exact linear embedding of the real parameters
            import numpy as np

            warm = jnp.asarray(grow_su_params(np.asarray(ps), eps))
    if return_stages:
        return es, ps, stages
    return es, ps


_FUSED_SWEEP_CACHE: dict = {}


def sweep_ground_states_fused(
    gs: jnp.ndarray,
    steps: int = 300,
    lr: float = 0.1,
    momentum: float = 0.9,
    restarts: int = 1,
    key=None,
    iters: int = 48,
    interpret: bool = False,
    chunk: int | None = None,
    engine: str | None = None,
    mesh: Mesh | None = None,
):
    """The D = 2 phase-diagram sweep with the FULLY FUSED energy objective
    (kernels/energy_fused.py): with engine="pallas" (the default on a GPU)
    per optimizer step the whole batch's energies + gradients are TWO
    Triton launches (forward with eigenvectors, transposed-build adjoint)
    instead of the ~hundred small XLA launches of the same math
    (engine="xla", the default elsewhere).  ``interpret=True`` runs the
    kernels in the Pallas interpreter (tests).

    Design: optimize the (4, 2) MPS isometry DIRECTLY with
    heavy-ball Riemannian descent (optim/riemann.py's method, batched) —
    tangent projection, retraction by the CLOSED-FORM 2x2 polar factor
    (inverse square root of V^dag V via the trace/det formula; no SVD, no
    expm, all elementwise), so every non-kernel op in the scan body is a
    cheap batched elementwise/2x2 op.

    Returns (energies, As): (n,) and (n, 2, 2, 2) left-canonical tensors
    (best basin per point over ``restarts`` independent starts).

    ``chunk`` bounds the per-program scan length: steps run as
    ceil(steps/chunk) calls of one compiled chunk program with the
    (V, momentum) state carried device-side, at the cost of a few host
    dispatches.
    """
    from ..kernels.energy_fused import default_engine

    engine = default_engine(engine)
    gs = jnp.asarray(gs)
    n = gs.shape[0]
    Bt = n * restarts
    key = jax.random.PRNGKey(0) if key is None else key
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    xre = jax.random.normal(key, (Bt, 4, 2), ftype)
    xim = jax.random.normal(jax.random.fold_in(key, 1), (Bt, 4, 2), ftype)

    cache_key = (lr, momentum, restarts, iters, interpret, engine, mesh,
                 bool(jax.config.jax_enable_x64))
    fns = _FUSED_SWEEP_CACHE.get(cache_key)
    if fns is None:
        fns = _fused_sweep_programs(
            lr, momentum, restarts, iters, interpret, ftype, engine, mesh
        )
        if len(_FUSED_SWEEP_CACHE) >= 16:  # bound: a hyperparameter scan
            _FUSED_SWEEP_CACHE.pop(next(iter(_FUSED_SWEEP_CACHE)))
        _FUSED_SWEEP_CACHE[cache_key] = fns
    else:
        # LRU, not FIFO: move the hit to the end so cycling through 16+
        # configs doesn't evict the entry about to be reused
        _FUSED_SWEEP_CACHE[cache_key] = _FUSED_SWEEP_CACHE.pop(cache_key)
    init, make_advance, finish = fns

    if chunk is None:
        chunk = steps
    hs, V, M = init(gs, xre, xim)
    done = 0
    while done < steps:
        length = min(chunk, steps - done)
        V, M = make_advance(length)(V, M, hs)
        done += length
    return finish(V, hs)


def _fused_sweep_programs(lr, momentum, restarts, iters, interpret, ftype,
                          engine, mesh=None):
    """Three cached jitted programs (init / advance-by-k / finish) for
    sweep_ground_states_fused.  With a mesh, advance/finish shard the
    batch axis across devices (pure data parallelism — points and
    restarts are independent; check_vma=False for the pallas body)."""
    from ..kernels.energy_fused import energy_objective_fused
    from .mesh import shard_over_sweep

    def loss(V, hs):
        A = V.reshape(-1, 2, 2, 2).transpose(0, 2, 1, 3)  # (B, s, i, j)
        return energy_objective_fused(A, hs, iters, interpret, engine)

    def sym_proj(V, G):
        VG = jnp.einsum("bji,bjk->bik", V.conj(), G)
        S = (VG + jnp.swapaxes(VG, -1, -2).conj()) / 2
        return G - jnp.einsum("bij,bjk->bik", V, S)

    def polar(W):
        H = jnp.einsum("bji,bjk->bik", W.conj(), W)  # (B, 2, 2) PSD
        t = jnp.trace(H, axis1=-2, axis2=-1).real
        dt = (H[:, 0, 0] * H[:, 1, 1] - H[:, 0, 1] * H[:, 1, 0]).real
        # SCALE-RELATIVE floor on det: an absolute 1e-30 floor lets a
        # rank-deficient W amplify cancellation noise by ~1/det (1e25 in
        # f32), overflowing the next step's H and NaN-poisoning the point
        # anyway.  Flooring s at ~1e-6 of the trace instead yields a
        # BOUNDED rank-1 factor (the null direction stays null, norms
        # stay O(1)) from which descent can recover.
        dt = jnp.maximum(dt, (1e-6 * t) ** 2)
        s = jnp.sqrt(dt)
        # sqrt(H) = (H + s I)/sqrt(t + 2s); inv via 2x2 adjugate
        denom = jnp.sqrt(jnp.maximum(t + 2.0 * s, 1e-30))
        HsI = H + s[:, None, None] * jnp.eye(2, dtype=H.dtype)
        # det(H+sI) = dt + s t + s^2 >= s t ~ 1e-6 t^2 after the relative
        # floor; the absolute floor below only backstops t = 0 (W = 0)
        detHsI = jnp.maximum(
            (HsI[:, 0, 0] * HsI[:, 1, 1] - HsI[:, 0, 1] * HsI[:, 1, 0]).real,
            1e-30,
        )
        adj = jnp.stack(
            [
                jnp.stack([HsI[:, 1, 1], -HsI[:, 0, 1]], -1),
                jnp.stack([-HsI[:, 1, 0], HsI[:, 0, 0]], -1),
            ],
            -2,
        )
        inv_sqrtH = adj * (denom / detHsI)[:, None, None]
        return jnp.einsum("bij,bjk->bik", W, inv_sqrtH)

    @jax.jit
    def init(gs, xre, xim):
        n = gs.shape[0]
        hs = jax.vmap(tfim_matrix)(gs)
        hs = (hs.real if jnp.iscomplexobj(hs) else hs).astype(ftype)
        hs = jnp.broadcast_to(hs[:, None], (n, restarts, 4, 4)).reshape(-1, 4, 4)
        V0, _ = jnp.linalg.qr(jax.lax.complex(xre, xim))
        return hs, V0, jnp.zeros_like(V0)

    _advance_cache = {}

    def make_advance(length):
        fn = _advance_cache.get(length)
        if fn is None:

            def advance(V, M, hs):
                def step(carry, _):
                    V, M = carry
                    es, vjpf = jax.vjp(lambda v: loss(v, hs), V)
                    (G,) = vjpf(jnp.ones_like(es))
                    T = sym_proj(V, G.conj())
                    M = momentum * M + T
                    V = polar(V - lr * M)
                    M = sym_proj(V, M)
                    return (V, M), None

                (V, M), _ = jax.lax.scan(step, (V, M), None, length=length)
                return V, M

            fn = jax.jit(shard_over_sweep(advance, mesh, check_vma=False))
            _advance_cache[length] = fn
        return fn

    @jax.jit
    @functools.partial(shard_over_sweep, mesh=mesh, check_vma=False)
    def finish(V, hs):
        es = loss(V, hs)
        er = es.reshape(-1, restarts)
        i = jnp.argmin(er, axis=1)
        Vr = V.reshape(-1, restarts, 4, 2)
        Vbest = jnp.take_along_axis(Vr, i[:, None, None, None], axis=1)[:, 0]
        A = Vbest.reshape(-1, 2, 2, 2).transpose(0, 2, 1, 3)
        return jnp.min(er, axis=1), A

    return init, make_advance, finish


_STIEFEL_SWEEP_CACHE: dict = {}


def _polar_ns(W, iters: int = 10):
    """Batched polar factor of (B, n, m) tall matrices by the coupled
    Newton-Schulz inverse-square-root iteration — batched m x m matmuls
    only, replacing the batched SVD that `optim.riemann._retract` uses in
    the single-chain program (batched small SVDs are iterative solvers,
    matmuls are not).  W is near-isometric along the descent trajectory
    (H = W^dag W ~ I), so the trace scaling centres the spectrum at 1 and
    the iteration converges quadratically well within ``iters``.  A
    RELATIVE jitter floors H away from singularity (same rationale as the
    fused D=2 polar's scale-relative det floor above)."""
    m = W.shape[-1]
    eye = jnp.eye(m, dtype=W.dtype)
    H = jnp.einsum("bji,bjk->bik", W.conj(), W)
    c = jnp.trace(H, axis1=-2, axis2=-1).real / m
    c = jnp.maximum(c, jnp.finfo(c.dtype).tiny)
    # dtype-aware relative jitter: it bounds the achievable isometry
    # residual (V^dag V = I only to O(jitter)), so f64 must not pay the
    # f32 guard (measured: a flat 1e-6 capped left-canonicality at 1e-6
    # and with it the f64 energy floor)
    jit_eps = 1e-6 if jnp.finfo(c.dtype).eps > 1e-10 else 1e-12
    Y = H / c[:, None, None] + jit_eps * eye
    Z = jnp.broadcast_to(eye, Y.shape)
    for _ in range(iters):
        T = 1.5 * eye - 0.5 * jnp.einsum("bij,bjk->bik", Z, Y)
        Y = jnp.einsum("bij,bjk->bik", Y, T)
        Z = jnp.einsum("bij,bjk->bik", T, Z)
    return jnp.einsum("bij,bjk->bik", W, Z) / jnp.sqrt(c)[:, None, None]


def _stiefel_sweep_programs(D, lr, momentum, restarts, recycle_iters,
                            final_iters, ftype, mesh):
    """(init, make_advance, finish) jitted programs for
    sweep_ground_states_stiefel — the large-D twin of
    _fused_sweep_programs, XLA-batched instead of Pallas (at D >= 8 the
    per-point work is real D x D / 2D x D matmuls that XLA hands to the
    matrix units as batched GEMMs; what killed the chart path was the
    expm chart and its jacobian, which this engine simply does not have).

    make_advance(length, precision) bakes a matmul-precision tier into
    the DESCENT program only (the package default is "highest" = full
    float32 products; on a GPU "default" and "high" allow TF32).  init
    and finish always run at the ambient (highest) precision: the final
    energies/environments the caller reads back and re-evaluates in f64
    are never cheapened."""
    from ..optim.riemann import isometry_energy_warm
    from .mesh import shard_over_sweep

    d = 2
    # plain AD through the warm iterations — batched matmuls only; the
    # implicit adjoints (LU materializes (D^2+1)^2 per element, GMRES
    # serializes its orthogonalization) both lose badly under vmap
    # (see _recycled_loss_env)
    bwd = "unroll"

    def loss(V, r, hs, iters):
        return jax.vmap(
            lambda Vb, rb, hb: isometry_energy_warm(Vb, hb, D, rb, iters, bwd)
        )(V, r, hs)

    def _loss_sum(V, r, hs):
        # points are independent, so grad of the sum IS the per-point
        # gradient batch (one vjp launch for the whole sweep)
        es, r_new = loss(V, jax.lax.stop_gradient(r), hs, recycle_iters)
        return jnp.sum(es), r_new

    vg = jax.value_and_grad(_loss_sum, has_aux=True)

    def sym_proj(V, G):
        VG = jnp.einsum("bji,bjk->bik", V.conj(), G)
        S = (VG + jnp.swapaxes(VG, -1, -2).conj()) / 2
        return G - jnp.einsum("bij,bjk->bik", V, S)

    @jax.jit
    def init(gs, xre, xim, warm):
        n = gs.shape[0]
        hs = jax.vmap(tfim_matrix)(gs)
        hs = (hs.real if jnp.iscomplexobj(hs) else hs).astype(ftype)
        hs = jnp.broadcast_to(
            hs[:, None], (n, restarts, 4, 4)
        ).reshape(-1, 4, 4)
        V0, _ = jnp.linalg.qr(jax.lax.complex(xre, xim))
        if warm is not None:
            # slot 0 <- warm tensors (bond-growth or neighbor starts)
            V0 = V0.reshape(n, restarts, d * D, D).at[:, 0].set(warm)
            V0 = V0.reshape(-1, d * D, D)
        r0 = jnp.eye(D, dtype=V0.dtype)
        r0 = jnp.broadcast_to(
            r0 / jnp.linalg.norm(r0), (V0.shape[0], D, D)
        )
        return hs, V0, jnp.zeros_like(V0), r0

    _advance_cache = {}

    def make_advance(length, precision=None):
        import contextlib

        fn = _advance_cache.get((length, precision))
        if fn is None:

            def advance(V, M, r, hs):
                ctx = (jax.default_matmul_precision(precision)
                       if precision is not None else contextlib.nullcontext())
                with ctx:
                    def step(carry, _):
                        V, M, r = carry
                        (_, r_new), G = vg(V, r, hs)
                        G = G.conj()
                        T = sym_proj(V, G)
                        M = momentum * M + T
                        V = _polar_ns(V - lr * M)
                        M = sym_proj(V, M)
                        return (V, M, r_new), None

                    (V, M, r), _ = jax.lax.scan(step, (V, M, r), None,
                                                length=length)
                return V, M, r

            fn = jax.jit(shard_over_sweep(advance, mesh, check_vma=False))
            _advance_cache[(length, precision)] = fn
        return fn

    @jax.jit
    @functools.partial(shard_over_sweep, mesh=mesh, check_vma=False)
    def finish(V, r, hs):
        es, r = loss(V, r, hs, final_iters)
        er = es.reshape(-1, restarts)
        i = jnp.argmin(er, axis=1)
        take = lambda X: jnp.take_along_axis(
            X.reshape(-1, restarts, *X.shape[1:]),
            i[(...,) + (None,) * X.ndim], axis=1
        )[:, 0]
        Vb, rb = take(V), take(r)
        A = Vb.reshape(-1, D, d, D).transpose(0, 2, 1, 3)
        return jnp.min(er, axis=1), A, rb

    return init, make_advance, finish


def sweep_ground_states_stiefel(
    gs: jnp.ndarray,
    D: int,
    steps: int = 300,
    lr: float = 0.08,
    momentum: float = 0.9,
    restarts: int = 1,
    key=None,
    recycle_iters: int | None = None,
    final_iters: int = 200,
    chunk: int | None = 50,
    point_chunk: int | None = None,
    mesh: Mesh | None = None,
    warm_V: jnp.ndarray | None = None,
    precision: str | None = None,
    polish_steps: int = 0,
):
    """BASELINE config 4 at large D: the phase-diagram sweep through
    DIRECT Stiefel-manifold descent on the (2D, D) MPS isometry — no
    expm chart, no chart jacobian; per step the whole batch pays one
    vjp of the warm-environment energy (batched power matvecs with the
    unroll adjoint — plain reverse-mode AD back through the warm
    iterations, transfer.right_eigpair_warm_unroll), a tangent
    projection, and a Newton-Schulz polar retraction: every FLOP is a
    batched matmul.

    This is the engine aimed at the "1000+ vmapped optimizations,
    D <= 32, under a minute" target (BASELINE.md:27-28): the suN-chart
    sweep pays the expm chart per point per step, the brickwork sweep
    pays a depth-n circuit build; here the manifold is the state tensor
    itself.
    Accuracy note: direct descent converges toward the D-OPTIMAL state
    (same variational class as VUMPS), so at D >= 8 the achievable
    error vs the exact integral is limited by convergence, not
    expressivity.

    Returns (energies, As, rs): (n,), (n, 2, D, D) tensors (best basin
    per point over ``restarts``) and the converged environments
    (n, D, D) — callers re-evaluating in f64 warm-start from rs.

    ``chunk`` bounds the per-program scan length; ``point_chunk`` bounds
    the batch per program call (both defaults are still to be re-derived
    for the GPU, ROADMAP A7); ``warm_V`` (n, 2D, D) seeds restart slot 0
    (bond-growth continuation via `grow_isometry`).

    ``recycle_iters`` (None = D-aware default: 24 below D=16, 96 at
    D >= 16) is a CORRECTNESS knob, not just a speed one: the optimizer
    descends the iters-refined energy, so if the recycled environment
    cannot keep up with the state's transfer gap the descent exploits
    the unconverged readout (energies below the true ground state,
    outliers that survive the honest final_iters re-evaluation because
    the state itself is bad).  At 1024 points x 300 steps the
    f64-re-evaluated max error vs the exact integral fell from ~4e-2
    (D=32, ri=24) to under 1e-3 at ri=96.

    ``precision`` / ``polish_steps`` form the two-phase matmul-precision
    schedule: the first ``steps - polish_steps`` descent steps run at
    ``precision`` (on a GPU "default" and "high" let float32 products
    run in TF32; None inherits the package pin of "highest", full
    float32), the last ``polish_steps`` and the final_iters
    energy/environment readout always run at highest.  Rationale: the
    descent trajectory tolerates cheap products (momentum averages the
    rounding; the polar retraction re-orthonormalizes every step) while
    the READOUT must not; the polish tail recovers the readout accuracy.
    The benchmark's D=32 schedule (precision="default", polish_steps=60
    of 180) meets its f64 gate on the H100 (PERF.md).
    """
    gs = jnp.asarray(gs)
    n = gs.shape[0]
    key = jax.random.PRNGKey(0) if key is None else key
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if recycle_iters is None:
        recycle_iters = 24 if D < 16 else 96

    cache_key = (D, lr, momentum, restarts, recycle_iters, final_iters,
                 mesh, bool(jax.config.jax_enable_x64))
    fns = _STIEFEL_SWEEP_CACHE.get(cache_key)
    if fns is None:
        fns = _stiefel_sweep_programs(
            D, lr, momentum, restarts, recycle_iters, final_iters, ftype, mesh
        )
        if len(_STIEFEL_SWEEP_CACHE) >= 16:
            _STIEFEL_SWEEP_CACHE.pop(next(iter(_STIEFEL_SWEEP_CACHE)))
        _STIEFEL_SWEEP_CACHE[cache_key] = fns
    else:
        _STIEFEL_SWEEP_CACHE[cache_key] = _STIEFEL_SWEEP_CACHE.pop(cache_key)
    init, make_advance, finish = fns

    if point_chunk is None and D >= 16:
        # bounds the per-call batch (points x restarts) at
        # B * D^2 <= 2^17 (D=16: 512, D=32: 128): the unroll adjoint's
        # residual stack is (iters, B, D, D).  ROADMAP A7
        point_chunk = max(32, (1 << 17) // (D * D * restarts))
    if chunk is None:
        chunk = steps

    polish = min(max(int(polish_steps), 0), steps) if precision else 0

    def run_block(gv, warm, block_key):
        B = gv.shape[0] * restarts
        xre, xim = _nested_restart_normals(
            block_key, restarts, (gv.shape[0], 2 * D, D), ftype
        )
        xre = xre.reshape(B, 2 * D, D)
        xim = xim.reshape(B, 2 * D, D)
        hs, V, M, r = init(gv, xre, xim, warm)
        done = 0
        while done < steps - polish:
            length = min(chunk, steps - polish - done)
            V, M, r = make_advance(length, precision)(V, M, r, hs)
            done += length
        while done < steps:
            length = min(chunk, steps - done)
            V, M, r = make_advance(length)(V, M, r, hs)
            done += length
        return finish(V, r, hs)

    if not point_chunk or n <= point_chunk:
        return run_block(gs, warm_V, key)
    outs = []
    for i in range(0, n, point_chunk):
        w = None if warm_V is None else warm_V[i : i + point_chunk]
        outs.append(run_block(gs[i : i + point_chunk], w,
                              jax.random.fold_in(key, 7 + i)))
    return tuple(jnp.concatenate([o[j] for o in outs]) for j in range(3))


_CERT_CACHE: dict = {}


def sweep_variance_certificates(
    gs: jnp.ndarray,
    As: jnp.ndarray,
    rs: jnp.ndarray,
    env_iters: int = 40,
    k: int = 48,
    restarts: int = 4,
    point_chunk: int | None = None,
):
    """Per-point energy-variance certificates for sweep outputs: sigma^2_i
    = (<H^2> - <H>^2)/N of point i's returned state, H = sum_n h(g_i).

    ORACLE-FREE convergence certification: sigma^2 = 0 iff the state is
    an exact eigenstate, and |E - E_0| <= sigma^2 / gap for an optimized
    state, so a point stuck in a bad basin or short of convergence is
    flagged by its own variance — no exact integral in the loop (the
    error columns in bench.py need the closed-form TFIM oracle; this
    column works for any Hamiltonian).  The reference validates only
    against oracles (scripts/ground_state_finding.py:70-72).

    As (n, d, D, D) left-canonical tensors and rs (n, D, D) converged
    right environments, as returned by sweep_ground_states_stiefel; the
    environments are re-refined with ``env_iters`` warm power matvecs,
    then each certificate runs the GMRES geometric tail of
    mps.tdvp.energy_variance_density, vmapped over points and chunked
    like the sweep itself.  f32 on chip resolves sigma^2 to ~1e-6
    absolute — ample to separate converged (<=1e-4) from stuck (>=1e-2)
    points.  Returns (n,) real variances.
    """
    from ..mps.tdvp import energy_variance_density

    gs = jnp.asarray(gs)
    n = gs.shape[0]
    D = As.shape[-1]
    if point_chunk is None:
        # the GMRES Krylov basis is (B, k+1, D^2): keep B * D^2 <= 2^17
        point_chunk = min(256, max(32, (1 << 17) // (D * D)))

    cache_key = (D, env_iters, k, restarts, As.dtype)
    fn = _CERT_CACHE.get(cache_key)
    if fn is not None:
        # move-to-end on hit (same recency rule as _STIEFEL_SWEEP_CACHE):
        # a hot certificate program must not be evicted under churn
        _CERT_CACHE[cache_key] = _CERT_CACHE.pop(cache_key)
    if fn is None:

        def one(g, A, r0):
            h = tfim_matrix(g)

            def body(r, _):
                r = jnp.einsum("sai,ij,sbj->ab", A, r, A.conj())
                r = (r + r.conj().T) / 2
                return r / jnp.linalg.norm(r), None

            r, _ = jax.lax.scan(body, r0, None, length=env_iters)
            r = r / jnp.trace(r)
            return energy_variance_density(
                A, r, h.astype(A.dtype), env_solver="gmres",
                k=k, restarts=restarts,
            )

        fn = jax.jit(jax.vmap(one))
        if len(_CERT_CACHE) >= 16:
            _CERT_CACHE.pop(next(iter(_CERT_CACHE)))
        _CERT_CACHE[cache_key] = fn

    if not point_chunk or n <= point_chunk:
        return fn(gs, As, rs)
    return jnp.concatenate([
        fn(gs[i : i + point_chunk], As[i : i + point_chunk],
           rs[i : i + point_chunk])
        for i in range(0, n, point_chunk)
    ])


def grow_isometry(A, eps: float = 1e-3, key=None):
    """Bond-growth warm start in TENSOR space: embed a converged (d, D, D)
    left-canonical tensor into (d, 2D, 2D) as the direct sum with an
    eps-scaled random block, returned as the (2dD, 2D) isometry argument
    of sweep_ground_states_stiefel's warm_V (re-orthonormalized by the
    first retraction).  The embedded state reproduces the D-state's
    energy up to O(eps) — the tensor-space analogue of
    core.lie.grow_su_params (reference scripts/bond_dimension.py:24-35)."""
    key = jax.random.PRNGKey(17) if key is None else key
    A = jnp.asarray(A)
    batched = A.ndim == 4
    if not batched:
        A = A[None]
    B, d, D, _ = A.shape
    noise = eps * (
        jax.random.normal(key, (B, d, 2 * D, 2 * D), jnp.zeros(0, A.dtype).real.dtype)
    ).astype(A.dtype)
    A2 = jnp.zeros((B, d, 2 * D, 2 * D), A.dtype)
    A2 = A2.at[:, :, :D, :D].set(A)
    # the new sector enters as eps-noise everywhere (coupled, so descent
    # can populate it); the first polar retraction restores isometry
    A2 = A2 + noise
    V = A2.transpose(0, 2, 1, 3).reshape(B, 2 * D * d, 2 * D)
    V = _polar_ns(V, iters=14)
    return V if batched else V[0]


def multi_start_ground_state(
    g: float,
    D: int = 2,
    ansatz: str = "suN",
    n_starts: int = 64,
    steps: int = 300,
    lr: float = 0.05,
    key=None,
):
    """Batched ground-state search: ``n_starts`` random initializations
    optimized in one batched program, best kept — the reference's
    retry-until-monotone robustness pattern done in parallel.  Returns
    (energy, params).
    """
    gs = jnp.full((n_starts,), g, dtype=jnp.float32 if not jax.config.jax_enable_x64 else jnp.float64)
    es, params = sweep_ground_states(gs, D=D, ansatz=ansatz, steps=steps, lr=lr, key=key)
    i = jnp.argmin(es)
    return es[i], params[i]


def phase_diagram_sweep(
    gs: jnp.ndarray,
    Ds=(2,),
    ansatz: str = "suN",
    steps: int = 300,
    key=None,
    mesh: Mesh | None = None,
):
    """(len(Ds), len(gs)) energy table — the reference's phase-diagram
    experiment (scripts/ground_state_finding.py:165-213) at sweep scale.
    D values compile separately (ragged shapes); g points run
    vmapped+sharded."""
    key = jax.random.PRNGKey(0) if key is None else key
    es = []
    for i, D in enumerate(Ds):
        e, _ = sweep_ground_states(
            gs, D=D, ansatz=ansatz, steps=steps, key=jax.random.fold_in(key, i), mesh=mesh
        )
        es.append(e)
    return jnp.stack(es)
