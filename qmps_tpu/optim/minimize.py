"""Gradient optimizers for jitted objectives.

The reference drives every objective with derivative-free scipy
(Nelder-Mead/Powell, qmps/tools.py:248-270) — O(10^3-10^4) function
evaluations each costing a circuit simulation.  Here objectives are
differentiable, so we run optax adam / L-BFGS entirely inside jit with a
lax.scan over steps (convergence history recorded on-device), plus a scipy
bridge for parity experiments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import optax


@dataclasses.dataclass
class OptResult:
    """Mirrors the fields qMPS consumers read off scipy's OptimizeResult."""

    x: jnp.ndarray
    fun: float
    history: jnp.ndarray | None = None
    nit: int = 0
    message: str = ""


def minimize_adam(
    loss: Callable,
    x0: jnp.ndarray,
    steps: int = 1000,
    lr: float = 1e-2,
    store_values: bool = True,
) -> OptResult:
    """Adam with cosine-decayed lr, fully jitted (one XLA program)."""
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.05)
    opt = optax.adam(sched)
    vg = jax.value_and_grad(loss)

    @jax.jit
    def run(x0):
        def step(carry, _):
            x, s = carry
            v, g = vg(x)
            up, s = opt.update(g, s)
            return (optax.apply_updates(x, up), s), v

        (x, _), hist = jax.lax.scan(step, (x0, opt.init(x0)), None, length=steps)
        return x, hist

    x, hist = run(x0)
    return OptResult(
        x=x,
        fun=float(jax.jit(loss)(x)),
        history=hist if store_values else None,
        nit=steps,
        message="adam/scan completed",
    )


def minimize_lbfgs(
    loss: Callable,
    x0: jnp.ndarray,
    steps: int = 200,
    store_values: bool = True,
) -> OptResult:
    """optax L-BFGS with zoom linesearch, jitted scan."""
    opt = optax.lbfgs()
    vg = jax.value_and_grad(loss)

    @jax.jit
    def run(x0):
        def step(carry, _):
            x, s = carry
            v, g = vg(x)
            up, s = opt.update(
                g, s, x, value=v, grad=g, value_fn=loss
            )
            return (optax.apply_updates(x, up), s), v

        (x, _), hist = jax.lax.scan(step, (x0, opt.init(x0)), None, length=steps)
        return x, hist

    x, hist = run(x0)
    return OptResult(
        x=x,
        fun=float(jax.jit(loss)(x)),
        history=hist if store_values else None,
        nit=steps,
        message="lbfgs/scan completed",
    )


def retry_until_monotone(
    run_once: Callable,
    key,
    max_tries: int = 3,
    eps: float = 1e-4,
    last_best: float = float("inf"),
):
    """Numerical fault handling: rerun an optimization with fresh seeds until
    the result doesn't regress past the previous best (the reference's
    retry-until-monotone loops, scripts/ground_state_finding.py:139-154,
    scripts/noisy_optimization.py).

    run_once(key) -> OptResult; returns the best result across tries.
    """
    import jax

    best = None
    for t in range(max_tries):
        key, sub = jax.random.split(key)
        res = run_once(sub)
        if jnp.isfinite(res.fun) and (best is None or res.fun < best.fun):
            best = res
        if best is not None and best.fun < last_best + eps:
            break
    return best


def minimize_bayesian(
    loss: Callable,
    bounds,
    n_calls: int = 40,
    n_init: int = 8,
    key=None,
    n_candidates: int = 512,
) -> OptResult:
    """Bayesian optimization over box bounds — the reference's
    ``skopt.gp_minimize`` hook (qmps/tools.py:259-260, settings
    ``bayesian=True``).  Uses skopt when importable; otherwise a
    self-contained GP(RBF) + expected-improvement loop in numpy, so the
    capability does not depend on the optional package.
    """
    import numpy as np

    jloss = jax.jit(loss)
    f = lambda x: float(jloss(jnp.asarray(x)))
    lo = np.asarray([b[0] for b in bounds], float)
    hi = np.asarray([b[1] for b in bounds], float)
    d = lo.shape[0]

    try:  # the reference's actual dependency, if present
        from skopt import gp_minimize

        res = gp_minimize(f, list(map(tuple, zip(lo, hi))), n_calls=n_calls)
        return OptResult(
            x=jnp.asarray(res.x), fun=float(res.fun), nit=n_calls,
            message="skopt gp_minimize",
        )
    except ImportError:
        pass

    seed = 0 if key is None else int(jax.random.randint(key, (), 0, 2**31 - 1))
    rng = np.random.default_rng(seed)

    def scale(u):  # [0,1]^d -> box
        return lo + u * (hi - lo)

    U = rng.random((n_init, d))
    X = [u for u in U]
    y = [f(scale(u)) for u in U]

    sqrt2pi = float(np.sqrt(2 * np.pi))

    def _phi(z):
        return np.exp(-0.5 * z**2) / sqrt2pi

    def _Phi(z):
        from math import erf

        return 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))

    for _ in range(n_calls - n_init):
        Xa = np.stack(X)
        ya = np.asarray(y)
        mu0, sd0 = ya.mean(), max(ya.std(), 1e-12)
        yn = (ya - mu0) / sd0
        ell = 0.25 * np.sqrt(d)
        d2 = ((Xa[:, None, :] - Xa[None, :, :]) ** 2).sum(-1)
        K = np.exp(-0.5 * d2 / ell**2) + 1e-8 * np.eye(len(X))
        Lc = np.linalg.cholesky(K)
        alpha = np.linalg.solve(Lc.T, np.linalg.solve(Lc, yn))
        # candidates: uniform + local perturbations of the incumbent
        best_u = Xa[int(np.argmin(ya))]
        cand = np.concatenate(
            [
                rng.random((n_candidates // 2, d)),
                np.clip(
                    best_u + 0.1 * rng.standard_normal((n_candidates // 2, d)),
                    0.0,
                    1.0,
                ),
            ]
        )
        kc = np.exp(
            -0.5 * ((cand[:, None, :] - Xa[None, :, :]) ** 2).sum(-1) / ell**2
        )
        mu = kc @ alpha
        v = np.linalg.solve(Lc, kc.T)
        var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
        sd = np.sqrt(var)
        ybest = yn.min()
        z = (ybest - mu) / sd
        ei = (ybest - mu) * _Phi(z) + sd * _phi(z)
        u = cand[int(np.argmax(ei))]
        X.append(u)
        y.append(f(scale(u)))

    i = int(np.argmin(y))
    return OptResult(
        x=jnp.asarray(scale(X[i])), fun=float(y[i]), nit=n_calls,
        message="builtin GP-EI",
    )


def minimize_scipy(
    loss: Callable,
    x0: jnp.ndarray,
    method: str = "Nelder-Mead",
    tol: float = 1e-8,
    maxiter: int = 10000,
    with_grad: bool = False,
    jit_objective: bool = True,
) -> OptResult:
    """Parity bridge to scipy.optimize.minimize (the reference's optimizer
    settings, qmps/tools.py:212-219); jit-compiles the objective once.

    jit_objective=False for STATEFUL objectives (e.g. a fresh PRNG split
    per shot-noise evaluation): jitting one would freeze the state at
    trace time — every evaluation would reuse the same baked-in key and
    the instance attribute would be left holding an escaped tracer."""
    import numpy as np
    from scipy.optimize import minimize as sp_minimize

    jloss = jax.jit(loss) if jit_objective else loss
    f = lambda x: float(jloss(jnp.asarray(x)))
    jac = None
    if with_grad:
        jg = jax.jit(jax.grad(loss))
        jac = lambda x: np.asarray(jg(jnp.asarray(x)), dtype=float)
    res = sp_minimize(f, np.asarray(x0), method=method, tol=tol, jac=jac,
                      options={"maxiter": maxiter})
    return OptResult(
        x=jnp.asarray(res.x), fun=float(res.fun), nit=int(res.get("nit", 0)),
        message=str(res.message),
    )
