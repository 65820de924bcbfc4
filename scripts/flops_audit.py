"""Audit analytic per-element FLOP counts for the benched programs.

Runs on CPU (forced below) and reads FLOP counts out of XLA's cost model
via qmps_tpu.utils.flops.program_costs.  The fused D=2 energy kernel is a
Pallas call, whose custom call the cost model cannot see into, so it is
audited through its XLA TWIN — the same math as traced XLA (the kernel's
test oracle), giving the analytic work the kernel performs.  Prints one
JSON object of counts.

Usage: python scripts/flops_audit.py [--deep]   (--deep adds the
D=32/64 deep-brickwork and D=16/32 Stiefel step programs — minutes of
CPU compile time.)
"""
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

# XLA's cost model counts a while/scan BODY once, not times the trip
# count (verified: a 40- and a 48-iteration eigensolve audited
# identically), so for audit purposes every lax.scan is forced to fully
# unroll — the HLO then contains each iteration's arithmetic explicitly.
# All audited library loops go through the jax.lax module attribute, so
# patching it here covers them.
_orig_scan = jax.lax.scan


def _scan_unrolled(f, init, xs=None, length=None, **kw):
    kw["unroll"] = True
    return _orig_scan(f, init, xs, length=length, **kw)


jax.lax.scan = _scan_unrolled

import jax.numpy as jnp
import numpy as np

from qmps_tpu.utils.flops import program_costs

OUT = {}


def per_el(tag, fn, *args, B, static_argnums=()):
    c = program_costs(fn, *args, static_argnums=static_argnums)
    OUT[tag] = round(c["flops"] / B, 1)
    print(f"{tag}: {OUT[tag]:.1f} flops/el  (bytes/el {c['bytes']/B:.0f})",
          flush=True)


def rand_c64(key, shape):
    kr, ki = jax.random.split(jax.random.PRNGKey(key))
    return (jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape)
            ).astype(jnp.complex64)


B = 512

# --- 1. brickwork manifold overlap (batched flat matmuls) ---
from qmps_tpu.kernels import manifold_overlap_batched

U1, U2, U1p, U2p = (rand_c64(i, (B, 4, 4)) for i in range(4))
M = rand_c64(5, (B, 2, 2))
W = rand_c64(6, (16, 16))
per_el(
    "overlap",
    lambda u1, u2, p1, p2, m, w: jnp.abs(
        manifold_overlap_batched(u1, u2, p1, p2, m,
                                 jnp.swapaxes(m, -1, -2).conj(), w)
    ),
    U1, U2, U1p, U2p, M, W, B=B,
)

# --- 2. N=4 batched repeated-squaring eigensolver ---
from qmps_tpu.kernels.energy_fused import _eig_right_xla

E = rand_c64(7, (B, 4, 4))
per_el("eig40", lambda e: _eig_right_xla(e, 40)[0], E, B=B)
per_el("eig48", lambda e: _eig_right_xla(e, 48)[0], E, B=B)

# --- 3. D=2 TDVP objective forward (build + 48-iter eigensolve) ---
As, Bs = rand_c64(8, (B, 2, 2, 2)), rand_c64(9, (B, 2, 2, 2))
W4 = rand_c64(10, (4, 4))


def tdvp_fwd_xla(A, Bt, W):
    AA = jnp.einsum("bsik,btkj->bstij", A, A).reshape(-1, 4, 2, 2)
    WAA = jnp.einsum("st,btij->bsij", W, AA)
    BB = jnp.einsum("bsik,btkj->bstij", Bt, Bt).reshape(-1, 4, 2, 2)
    E = jnp.einsum("bsik,bsjl->bijkl", WAA, BB.conj()).reshape(-1, 4, 4)
    lam, _ = _eig_right_xla(E, 48)
    return -jnp.abs(lam)


per_el("tdvp_fwd", tdvp_fwd_xla, As, Bs, W4, B=B)
# grad = forward with the left eigenvector too (build + right AND left
# eigensolves) + the transposed build: 2*build + 2*eig48, with
# build = tdvp_fwd - eig48
OUT["tdvp_grad"] = round(2 * (OUT["tdvp_fwd"] - OUT["eig48"]) + 2 * OUT["eig48"], 1)
print(f"tdvp_grad (synthesized): {OUT['tdvp_grad']:.1f} flops/el", flush=True)

# --- 4. fused D=2 energy objective: forward and value_and_grad (the
# XLA engine shares the kernel's custom_vjp implicit adjoint, so its
# cost IS the fused math's analytic count) ---
from qmps_tpu.kernels.energy_fused import energy_objective_fused

hs = jax.random.normal(jax.random.PRNGKey(11), (B, 4, 4), jnp.float32)
per_el(
    "energy_fwd",
    lambda a, h: energy_objective_fused(a, h, 48, False, "xla"),
    As, hs, B=B,
)
per_el(
    "energy_grad",
    lambda a, h: jax.value_and_grad(
        lambda a_: jnp.sum(energy_objective_fused(a_, h, 48, False, "xla"))
    )(a),
    As, hs, B=B,
)

if "--deep" in sys.argv:
    # --- 5. Stiefel sweep advance (pure XLA; the exact benched program) ---
    from qmps_tpu.parallel.sweep import _stiefel_sweep_programs

    for D in (16, 32):
        Bs_ = 32
        ftype = jnp.float32
        # recycle_iters mirrors sweep_ground_states_stiefel's D-aware
        # default (24 below D=16, 96 at D >= 16) — the audited program
        # must be the benched program, and the warm-env matvecs dominate
        init, make_advance, _ = _stiefel_sweep_programs(
            D, 0.08, 0.9, 1, 24 if D < 16 else 96, 200, ftype, None
        )
        gs = jnp.linspace(0.5, 1.5, Bs_)
        xre = jax.random.normal(jax.random.PRNGKey(1), (Bs_, 2 * D, D), ftype)
        xim = jax.random.normal(jax.random.PRNGKey(2), (Bs_, 2 * D, D), ftype)
        hsb, V, M, r = init(gs, xre, xim, None)
        adv = make_advance(1)
        c = program_costs(adv, V, M, r, hsb)
        OUT[f"stiefel_step_D{D}"] = round(c["flops"] / Bs_, 1)
        print(f"stiefel_step_D{D}: {OUT[f'stiefel_step_D{D}']:.1f} flops/pt/step",
              flush=True)

    # --- 6. deep-brickwork recycled step (the exact benched program) ---
    from qmps_tpu.algorithms.ground_state import (
        _deep_bw_program_recycled,
        _h_planes,
    )
    from qmps_tpu.circuits.brickwork_deep import _n_qubits, n_brick_params
    from qmps_tpu.ham import tfim

    h = np.asarray(tfim(1.0).to_matrix())
    for D in (32, 64):
        n = _n_qubits(D)
        steps = 3
        run = _deep_bw_program_recycled(D, n + 1, steps, 0.05, 24)
        x0 = jax.random.normal(
            jax.random.PRNGKey(0), (n_brick_params(n, n + 1),)
        ) * 0.3
        hre, him = _h_planes(h)
        c = program_costs(run, x0, hre, him)
        OUT[f"deep_bw_step_D{D}"] = round(c["flops"] / steps, 1)
        print(f"deep_bw_step_D{D}: {OUT[f'deep_bw_step_D{D}']:.1f} flops/step",
              flush=True)

print(json.dumps(OUT, indent=1))
