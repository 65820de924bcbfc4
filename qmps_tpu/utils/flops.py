"""Analytic FLOP/byte accounting from XLA's cost model.

``program_costs`` reads FLOP and byte counts out of XLA's own cost model
for a lowered program (backend-independent HLO math; used by
scripts/flops_audit.py).  No device peak is assumed here: a roofline share
needs peaks measured on the device in the same run.

Complex arithmetic counts as its real-FLOP content (one complex FMA = 8
real FLOPs), which is what XLA's cost model reports for complex HLOs.
"""
from __future__ import annotations

from typing import Callable


def program_costs(fn: Callable, *args, static_argnums=()) -> dict:
    """FLOP/byte counts of ``fn(*args)`` from XLA's cost model.

    Lowers and compiles on the CURRENT default backend (run under a CPU
    jax.config for audit use — compiles are host-local and the HLO flop
    count is backend-independent).  Returns {"flops": float, "bytes":
    float} (absolute, for the given arg shapes).
    """
    import jax

    jitted = jax.jit(fn, static_argnums=static_argnums)
    costs = jitted.lower(*args).compile().cost_analysis()
    return {
        "flops": float(costs.get("flops", 0.0)),
        "bytes": float(costs.get("bytes accessed", 0.0)),
    }
