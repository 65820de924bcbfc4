"""qmps_tpu — a JAX framework for uniform-MPS quantum circuits.

A ground-up rebuild of the capabilities of the reference qMPS codebase
(fergusfinn/qmps): translationally invariant matrix product states represented
as parametrized quantum circuits, optimized and time-evolved entirely with
jit-compiled tensor contractions on an accelerator (an NVIDIA GPU) — no
circuit simulator in the loop.

Layer map (bottom to top):

- ``core``        Lie-algebra parametrizations of SU(N), Pauli algebra, gate set,
                  differentiable isometry completion (reference: qmps/tools.py,
                  new_tdvp/unitary_param.py, xmps.spin).
- ``mps``         uniform MPS tensors, canonical forms, transfer operators and
                  their fixed points (batched differentiable power iteration),
                  classical TDVP (reference: the external xmps library).
- ``embed``       tensor<->unitary and environment<->unitary embeddings
                  (reference: qmps/tools.py:76-154, qmps/time_evolve_tools.py:38-74).
- ``circuits``    circuit IR -> dense unitary compiler + the ansatz zoo
                  (reference: qmps/represent.py:268-442, experiments/Jamie.py).
- ``ham``         Pauli-string Hamiltonians and exact-physics oracles
                  (reference: qmps/ground_state.py:66-118, qmps/exact_loschmidt.py).
- ``env``         exact / variational / power-method environments
                  (reference: qmps/represent.py:18-53, new_tdvp/ClassicalTDVPStripped.py:599-655).
- ``objectives``  energy, TDVP-overlap, trace-distance, noisy and sampled
                  objectives as pure jitted functions of the parameters.
- ``optim``       gradient optimizers (optax) + jittable Rotosolve.
- ``algorithms``  ground-state search, environment representation, TDVP time
                  evolution / Loschmidt echoes, many-body scars.
- ``parallel``    vmap/shard_map sweep infrastructure over a device mesh.
- ``kernels``     batched contractions and the fused D=2 energy kernel
                  (Pallas, Triton route).

Numerics policy: float64/complex128 is enabled globally (the 1e-10 parity
targets require it); accelerator hot paths run 32-bit where speed matters
and accuracy allows (see ``qmps_tpu.config``).
"""
import os

import jax

# Correctness default: float64/complex128 (the 1e-10 parity targets need it).
# Accelerator runs (bench.py, chip_smoke.py, __graft_entry__.py) set
# QMPS_TPU_X64=0 before importing: with x64 disabled every dtype request
# canonicalizes to 32-bit.
if os.environ.get("QMPS_TPU_X64", "1") == "1":
    jax.config.update("jax_enable_x64", True)

# Full float32 matmuls everywhere: at the default precision a GPU runs
# float32 products in TF32 (10-bit mantissa), and repeated-squaring fixed
# points and Lie exponentials need full f32 accumulation (O(1) energy
# errors in the phase-diagram sweep without it).  Callers that can afford
# cheaper products ask for them locally (the Stiefel sweep's descent tier).
jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

from . import config  # noqa: E402,F401
