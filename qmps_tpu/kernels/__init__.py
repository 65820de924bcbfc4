from .brickwork_fast import manifold_overlap_batched  # noqa: F401
from .energy_fused import energy_objective_fused  # noqa: F401
