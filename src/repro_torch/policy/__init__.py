"""Unified branchless policy engine, in torch (port of ``repro.policy``).

  * ``Policy``       — declarative preset (strings, for humans/presets);
  * ``PolicyArrays`` — the same policy as a NamedTuple of float32 tensors
    (one-hot select weights and scalar knobs);
  * ``ops``          — pure, branchless decision functions driven by a
    ``PolicyArrays``.

  * ``DecisionTables`` — per-warp-type numpy lookup tables derived from
    the same ops, for host-side control planes (the serving pool).
"""
from repro_torch.policy.spec import (BYPASS_MECHS, INSERT_MECHS,
                                     LABEL_MECHS, Policy, PolicyArrays,
                                     arrays_from_numpy, policy_row,
                                     stack_policies, to_arrays)
from repro_torch.policy.tables import DecisionTables
from repro_torch.policy import ops

__all__ = [
    "BYPASS_MECHS", "INSERT_MECHS", "LABEL_MECHS", "Policy",
    "PolicyArrays", "arrays_from_numpy", "policy_row", "stack_policies",
    "to_arrays", "DecisionTables", "ops",
]
