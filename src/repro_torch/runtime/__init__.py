"""The fault-tolerant training loop (port of ``repro.runtime``)."""
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 InjectedFailure, LoopResult,
                                                 StragglerDetector,
                                                 reshard_tree,
                                                 run_fault_tolerant)

__all__ = ["FailureInjector", "InjectedFailure", "LoopResult",
           "StragglerDetector", "reshard_tree", "run_fault_tolerant"]
