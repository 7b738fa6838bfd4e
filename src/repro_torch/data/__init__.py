"""The synthetic LM data pipeline (port of ``repro.data``)."""
from repro_torch.data.pipeline import (CheckpointableIterator, DataConfig,
                                       SyntheticLM)

__all__ = ["CheckpointableIterator", "DataConfig", "SyntheticLM"]
