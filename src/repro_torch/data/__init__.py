"""Data pipelines: synthetic, deterministic, host-sharded (port of the JAX package's ``repro.data``)."""
from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig, batches

__all__ = ["SyntheticLM", "SyntheticLMConfig", "batches"]
