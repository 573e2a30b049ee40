"""Synthetic data (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import input_specs, make_batch

__all__ = ["make_batch", "input_specs"]
