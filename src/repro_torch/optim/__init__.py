"""Optimizers (counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import adamw_init, adamw_update

__all__ = ["adamw_init", "adamw_update"]
