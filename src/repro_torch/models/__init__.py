"""Model zoo (counterpart of ``repro.models``, training and inference): the
blocks and their assembly for every architecture family."""
from repro_torch.models.common import ArchConfig
from repro_torch.models.lm import (forward_prefill, forward_train,
                                   init_cache, init_params, serve_step)

__all__ = ["ArchConfig", "forward_prefill", "forward_train", "init_cache",
           "init_params", "serve_step"]
