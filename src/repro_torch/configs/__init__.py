"""Architecture registry (counterpart of ``repro.configs``): one module per
architecture, the port's own copies of the published configurations.

``get_config(name)`` accepts the dashed public id (e.g. 'qwen2-0.5b').
Every module exposes ``config()`` (the published configuration) and
``smoke_config()`` (a reduced same-family config for CPU tests);
``tests/test_torch_models.py`` holds every field to the reference's.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.shapes import (SHAPE_CELLS, ShapeCell,
                                        applicable_cells, cell_by_name,
                                        tiny_config)

ARCH_IDS = [
    "whisper-tiny",
    "moonshot-v1-16b-a3b",
    "granite-moe-1b-a400m",
    "zamba2-2.7b",
    "qwen2-0.5b",
    "llama3-405b",
    "gemma3-12b",
    "starcoder2-7b",
    "mamba2-780m",
    "internvl2-26b",
]


def _module(name: str):
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, policy: str | None = None):
    cfg = _module(name).config()
    if policy is not None:
        cfg = dataclasses.replace(cfg, policy=policy)
    return cfg


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def get_tiny_config(name: str, policy: str | None = None):
    cfg = tiny_config(name)
    if policy is not None:
        cfg = dataclasses.replace(cfg, policy=policy)
    return cfg


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "get_tiny_config",
           "SHAPE_CELLS", "ShapeCell", "applicable_cells", "cell_by_name",
           "tiny_config"]
