"""Core: Posit(n, es) formats and the PyTorch posit codec."""
from repro_torch.core.formats import (FORMATS, P8E0, P8E2, P16E1, P32E2,
                                      PositFormat, get_format)
from repro_torch.core import posit

__all__ = ["FORMATS", "P8E0", "P8E2", "P16E1", "P32E2", "PositFormat",
           "get_format", "posit"]
