"""Shared set-up of the port's CPU tests (every ``tests/test_torch_*.py``
but the card's ``test_torch_cuda.py``, which needs no JAX).

* One PyTorch intra-op thread.  Tier-1 runs the tests in several pytest
  workers at once (and the distributed tests spawn ranks beside them) on
  a few cores, where PyTorch's default pool of one OpenMP thread a core
  spins against the other processes: a table decode of 8192 words took
  33 ms with 8 threads under such a load and 0.07 ms with one.  The
  tests' tensors are small, so one thread loses nothing unloaded.
* The JAX package's elementwise codec (``repro.core.posit``), jitted, as
  the fixture ``jitted_reference_codec`` patches it in.  Called eagerly
  (by a test or inside the reference's drivers) it compiles every op anew
  for each shape, ~3 s a call; jitted, it compiles one program a shape
  and gives the same words (tests/test_torch_posit.py holds the jitted
  functions to the eager ones on the codec tests' inputs).  A test file
  runs its reference with them by importing the fixture and marking its
  tests with ``pytest.mark.usefixtures("jitted_reference_codec")``.
"""
import jax
import pytest
import torch

from repro.core import posit as JP

torch.set_num_threads(1)

JIT_CODEC = {name: jax.jit(getattr(JP, name), static_argnames="fmt")
             for name in ("from_float64", "to_float64", "from_float32_bits",
                          "to_float32_bits")}


@pytest.fixture
def jitted_reference_codec(monkeypatch):
    """The reference's codec functions replaced by ``JIT_CODEC``'s."""
    for name, fn in JIT_CODEC.items():
        monkeypatch.setattr(JP, name, fn)
