"""Shared set-up of the benchmark's own tests (``python -m pytest bench``):
the benchmark's modules and the program on the path, and the cells cut
to a size the CPU runs in a second, with the plain kernels."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

CELLS = ("lu_p32e2_n1024.factor_b300", "chol_p32e2_n1024.updates_b100")


def tiny_cell(name: str, n: int = 64, nb: int = 16, batch: int = 10):
    """The cell ``name`` as BENCHMARK.json has it, its sizes cut."""
    import workload as wl
    cell = wl.load_cell(name)
    cell["config"] = dict(cell["config"], n=n, nb=nb)
    cell["traffic"] = dict(cell["traffic"], batch=batch)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
