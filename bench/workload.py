"""The general generator: a cell's data files found by name, the input
words made on the device from ``--seed``, and the unit of work, loaded
from ``units/<unit>.py`` by the name that the traffic mix gives.

A configuration file names the algorithm (``algo``), its sizes (``n``,
``nb``), the posit format, the GEMM backend and the input kind; a
traffic file names the unit (``unit``), the batch and the sigma grid.
A unit module has ``make(cfg, traffic, seed, device)``, which makes the
cell's inputs and returns an object with the interface of ``Unit``
below; it imports the program by name at call time and drives it only
through its public entry points.  A later mix that needs a new kind of
work adds a unit file, and a new end-to-end or per-layer metric adds a
reader in ``metrics/``: no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import torch

from reference import posit as ref_posit

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BLOCK = 10                  # matrices per f64 block: ~0.1 GB a tensor at n=1024


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, its
    configuration's file, its traffic file and its limits file."""
    spec = load_json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    entry = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return {"spec": spec, "workload": entry,
            "config": load_json(ROOT / configs[entry["config"]]["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json")}


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` under the benchmark, loaded by path."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {folder[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_unit(cfg: dict, traffic: dict, seed: int, device):
    """The unit that the traffic mix names, with its inputs made."""
    return load_module("units", traffic["unit"]).make(cfg, traffic, seed,
                                                      device)


class Unit:
    """What the harness drives.  ``run()`` is one unit of work and
    returns its output; ``keep(out)`` keeps what the check reads;
    ``check(limits)`` returns (numbers compared, failed answers,
    information); ``controls()`` the numbers of each control (the
    reference in a lower precision in the program's place), for
    ``calibrate.py`` and the tests.  ``flops`` is a unit's paper flop
    count and ``answers`` the answers it produces.

    ``warm()`` is the set-up's warm-up and ``window(seconds, sync)`` the
    measured loop; both may be overridden by a unit whose traffic is not
    a closed loop."""

    flops = 0.0
    answers = 0

    def run(self):
        raise NotImplementedError

    def keep(self, out) -> None:
        pass

    def warm(self, sync) -> None:
        self.run()
        sync()

    def window(self, seconds: float, sync) -> list[float]:
        """Whole units back to back, one in flight, until one ends past
        ``seconds``; each unit's end, in seconds from the start."""
        ends = []
        t0 = time.perf_counter()
        while True:
            out = self.run()
            sync()
            ends.append(time.perf_counter() - t0)
            self.keep(out)
            if ends[-1] >= seconds:
                return ends


def make_values(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The (batch, n, n) f64 input of a seed, before rounding to words:
    matrix i at sigma ``sigmas[i // (batch / len(sigmas))]``."""
    batch, n, sigmas = traffic["batch"], cfg["n"], traffic["sigmas"]
    if batch % len(sigmas):
        raise ValueError("batch must be a multiple of the sigma grid")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn((batch, n, n), generator=g, dtype=torch.float64,
                    device=device)
    sig = torch.tensor(sigmas, dtype=torch.float64, device=device)
    x *= sig.repeat_interleave(batch // len(sigmas))[:, None, None]
    if cfg["input"] == "general":
        return x
    if cfg["input"] == "spd":
        for s in range(0, batch, BLOCK):
            x[s:s + BLOCK] = x[s:s + BLOCK].mT @ x[s:s + BLOCK]
        return x
    raise ValueError(f"unknown input {cfg['input']!r}")


def make_words(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The input words both sides get: the values rounded by the
    benchmark's own codec, in blocks of matrices."""
    fmt = ref_posit.fmt_of(cfg["fmt"])
    x = make_values(cfg, traffic, seed, device)
    words = torch.empty(x.shape, dtype=torch.int32, device=device)
    for s in range(0, x.shape[0], BLOCK):
        words[s:s + BLOCK] = ref_posit.from_float64(x[s:s + BLOCK], fmt)
    return words


def values(words: torch.Tensor, fmt) -> torch.Tensor:
    return ref_posit.to_float64(words, fmt)


def program_format(cfg: dict):
    """The program's format object for the configuration's ``fmt``."""
    formats = importlib.import_module("repro_torch.core.formats")
    return formats.get_format(cfg["fmt"])
