"""Nothing the benchmark runs imports JAX or the JAX package, or reads
the JAX package's harness (``benchmarks/``).  A run at a tiny size, with
every module of the benchmark and every metric reader loaded, in a fresh
process, then its modules' top-level names compared whole
(``repro_torch`` is not ``repro``)."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import argparse, json, sys
sys.path[:0] = [{bench!r}, {src!r}]
import calibrate, run, spans, workload
from reference import check, lu, posit
from conftest import CELLS, tiny_cell
for name in CELLS:
    spec = workload.load_cell(name)["spec"]
    for m in spec["per_layer"]:
        run.load_metric(m["name"])
    for trace in (0, 1):
        args = argparse.Namespace(workload=name, seed=9, seconds=0.05,
                                  trace=trace)
        run.run(args, device="cpu", cell=tiny_cell(name, n=32, nb=16))
print(json.dumps({{
    "top": sorted({{m.split(".")[0] for m in sys.modules}}),
    "files": sorted(str(getattr(m, "__file__", "") or "")
                    for m in list(sys.modules.values())),
    "forbidden": run.forbidden_modules()}}))
"""


def test_no_jax_no_reference_package():
    code = SCRIPT.format(bench=str(ROOT / "bench"), src=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not {"jax", "jaxlib", "flax", "repro"} & set(seen["top"])
    assert seen["forbidden"] == []
    assert "repro_torch" in seen["top"]
    bench_dir = str(ROOT / "benchmarks") + "/"
    assert not [f for f in seen["files"] if f.startswith(bench_dir)]
