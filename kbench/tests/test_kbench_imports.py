"""The import guard: nothing the benchmark loads is JAX or the JAX
package (top-level module names compared whole: ``kaarme_tpu_torch``
begins with ``kaarme_tpu``), and the reference loads nothing of the
program."""

import ast
import glob
import json
import os
import subprocess
import sys

KB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(KB)
FORBIDDEN = {"jax", "jaxlib", "flax", "kaarme_tpu"}


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    return glob.glob(os.path.join(KB, sub, "**", "*.py"), recursive=True)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not set(imported_tops(path)) & FORBIDDEN, path
    for path in sources("reference"):
        assert "kaarme_tpu_torch" not in set(imported_tops(path)), path


def test_no_source_reads_the_jax_package_bench():
    for path in sources():
        if os.path.basename(os.path.dirname(path)) == "tests":
            continue
        with open(path) as f:
            text = f.read()
        assert not any(s in text for s in ("BENCH_r", "BENCHMATRIX_", "MULTICHIP_",
                                           "ENDURANCE_", "import bench", "from bench")), path


CHILD = r"""
import json, sys
sys.path.insert(0, ROOT)
from kbench import control, gen, judge, roofline, run, trace
from kbench.tests.test_kbench_harness import small
for m in json.load(open(ROOT + "/BENCHMARK.json"))["per_layer"]:
    run.reader(m["name"])
for name in ("ecoli-k51.err1pct", "ecoli-k51-bf.err1pct"):
    res = run.run_cell(small(name, genome=5000), 1, 0.1, True, device="cpu")
    assert res["correct"], res
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps(dict(forbidden=run.forbidden_modules(), tops=tops)))
"""


def test_a_run_loads_no_jax_module():
    p = subprocess.run([sys.executable, "-c", f"ROOT = {ROOT!r}\n" + CHILD], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == [] and not set(out["tops"]) & FORBIDDEN
    assert "kaarme_tpu_torch" in out["tops"]        # the port ran, and is not mistaken for it


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "from kbench.reference import kmer_count\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert p.returncode == 0 and not tops & (FORBIDDEN | {"kaarme_tpu_torch"})
