"""What a run loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package; the port's name,
``repro_torch``, only begins with it), checked in a fresh process after
a whole run; and the references import nothing of the program."""
import ast
import glob
import json
import os
import subprocess
import sys

from bench.lib import harness

RUN = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from bench.lib import harness
out = harness.run("smollm-360m-rl.b32x1024", 7, 0.1, True, device="cpu",
                  overrides={sizes})
print(json.dumps({{"correct": out["correct"],
                   "found": harness.forbidden_modules(),
                   "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    from bench.tests.test_bench_reference import LM
    code = RUN.format(root=harness.ROOT,
                      src=os.path.join(harness.ROOT, "src"), sizes=LM)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=harness.ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["found"] == []
    assert "repro_torch" in out["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["tops"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_references_and_yardstick_import_nothing_of_the_program():
    files = glob.glob(os.path.join(harness.BENCH_DIR, "reference", "*.py"))
    files += glob.glob(os.path.join(harness.BENCH_DIR, "work", "*.py"))
    files += [os.path.join(harness.BENCH_DIR, "lib", n)
              for n in ("lm_weights.py", "compare.py")]
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, f


def test_no_bench_file_imports_jax_or_the_jax_package():
    for f in glob.glob(os.path.join(harness.BENCH_DIR, "**", "*.py"),
                       recursive=True):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, f
