"""Nothing the benchmark runs loads JAX or grom_tpu, and the reference
loads nothing of the port. Names are compared whole by their top-level
part: ``grom_tpu_torch`` begins with ``grom_tpu`` and is not it."""

import ast
import glob
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "grom_tpu"}
def top_names(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(glob.glob(os.path.join(BENCH, "*.py"))
                 + glob.glob(os.path.join(BENCH, "metrics", "*.py")))


@pytest.mark.parametrize("path", SOURCES, ids=os.path.basename)
def test_no_jax_nor_grom_tpu(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["plainref.py", "cnvref.py", "synth.py",
                                  "devtrace.py"])
def test_reference_imports_nothing_of_the_port(name):
    assert "grom_tpu_torch" not in top_names(os.path.join(BENCH, name))


def test_prefix_is_not_a_match():
    assert "grom_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_loads_no_port_at_run_time():
    code = ("import sys; sys.path.insert(0, %r); import plainref, cnvref, "
            "synth, devtrace; bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'grom_tpu', 'grom_tpu_torch'}; "
            "print(sorted(bad))" % BENCH)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
