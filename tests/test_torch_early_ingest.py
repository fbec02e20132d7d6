"""The port's early BGZF ingest (grom_tpu_torch/_earlyingest.py) and the
imports of the port.

* Every import of a ``grom_tpu_torch`` module in the port resolves to a
  module of the port, or to a name one of its modules defines (an AST
  scan, one case per file). None is dead.
* With the port's native library built, ``_earlyingest.start`` then
  ``take`` on ds200k gives the whole file inflated; without it, no hit and
  nothing is built.
* A CLI run on ds200k with GROM_TPU_EARLY=1 (host engine) takes the early
  result and writes the same files as the run without it, whose rows equal
  the reference-binary oracle.
* The module imports neither numpy nor grom_tpu nor jax."""

import ast
import glob
import gzip
import os
import subprocess
import sys

import pytest
import torch

from test_full_parity import _rows, _rows_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
PKG = "grom_tpu_torch"
FILES = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, PKG, "**", "*.py"), recursive=True))

torch.set_num_threads(1)


def _module_file(name: str):
    """The file of the port's module ``name`` (a.b.c), or None."""
    base = os.path.join(REPO, *name.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


def _bound(target):
    """Names an assignment target binds (also inside tuples)."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(*(_bound(t) for t in target.elts))
    return set()


def _top_names(path: str) -> set:
    """Names bound at the top level of a module (defs, classes,
    assignments, imports; also inside top-level ``if`` and ``try``)."""
    with open(path) as f:
        body = list(ast.parse(f.read()).body)
    out = set()
    while body:
        node = body.pop()
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(*(_bound(t) for t in node.targets))
        elif isinstance(node, ast.AnnAssign):
            out.update(_bound(node.target))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
        elif isinstance(node, (ast.If, ast.Try)):
            body += node.body + node.orelse + getattr(node, "finalbody", [])
            for h in getattr(node, "handlers", []):
                body += h.body
    return out


def _unresolved(path: str):
    """(line, module) of every import of the port in ``path`` that names
    no module of the port and no name a module of it defines."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    pkg = os.path.dirname(path).replace(os.sep, ".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if (a.name.split(".")[0] == PKG
                        and _module_file(a.name) is None):
                    yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                parts = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                mod = ".".join(parts + ([mod] if mod else []))
            if mod.split(".")[0] != PKG:
                continue
            src = _module_file(mod)
            if src is None:
                yield node.lineno, mod
                continue
            for a in node.names:
                sub = mod + "." + a.name
                if (_module_file(sub) is None
                        and a.name not in _top_names(src)):
                    yield node.lineno, sub


@pytest.mark.parametrize("path", FILES)
def test_port_imports_resolve(path):
    assert set(_unresolved(path)) == set()


def test_import_scan_finds_a_missing_module(tmp_path, monkeypatch):
    """The scan is not vacuous: an import of a module the port lacks is
    found."""
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "a.py").write_text("from grom_tpu_torch import missing\n"
                              "from grom_tpu_torch.a import f\n"
                              "import grom_tpu_torch.nothere\n"
                              "def f():\n    pass\n")
    monkeypatch.setattr(sys.modules[__name__], "REPO", str(tmp_path))
    assert sorted(_unresolved(os.path.join(PKG, "a.py"))) == [
        (1, "grom_tpu_torch.missing"), (3, "grom_tpu_torch.nothere")]


def test_early_module_imports_no_numpy():
    """The early thread starts before numpy: importing the module (and
    the port's package, its native loader's path) pulls in none of
    numpy, torch, grom_tpu or jax."""
    code = ("import sys; import grom_tpu_torch._earlyingest as e; "
            "e._native_so(); print(sorted({m.split('.')[0] for m in "
            "sys.modules} & {'numpy', 'torch', 'grom_tpu', 'jax'}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_early_start_take_hit():
    """With the port's native library built, the early thread inflates
    the whole of ds200k's BAM: every byte, from the port's library."""
    from grom_tpu_torch import _earlyingest, native
    assert native.get_lib() is not None
    bam = os.path.join(DATA, "ds200k", "ds.bam")
    _earlyingest.DONE.pop(os.path.abspath(bam), None)
    _earlyingest.start(bam)
    got = _earlyingest.take(bam)
    assert got is not None and got["n_blocks"] > 0
    with open(bam, "rb") as f:
        want = gzip.decompress(f.read())
    n = got["n_blocks"]
    assert got["uoff"][n] == len(want)
    assert bytes(got["flat"]) == want
    assert _earlyingest._native_so() == native.library_path()
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR


def test_early_without_library_no_hit(monkeypatch, tmp_path):
    """No built library (a fresh checkout): no early hit, and nothing is
    built."""
    from grom_tpu_torch import _earlyingest, native
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    bam = os.path.join(DATA, "ds200k", "ds.bam")
    _earlyingest.DONE.pop(os.path.abspath(bam), None)
    _earlyingest.start(bam)
    assert _earlyingest.take(bam) is None
    assert os.listdir(tmp_path) == []
    _earlyingest.DONE.pop(os.path.abspath(bam), None)


# a CLI run as ``python -m grom_tpu_torch`` makes it, with the early
# result's hand-over to the BGZF reader counted
_CLI_WITH_SPY = """
import sys
sys.argv = ["grom_tpu_torch"] + sys.argv[1:]
import grom_tpu_torch
from grom_tpu_torch import _earlyingest
hits = []
take = _earlyingest.take
def spy(path, wait=30.0):
    r = take(path, wait)
    hits.append(r is not None)
    return r
_earlyingest.take = spy
from grom_tpu_torch.cli import main
rc = main(sys.argv[1:])
print("early hits", sum(hits), "of", len(hits))
sys.exit(rc)
"""


def _body(path):
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"##fileDate"))


def test_cli_early_ingest_same_output(tmp_path):
    from grom_tpu_torch import native
    assert native.get_lib() is not None
    d = os.path.join(DATA, "ds200k")
    argv = ["-i", os.path.join(d, "ds.bam"), "-r", os.path.join(d, "ds.fa")]
    env = dict(os.environ, PYTHONPATH=REPO, GROM_TPU_TORCH_ENGINE="host",
               OMP_NUM_THREADS="1")
    env.pop("GROM_TPU_EARLY", None)
    outs = {}
    for tag, early, cmd in (
            ("plain", False, ["-m", "grom_tpu_torch"]),
            ("early", True, ["-m", "grom_tpu_torch"]),
            ("spy", True, ["-c", _CLI_WITH_SPY])):
        out = str(tmp_path / ("%s.vcf" % tag))
        e = dict(env, GROM_TPU_EARLY="1") if early else env
        r = subprocess.run([sys.executable, *cmd, *argv, "-o", out],
                           cwd=REPO, env=e, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        outs[tag] = (out, r.stdout)
    # the first BGZF reader of the BAM takes the early result (later ones
    # read the file themselves, as grom_tpu's do)
    assert "early hits 1 of " in outs["spy"][1]
    plain = outs["plain"][0]
    for tag in ("early", "spy"):
        out = outs[tag][0]
        assert _body(out) == _body(plain)
        assert _body(out[:-4] + ".ctx.vcf") == _body(plain[:-4] + ".ctx.vcf")
    got, want = _rows(plain), _rows(os.path.join(d, "oracle.vcf"))
    assert len(got) == len(want) > 0
    assert all(_rows_equal(a, b) for a, b in zip(got, want))
