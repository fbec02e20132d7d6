"""grom_tpu_torch stands alone: it imports nothing of grom_tpu or jax,
builds its own native library, and runs on the CPU only when asked to.

* Every module of the port, chip_smoke.py and tools/torch_scale.py import
  no module of jax or grom_tpu, at the top or inside a function (an AST
  scan, one case per file).
* The port's native library builds from native/*.c with ``cc`` into its
  own build directory; nothing runs ``make`` or writes into native/.
* GROM_TPU_TORCH_ENGINE=auto (the default) with no CUDA device raises and
  names GROM_TPU_TORCH_ENGINE=host; the CLI then writes no output.

The runs that show no module of grom_tpu or jax is ever loaded (the CLI on
the host engine; in-process torch and mesh runs, all against the oracle)
are ``test_cli_never_imports_jax`` and ``test_torch_engine_never_imports_jax``
in test_torch_slice.py."""

import ast
import ctypes
import glob
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
FILES = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "grom_tpu_torch", "**", "*.py"), recursive=True)
    if os.path.getsize(p))
FILES += ["chip_smoke.py", os.path.join("tools", "torch_scale.py")]
FOREIGN = ("jax", "jaxlib", "grom_tpu")


def _imported(src: str):
    """Every module name an import statement of ``src`` names."""
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES)
def test_no_import_of_jax_or_grom_tpu(path):
    with open(os.path.join(REPO, path)) as f:
        src = f.read()
    bad = [m for m in _imported(src) if m.split(".")[0] in FOREIGN]
    assert not bad, "%s imports %s" % (path, bad)
    assert "import_module(" not in src and "__import__(" not in src


def test_native_library_builds_in_the_port(monkeypatch, tmp_path):
    from grom_tpu_torch import native
    calls = []
    real = subprocess.run

    def spy(cmd, *a, **k):
        calls.append(list(cmd))
        return real(cmd, *a, **k)

    monkeypatch.setattr(native.subprocess, "run", spy)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    so = native._build()
    assert so is not None and os.path.dirname(so) == str(tmp_path)
    assert os.path.basename(so).startswith("grom_native-")
    assert os.listdir(tmp_path) == [os.path.basename(so)]
    assert calls and all(c[0] == "cc" for c in calls)
    build = [c for c in calls if so + "." in c[c.index("-o") + 1]]
    assert len(build) == 1
    srcs = sorted(os.path.relpath(a, REPO) for a in build[0]
                  if a.endswith(".c"))
    assert srcs == sorted("native/" + s for s in native.SOURCES)
    native._bind(ctypes.CDLL(so))      # every entry point is there
    # a second build finds the hashed library and compiles nothing
    calls.clear()
    assert native._build() == so
    assert all("-o" not in c or c[c.index("-o") + 1] == os.devnull
               for c in calls)


@pytest.mark.parametrize("env", [None, "auto"])
def test_auto_without_card_raises(monkeypatch, env):
    from grom_tpu_torch.driver import resolve_engine
    if env is None:
        monkeypatch.delenv("GROM_TPU_TORCH_ENGINE", raising=False)
    else:
        monkeypatch.setenv("GROM_TPU_TORCH_ENGINE", env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GROM_TPU_TORCH_ENGINE=host"):
        resolve_engine()


def test_default_engine_on_this_host(monkeypatch):
    """The default engine where the test runs: a device engine with a
    card, an error naming the host engine without one."""
    from grom_tpu_torch.driver import resolve_engine
    monkeypatch.delenv("GROM_TPU_TORCH_ENGINE", raising=False)
    if torch.cuda.is_available():
        want = "mesh" if torch.cuda.device_count() > 1 else "torch"
        assert resolve_engine() == want
    else:
        with pytest.raises(RuntimeError, match="GROM_TPU_TORCH_ENGINE=host"):
            resolve_engine()


def test_cli_without_card_writes_nothing(tmp_path):
    d = os.path.join(DATA, "ds200k")
    out = str(tmp_path / "o.vcf")
    env = {k: v for k, v in os.environ.items()
           if k != "GROM_TPU_TORCH_ENGINE"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "grom_tpu_torch",
                        "-i", os.path.join(d, "ds.bam"),
                        "-r", os.path.join(d, "ds.fa"), "-o", out],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "GROM_TPU_TORCH_ENGINE=host" in r.stderr
    assert not os.listdir(tmp_path)
