"""The port's host engine loads no torch, as grom_tpu's host engine loads no
jax: a process imports torch only when a stage of its run is on a device
(``driver.device_stages``: the torch and mesh engines, or the host engine
with GROM_TPU_DEVICE_CNV=1 or GROM_TPU_DEVICE_SV=1).

* The host-engine CLI in fresh processes under ``python -X importtime``
  (which spawn passes on to ``-P`` workers), on every path: streamed
  (BAI), whole-batch (no BAI), the ``-c`` region child and ``-P 2``
  (parent and both workers), with GROM_TPU_TIMING unset and at 1, and
  with either knob at 0. Each run matches the reference-binary oracle
  and its import log names no ``torch``.
* The other side: with a knob at 1 the host engine loads torch and runs
  the stage's plain kernels on the CPU (no launch is counted).
* The gate's modules alone: importing ``ops/sv_device.py``, asking
  ``maybe_scorer`` for a scorer the policy leaves off, and reading the
  card peak of no CUDA device load no torch.
"""

import json
import os
import shutil

import pytest

from test_full_parity import _rows
from test_torch_slice import DATA, _cli

DS = os.path.join(DATA, "ds200k")
CTX = os.path.join(DATA, "ctx2x60k")
REGION = "0,0,0,110000"


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _modules(stderr):
    """The modules named by a ``-X importtime`` log."""
    return [ln.rsplit("|", 1)[-1].strip() for ln in stderr.splitlines()
            if ln.startswith("import time:")]


def _json_lines(stderr, key):
    return [json.loads(ln.split(" ", 1)[1]) for ln in stderr.splitlines()
            if ln.startswith(key + " {")]


def _run_mode(mode, tmp_path, env):
    """Run the host-engine CLI in ``mode`` under ``-X importtime``; check
    its output against the oracle and return (stderr, processes that
    imported the CLI)."""
    out = str(tmp_path / "o.vcf")
    bam, fa = os.path.join(DS, "ds.bam"), os.path.join(DS, "ds.fa")
    extra, procs = [], 1
    if mode == "whole":
        shutil.copy(bam, tmp_path / "ds.bam")
        bam = str(tmp_path / "ds.bam")
    elif mode == "child":
        extra = ["-c", REGION]
    elif mode == "P2":
        bam, fa = os.path.join(CTX, "ds.bam"), os.path.join(CTX, "ds.fa")
        extra, procs = ["-P", "2"], 3
    env = dict(env, GROM_TPU_TORCH_ENGINE="host")
    r = _cli(["-X", "importtime", "-m", "grom_tpu_torch", "-i", bam,
              "-r", fa, "-o", out, *extra], env)
    assert r.returncode == 0, r.stderr[-3000:]
    if mode == "child":
        oracle = os.path.join(DS, "oracle.region-0-0-110000")
        assert _read(out + ".chrSim-0") == _read(oracle)
        assert _read(out + ".chrSim-0.ctx") == _read(oracle + ".ctx")
    else:
        d = CTX if mode == "P2" else DS
        assert _rows(out) == _rows(os.path.join(d, "oracle.vcf"))
        assert _rows(out[:-4] + ".ctx.vcf") == _rows(
            os.path.join(d, "oracle.ctx.vcf"))
    return r.stderr, procs


# (mode, environment): every mode with GROM_TPU_TIMING unset and at 1, and
# the streamed path with either knob at 0
CASES = [pytest.param(m, {"GROM_TPU_TIMING": t},
                      id="%s-timing-%s" % (m, t or "unset"))
         for m in ("streamed", "whole", "child", "P2") for t in ("", "1")]
CASES += [pytest.param("streamed", {k: "0"}, id="streamed-%s-0" % k)
          for k in ("GROM_TPU_DEVICE_SV", "GROM_TPU_DEVICE_CNV")]


@pytest.mark.parametrize("mode,env", CASES)
def test_host_engine_cli_loads_no_torch(tmp_path, mode, env):
    """Every path of the host-engine CLI imports the SV scorer's module
    (its gate) and the port's CLI in each process, and no process loads
    torch. Under GROM_TPU_TIMING=1 the peak-memory report has no card and
    every ``-P`` job reports a worker without torch."""
    env = dict({"GROM_TPU_TIMING": "", "GROM_TPU_DEVICE_SV": "",
                "GROM_TPU_DEVICE_CNV": ""}, **env)
    err, procs = _run_mode(mode, tmp_path, env)
    mods = _modules(err)
    assert mods.count("grom_tpu_torch.cli") == procs
    assert "grom_tpu_torch.ops.sv_device" in mods
    assert "torch" not in mods
    if env["GROM_TPU_TIMING"] == "1" and mode != "child":
        (mem,) = _json_lines(err, "peak_memory")
        assert mem["card"] is None and mem["rss_peak_kib"] > 0
        jobs = _json_lines(err, "parallel_job")
        assert len(jobs) == (2 if mode == "P2" else 0)
        assert not any(j["torch_loaded"] for j in jobs)


@pytest.mark.parametrize("knob", ["GROM_TPU_DEVICE_SV",
                                  "GROM_TPU_DEVICE_CNV"])
def test_host_engine_knob_at_one_loads_torch(tmp_path, knob):
    """With a knob at 1 the host engine puts that stage on its device: on
    the CPU, torch is loaded and the stage's plain kernels run (the SV
    scorer is cached, the CNV kernels' module is loaded), no kernel launch
    is counted, and the output matches the oracle."""
    out = str(tmp_path / "o.vcf")
    used = ("from grom_tpu_torch.ops import sv_device\n"
            "assert sv_device._CACHE, 'the SV scorer was not used'\n"
            if knob == "GROM_TPU_DEVICE_SV" else
            "assert 'grom_tpu_torch.ops.cnv_device' in sys.modules\n")
    code = (
        "import sys\n"
        "from grom_tpu_torch import _build\n"
        "from grom_tpu_torch.config import GromConfig\n"
        "from grom_tpu_torch.driver import run\n"
        "assert 'torch' not in sys.modules\n"
        "run(GromConfig(bam=%r, ref_fasta=%r, out_vcf=%r), engine='host',"
        " device='cpu')\n"
        "assert 'torch' in sys.modules\n"
        "%s"
        "assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)\n"
        % (os.path.join(DS, "ds.bam"), os.path.join(DS, "ds.fa"), out, used))
    other = ({"GROM_TPU_DEVICE_CNV", "GROM_TPU_DEVICE_SV"} - {knob}).pop()
    r = _cli(["-c", code], {knob: "1", other: ""})
    assert r.returncode == 0, r.stderr[-3000:]
    assert _rows(out) == _rows(os.path.join(DS, "oracle.vcf"))


@pytest.mark.parametrize("code", [
    pytest.param("from grom_tpu_torch.ops import sv_device\n", id="sv_device"),
    pytest.param(
        "from grom_tpu_torch.utils import peakmem\n"
        "assert peakmem.card_peak([]) is None\n"
        "assert peakmem.card_peak(['cpu']) is None\n"
        "assert peakmem.report(['cpu'])['card'] is None\n",
        id="card_peak"),
    pytest.param(
        "import os, numpy as np\n"
        "from types import SimpleNamespace as NS\n"
        "from grom_tpu_torch.ops import sv_device\n"
        "cfg = NS(add_factor=10, max_trials=50, min_disc=3,"
        " pval_threshold1=1e-4)\n"
        "drv = NS(insert_mean=400, read_len=101)\n"
        "tab = np.zeros((51, 51))\n"
        "assert sv_device.maybe_scorer('host', tab, tab, cfg, drv,"
        " 'cuda') is None\n"
        "os.environ['GROM_TPU_DEVICE_SV'] = '0'\n"
        "for e in ('host', 'torch', 'mesh'):\n"
        "    assert sv_device.maybe_scorer(e, tab, tab, cfg, drv,"
        " 'cuda') is None\n",
        id="maybe_scorer_off"),
])
def test_gate_modules_load_no_torch(code):
    """In a fresh interpreter: the SV scorer's module imports without
    torch, the card peak of no CUDA device is None without it, and a
    scorer the policy leaves off is None without it."""
    r = _cli(["-c", code + "import sys\n"
              "assert 'torch' not in sys.modules, 'torch was loaded'\n"],
             {"GROM_TPU_DEVICE_SV": "", "GROM_TPU_DEVICE_CNV": ""})
    assert r.returncode == 0, r.stderr[-3000:]
