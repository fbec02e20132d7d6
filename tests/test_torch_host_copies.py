"""The port's copies of grom_tpu's JAX-free modules, against grom_tpu.

grom_tpu_torch imports nothing of grom_tpu: it keeps its own copy of every
JAX-free module it runs, under the same relative path. A verbatim copy
must equal grom_tpu's file once its import lines name grom_tpu_torch, so a
copy that drifts fails here by name and a fix made in the reference
carries over by diff. The modules that merge a copy with the port's own
code keep every copied definition as it is in the reference; and the
port's command line parses every flag as grom_tpu's does."""

import ast
import dataclasses
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VERBATIM = [
    "config.py",
    "stats/binom.py", "stats/normal.py",
    "ingest/bgzf.py", "ingest/bai.py", "ingest/bam.py", "ingest/batches.py",
    "ingest/fasta.py", "ingest/insert_size.py",
    "utils/bufpool.py",
    "vcfio/writer.py", "vcfio/tabular.py",
    "call/evidence.py", "call/scan.py", "call/snv.py", "call/sv_screen.py",
    "call/deposits.py", "call/indel.py", "call/sv.py", "call/ctx.py",
    "testing/bulk_sim.py", "testing/cnvmany.py", "testing/fixtures.py",
]

# port module -> (reference module, the definitions copied as they are;
# None: every definition of the reference but those in the set that
# follows)
MERGED = {
    "__init__.py": ("__init__.py", {"_tune_malloc"}),
    "_earlyingest.py": ("_earlyingest.py", {"_MAX_FLAT", "_mmap_buf", "_work",
                                            "start", "take"}),
    "cli.py": ("cli.py", {"_GETOPT", "HELP", "parse_args",
                           "split_regions"}),
    "driver.py": ("driver.py", {
        "DEFAULT_CHUNK_BASES", "_auto_chunk_bases",
        "_start_first_chunk_prefetch", "_sync_ingest",
        "_streaming_insert_stats", "_ctx_path", "_gather_ragged",
        "_subset_reads", "_RdView", "_rd_only_arrays"}),
    "native.py": ("native/__init__.py", {"DepOut", "_bind", "_c_long_p",
                                         "_u8_p"}),
    "call/cnv.py": ("call/cnv.py", None),
}
# the port's own definitions of the modules merged with None: call/cnv.py's
# device branch
OWN = {"call/cnv.py": {"detect_del_dup", "call_cnv"}}

_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)grom_tpu\b", re.M)


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def port_form(src: str) -> str:
    """``src`` with every import of grom_tpu naming grom_tpu_torch."""
    return _IMPORT.sub(r"\1grom_tpu_torch", src)


def _defs(src: str) -> dict:
    """Source of every top-level function, class and single-name
    assignment of a module, by name."""
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.get_source_segment(src, node)
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name)):
            out[node.targets[0].id] = ast.get_source_segment(src, node)
    return out


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copy(path):
    ref = _read("grom_tpu", path)
    got = _read("grom_tpu_torch", path)
    assert got == port_form(ref), (
        "grom_tpu_torch/%s drifted from grom_tpu/%s" % (path, path))


@pytest.mark.parametrize("path", sorted(MERGED))
def test_merged_module_keeps_copied_definitions(path):
    ref_path, names = MERGED[path]
    ref = _defs(port_form(_read("grom_tpu", ref_path)))
    got = _defs(_read("grom_tpu_torch", path))
    if names is None:
        names = set(ref) - OWN[path]
        assert OWN[path] <= set(got)
    assert names
    for name in sorted(names):
        assert name in got, "%s: %s is missing" % (path, name)
        assert got[name] == ref[name], "%s: %s drifted" % (path, name)


def _every_flag():
    """One argv with every flag of the README's flag set, each with a
    value of its type."""
    from grom_tpu.config import FLAG_MAP, TOGGLE_MAP
    value = {str: "x.txt", int: "7", float: "0.25"}
    argv = []
    for flag, (_, typ) in sorted(FLAG_MAP.items()):
        argv += ["-" + flag, value[typ]]
    return argv + ["-" + f for f in sorted(TOGGLE_MAP)]


@pytest.mark.parametrize("case", ["every flag", "defaults", "help",
                                  "no output"])
def test_parse_args_matches_grom_tpu(case, capsys):
    from grom_tpu.cli import parse_args as ref_parse
    from grom_tpu_torch.cli import parse_args
    argv = {"every flag": _every_flag(),
            "defaults": ["-i", "a.bam", "-r", "a.fa", "-o", "a.vcf"],
            "help": ["-i", "a.bam", "-h"],
            "no output": ["-i", "a.bam", "-r", "a.fa", "-V", "1e-4"]}[case]
    got, want = parse_args(list(argv)), ref_parse(list(argv))
    if want is None:
        assert got is None
        return
    assert type(got).__module__ == "grom_tpu_torch.config"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if case == "every flag":
        assert got.rmdup and not got.splitread and got.processes == 7
