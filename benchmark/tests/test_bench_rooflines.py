"""The byte counts of the two roofline metrics on a tiny input."""

import importlib.util
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK = 3.35e12


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ctx(intervals):
    return dict(intervals=intervals, cards={0: intervals}, passes=2,
                contigs=[dict(length=1000, reads=10, read_len=100),
                         dict(length=500, reads=4, read_len=150)],
                peaks=dict(hbm_bytes_per_s=PEAK), window_s=1.0)


def test_tile_bytes():
    iv = [(0.0, 600.0, "tile_window(Tile, Scratch, int*)", "kernel"),
          (700.0, 1100.0, "tile_compact(int)", "kernel"),
          (1200.0, 9000.0, "zs_table(ZIn)", "kernel"),
          (0.0, 5000.0, "Memcpy HtoD (Pinned -> Device)", "gpu_memcpy")]
    # each pass: 2 bytes an aligned base (10 reads of 100, 4 of 150) + 4 a
    # position
    want = 2 * (2 * (10 * 100 + 4 * 150) + 4 * 1500)
    got = reader("tile_accumulate_roofline")(ctx(iv))
    assert got == pytest.approx(100 * want / PEAK / 1e-3)


def test_cnv_bytes():
    iv = [(0.0, 250.0, "zs_onepass(ZIn, double const*)", "kernel"),
          (300.0, 550.0, "null_accum(NIn)", "kernel"),
          (600.0, 700.0, "tile_window(Tile)", "kernel")]
    want = 2 * 25 * 1500
    got = reader("cnv_scan_roofline")(ctx(iv))
    assert got == pytest.approx(100 * want / PEAK / 500e-6)


def test_silent_without_kernels():
    assert reader("cnv_scan_roofline")(ctx([])) is None
    assert reader("device.idle_share")(ctx([])) is None
    iv = [(0.0, 250e3, "k", "kernel"), (100e3, 500e3, "m", "gpu_memcpy")]
    assert reader("device.idle_share")(ctx(iv)) == pytest.approx(50.0)
