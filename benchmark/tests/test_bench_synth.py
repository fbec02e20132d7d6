"""The generator copy writes the same bytes as the port's own
``testing/bulk_sim.py bulk_genome`` (the only file of the benchmark's
that may import the port is this test)."""

import filecmp

import numpy as np

import pytest

import synth

GENOMES = {
    "one_200kb": [dict(name="chrone", length=200_000, seed=5,
                       hotspots=[(50_000, 60_000, 20.0)],
                       depressions=[(120_000, 130_000, 0.4)],
                       repeats=[(170_000, 172_000, b"AT")])],
    "three_scaffolds": [dict(name="s1", length=450_000, seed=[7, 0],
                             hotspots=[(100_000, 110_000, 20.0)]),
                        dict(name="s2", length=200_000, seed=[7, 1]),
                        dict(name="s3", length=120_000, seed=[7, 2],
                             repeats=[(50_000, 52_000, "AT")])],
}


@pytest.mark.parametrize("genome", sorted(GENOMES))
def test_bytes_equal_bulk_sim(tmp_path, genome):
    from grom_tpu_torch.testing import bulk_sim
    specs = GENOMES[genome]
    old = [dict(s, repeats=[(a, b, d.encode() if isinstance(d, str) else d)
                            for a, b, d in s.get("repeats", [])])
           for s in specs]
    bulk_sim.bulk_genome(str(tmp_path / "a"), old)
    fa, bam, info = synth.bulk_genome(str(tmp_path / "b"), specs, threads=3)
    for ext in (".fa", ".bam", ".bam.bai"):
        assert filecmp.cmp(str(tmp_path / ("a" + ext)),
                           str(tmp_path / ("b" + ext)), shallow=False), ext
    assert [c["length"] for c in info] == [s["length"] for s in specs]


def test_stream_replays_the_same_reads():
    spec = GENOMES["one_200kb"][0]
    a = [s for s in synth.contig_stream(spec, 0)]
    b = [s for s in synth.contig_stream(spec, 0)]
    assert (a[0]["pos"] == b[0]["pos"]).all()
    assert all((synth.slice_bases(a[0], x) == synth.slice_bases(b[0], y))
               .all() and (x["qual"] == y["qual"]).all()
               for x, y in zip(a[1:], b[1:]))


def test_150_base_reads_read_back(tmp_path):
    """A 150-base layout is written as the port's BAM reader reads it: the
    same positions, bases and qualities as the stream's."""
    from grom_tpu_torch.ingest import bam as port_bam
    spec = dict(name="chrlong", length=120_000, seed=11, read_len=150,
                insert_mean=550, insert_sd=100, hom_share=0.5)
    fa, path, info = synth.bulk_genome(str(tmp_path / "g"), [spec],
                                       threads=2)
    assert info[0]["read_len"] == 150
    stream = synth.contig_stream(spec, 0)
    head = next(stream)
    seq = np.concatenate([synth.slice_bases(head, sl) for sl in stream])
    _, reads = port_bam.read_bam_region(path, 0, 0, spec["length"])
    assert (np.asarray(reads.pos) == head["pos"]).all()
    assert (reads.lseq == 150).all()
    assert (reads.cigar == 150 << 4).all()
    assert (reads.seq.reshape(seq.shape) == seq).all()


@pytest.mark.parametrize("bad", [dict(indel_rate=1e-4), dict(sv_count=3),
                                 dict(read_len=151)])
def test_layout_it_cannot_make_is_refused(bad):
    with pytest.raises(ValueError):
        next(synth.contig_stream(dict(name="c", length=50_000, seed=1,
                                      **bad), 0))
