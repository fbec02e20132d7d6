"""The plain reference on inputs small enough to work out by hand."""

import numpy as np
import pytest

import cnvref
import plainref

G = dict(min_mapq=20, min_base_qual=20, min_snv=3, min_snv_ratio=0.2,
         min_ave_bq=15.0, ploidy=2, overlap_mult=1,
         insert_sample_size=10_000_000, insert_max_mult=5,
         insert_num_st_devs=3.0, num_gc_bins=101, sample_lists_len=100_000,
         block_unit_size=10000, chr_rd_threshold_factor=2, min_blocks=4,
         min_rd_window_len=100, snv_rd_min_factor=1.75,
         high_cov_min_snv_ratio=0.4)
RL = 100


def small_contig():
    """Six reads over position 150 (ref G): three forward high-mapq T's,
    two high-mapq G's (one reverse), one low-mapq T; a seventh read far
    right sets the scan's end."""
    L = 1000
    genome = np.frombuffer(b"ACGT" * (L // 4), np.uint8).copy()
    assert chr(genome[150]) == "G"
    starts = np.array([100, 110, 120, 130, 140, 145, 800])
    flags = np.array([0x63, 0x63, 0x63, 0x63, 0x93, 0x63, 0x63], np.uint16)
    mapq = np.array([60, 60, 60, 60, 60, 10, 60])
    qual = np.zeros((7, RL), np.uint8)
    qual[:, :] = np.arange(7)[:, None] + 30
    seq = np.stack([genome[s:s + RL] for s in starts])
    for i in (0, 1, 2, 5):
        seq[i, 150 - starts[i]] = ord("T")
    return plainref.Contig("chrt", L, genome, starts.astype(np.int64),
                           starts + 200, np.full(7, 300, np.int32), flags,
                           mapq.astype(np.int64), seq, qual, RL)


def test_snv_row_by_hand():
    c = small_contig()
    ex = plainref.snv_expect(c, 0, 0, np.full(c.length, 6), G)
    row = ex.rows[151]
    # A C G T high; A C G T low; BQ = (30+..+35)/6; MQ = (5*60+10)/6;
    # PIR of T: forward mismatches at 50, 40, 30; FS = 3/3
    assert row == ("chrt\t151\t\tG\tT\t.\t.\t.\tGT:PR:AF:A:C:G:T:AL:CL:GL:TL:"
                   "BQ:MQ:PIR:FS\t1/0:6.000000e-01:0:0:2:3:0:0:0:1:32.50:"
                   "51.67:40.00:1.00")
    assert 151 in ex.required and not ex.excluded
    low = plainref.snv_expect(c, 0, 0, np.full(c.length, 6), G, "lower")
    assert low.rows[151].split("\t")[-1].split(":")[1] == "6.015625e-01"


def test_snv_screen_needs_three_alt_reads():
    c = small_contig()
    c.seq[2, 150 - 120] = ord("G")
    ex = plainref.snv_expect(c, 0, 0, np.full(c.length, 6), G)
    assert 151 not in ex.rows


def test_depth_lists_by_hand():
    c = small_contig()
    hi, lo, mq = plainref.depth_lists(c, 0, G)
    assert hi[150] == 5 and lo[150] == 1 and mq[150] == 310
    assert hi[99] == 0 and hi[100] == 1 and hi[199] == 5 and hi[200] == 4
    # reads starting before the scan start are not counted
    hi2, _, _ = plainref.depth_lists(c, 111, G)
    assert hi2[150] == 3


def test_insert_stats_by_hand():
    c = small_contig()
    c.flag = np.full(7, 0x63, np.uint16)
    c.tlen = np.array([300, 310, 290, 305, 295, 2000, 301], np.int32)
    mean, imax = plainref.insert_stats([c], G)
    # sorted 290 295 300 301 305 310 2000: median 301, 2000 > 5x dropped,
    # median of six 301; min index 0, so the max reads one past: 2000
    assert (mean, imax) == (301, 2000)
    assert plainref.scan_start(301, 2000, G) == (2 * 8 * 2001) // 4 + 1


def test_broken_sort_orders_by_low_words():
    def with_low(word, hi=0x3FF00000):
        return np.array([(hi << 32) | word], np.uint64).view(np.float64)[0]
    v = np.array([with_low(3), with_low(1, 0x40000000), with_low(2)])
    assert list(plainref.broken_sort(v)) == [v[1], v[2], v[0]]
    # int32 wraparound: 0x90000000 - 0 is negative, so it sorts first
    w = np.array([with_low(0), with_low(0x90000000)])
    assert list(plainref.broken_sort(w)) == [w[1], w[0]]


def test_copy_number_by_hand():
    n = 20
    st = plainref.CnvState(depth=np.array([10] * 10 + [30] * 10),
                           mq_mean=np.full(n, 60), gc=np.full(n, 40),
                           low_acgt=np.zeros(n, np.int8),
                           ave=np.zeros((2, 101)), nwin=None, samples=None,
                           blocks=[], mean=0)
    st.ave[0, 40] = 20.0
    cn, cs = plainref.copy_number(st, 0, n, G)
    # values 0.5 x10 and 1.5 x10; trim 2 a side: 8 + 8 of the middle,
    # mean 1.0, times ploidy 2; SD of 2v about 2: 1.0
    assert cn == pytest.approx(2.0) and cs == pytest.approx(1.0)
    assert plainref.copy_number(st, 0, 0, G) == (-1.0, 0.0)


def test_bf16():
    x = np.array([1 / 3, 0.6, 1.0], np.float32)
    assert list(plainref.bf16(x)) == [0.333984375, 0.6015625, 1.0]


def test_judge_counts_each_kind():
    c = small_contig()
    ex = plainref.Expect([c], {"chrt": plainref.snv_expect(
        c, 0, 0, np.full(c.length, 6), G)}, {}, {"chrt": []}, G, "stated")
    good = ex.snv["chrt"].rows[151]
    head, _, s = good.rpartition("\t")
    row = head + "\t" + ":".join(s.split(":")[:1] + ["1e-9"]
                                 + s.split(":")[1:])
    assert plainref.judge(row + "\n", "", ex)[0] == 0
    assert plainref.judge("", "", ex)[1]["snv_missing"] == 1
    assert plainref.judge(row.replace(":3:0:0:0:1:", ":4:0:0:0:1:") + "\n",
                          "", ex)[1]["snv_wrong"] == 1
    sv = "chrt\t10\t.\t.\t<INV>\t.\t.\tEND=20\tSPR\t0"
    assert plainref.judge(row + "\n" + sv + "\n", "x\n", ex)[0] == 2
    # a CNV row is compared whole: one with another SD is wrong, and the
    # reference's row is then missing
    cnv = ("chrt\t101\t.\t.\t<DEL>\t.\t.\tEND=300\tSD:Z:CN:CS\t"
           "6.500000e+00:4.010000e-11:1.00:2.000000e-01")
    ex.cnv_rows["chrt"] = [cnv]
    assert plainref.judge(row + "\n" + cnv + "\n", "", ex)[0] == 0
    d = plainref.judge(row + "\n" + cnv.replace("6.5", "6.4") + "\n", "",
                       ex)[1]
    assert (d["cnv_wrong"], d["cnv_missing"]) == (1, 1)


def test_pvalue_table_ends():
    ps, sds = cnvref.pval_table()
    assert len(ps) == 1001 and sds[0] == 10.0 and sds[-1] == 0.0
    assert (np.diff(ps) >= 0).all()
    assert ps[-1] == pytest.approx(0.5, abs=1e-8)


def test_zscore_midrank_by_hand():
    """A GC bin's sample of 10, 20, 30, 40 (mean 25): depth 20 lies below,
    ranks 1 (left) and 2 (right), p = 3/8, the first SD whose tail passes
    it 0.31; depth 35 lies above, 1 and 1 from the top, p = 1/4, SD
    -0.67; both at mapq 60, weight 1. The bases at the ends are outside
    the scan range [m - 1, L - 2m + 1) and stay 0."""
    L = 8
    nwin = np.zeros((2, 101), np.int64)
    nwin[0, 50] = 4
    samples = [[np.zeros(0, np.int64)] * 101 for _ in range(2)]
    samples[0][50] = np.array([10, 20, 30, 40])
    ave = np.zeros((2, 101))
    ave[0, 50] = 25.0
    st = plainref.CnvState(depth=np.array([20, 20, 35, 20, 35, 0, 0, 0]),
                           mq_mean=np.full(L, 60), gc=np.full(L, 50),
                           low_acgt=np.zeros(L, np.int8), ave=ave,
                           nwin=nwin, samples=samples, blocks=[], mean=2)
    z = cnvref.zscores(st, G)
    assert z.tolist() == pytest.approx([0, 0.31, -0.67, 0.31, -0.67, 0, 0,
                                        0])
