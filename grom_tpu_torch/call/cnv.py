"""The CNV stage on the device engines (the counterpart of the device
branch of grom_tpu/call/cnv.py).

``call_cnv`` with ``engine="torch"`` or ``"mesh"`` runs the z-scores, the
null window model and the del/dup window scans through the port's kernels
(ops/cnv_device.py); every other step calls grom_tpu's host helpers as they
are. Any other engine runs grom_tpu's host CNV stage unchanged. Output is
bit-identical to the host engine: the kernels are held to its bits.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from grom_tpu.call import cnv as cnv_ref
from grom_tpu.call.cnv import (CnvCall, _copy_number, _gen1000_track,
                               _repeat_rescore, _sample_distributions,
                               _sticky_ffill, build_pval2sd, format_cnv_rows,
                               prep_cnv, preprocess_reference)
from grom_tpu.config import DerivedConfig, GromConfig
from grom_tpu_torch.ops import cnv_device, state


def detect_del_dup(chrom: np.ndarray, feats, prep, cfg: GromConfig,
                   drv: DerivedConfig, ploidy: int, depth: np.ndarray,
                   device, rng: Optional[np.random.Generator] = None,
                   gen1000_out: Optional[List[str]] = None
                   ) -> Tuple[List[CnvCall], List[CnvCall]]:
    """grom_tpu's detect_del_dup with its device branch on the port's
    kernels: sampling and the low_acgt mask on the host, z-scores / null
    model / seed evaluation on ``device``, the outer walk, rescore and copy
    number on the host."""
    from grom_tpu.utils.timing import phase

    L = len(chrom)
    m = drv.insert_mean
    W = 2 * m - 1
    mq = prep.mq_mean
    gc = feats.gc_weighted
    acgt = feats.acgt_weighted
    NB = cfg.num_gc_bins
    rng = rng or np.random.default_rng(0)

    with phase("cnv.sample"):
        (hi_arr, lo_arr), ave, std, nwin, del_thr, dup_thr = \
            _sample_distributions(chrom, feats, prep, None, None, cfg, drv,
                                  ploidy, rng=rng, depth=depth)

    # ---- low_acgt_or_windows mask (src/GROM.c:18683-18750) ----
    # chunked: the int64 temporaries would otherwise cost ~30B/base at
    # once; the sticky class carries across chunks via its last value
    low_acgt = np.ones(L, dtype=np.int8)
    scan_lo, scan_hi = m - 1, L - W
    carry_cls = 0
    CHK = 16 << 20
    for c0 in range(scan_lo, max(scan_hi, scan_lo), CHK):
        c1 = min(c0 + CHK, scan_hi)
        if c1 <= c0:
            break
        sl_r = slice(c0, c1)
        ok_acgt = acgt[sl_r] >= 99
        def_cls = np.where(mq[sl_r] >= cfg.min_mapq, 0,
                           np.where(depth[sl_r] > 0, 1, -1))
        def_cls = np.where(ok_acgt, def_cls, -1).astype(np.int8)
        cls_ff = _sticky_ffill(def_cls, carry_cls)
        carry_cls = int(cls_ff[-1]) if len(cls_ff) else carry_cls
        nwin_at = nwin[cls_ff, gc[sl_r]]
        low_acgt[sl_r] = np.where(ok_acgt & (nwin_at >= 100), 0, 1)

    # ---- per-base z-scores (src/GROM.c:18770-18965) over the whole
    # chromosome block, as the reference resets it before this stage ----
    pv_p, pv_sd = build_pval2sd()
    stdev_list = np.zeros(L)
    lo_z, hi_z = m - 1, L - W
    if hi_z > lo_z:
        with phase("cnv.zscores_dev"):
            mat, lens = cnv_device.build_bin_matrix(hi_arr, lo_arr, NB)
            tables = state.cnv_tables(mat, lens, ave, std, pv_p, pv_sd,
                                      device)
            mq_b = mq[lo_z:hi_z]
            # the mapq weight stays host-side, in numpy's order
            w = np.where(mq_b >= cfg.min_mapq,
                         cfg.mapq_factor + (1.0 - cfg.mapq_factor)
                         * (mq_b - cfg.min_mapq) / 40.0,
                         cfg.mapq_factor)
            dev = lambda a, dt: state.to_device(a[lo_z:hi_z], dt, device)
            z = cnv_device.zscores(
                dev(depth, np.int32), dev(mq, np.int16), dev(gc, np.int8),
                dev(low_acgt, np.int8), state.to_device(w, np.float64,
                                                        device),
                tables, NB, cfg.min_mapq, cfg.dup_threshold_factor,
                cfg.ranks_stdev != 0)
            stdev_list[lo_z:hi_z] = z.cpu().numpy()

    # ---- null window model on the PRE-rescore z (src/GROM.c:18975-19015:
    # the reference samples its null windows inside the z loop) ----
    with phase("cnv.nullmodel_dev"):
        gate_nm = (low_acgt == 0) & np.where(
            mq >= cfg.min_mapq, nwin[0, gc] > 1, nwin[1, gc] > 1)
        seg = cnv_device.null_segments(prep.lowvar_blocks,
                                       cfg.max_rd_window_len,
                                       cfg.sampling_rate)
        win_std = cnv_device.null_model(
            state.to_device(stdev_list, np.float64, device),
            state.to_device(gate_nm, np.bool_, device), seg,
            cfg.min_rd_window_len, cfg.max_rd_window_len)

    if prep.most_biased_repeat != -1:
        with phase("cnv.rescore"):
            _repeat_rescore(feats, prep, depth, low_acgt, acgt, stdev_list,
                            pv_p, pv_sd, cfg, m, rng)

    scan_blocks = [(m - 1, L - W)]
    with phase("cnv.winscan_dev"):
        dels = cnv_device.window_scan(scan_blocks, depth, mq, gc, nwin,
                                      low_acgt, stdev_list, del_thr, win_std,
                                      cfg, L, +1, device)
        dups = cnv_device.window_scan(scan_blocks, depth, mq, gc, nwin,
                                      low_acgt, stdev_list, dup_thr, win_std,
                                      cfg, L, -1, device)
    with phase("cnv.copynum"):
        _copy_number(dels, dups, depth, mq, gc, low_acgt, ave, ploidy, cfg)
    if gen1000_out is not None and cfg.gen1000_window > 0:
        gen1000_out.extend(_gen1000_track(depth, mq, gc, low_acgt, ave,
                                          ploidy, cfg, L))
    return dels, dups


def call_cnv(chrom: np.ndarray, rd_hi: np.ndarray, rd_lo: np.ndarray,
             rd_mq_sum: np.ndarray, cfg: GromConfig, drv: DerivedConfig,
             chr_name: str, is_chrx: bool = False,
             gen1000_out: Optional[List[str]] = None,
             engine: str = "host", release=None,
             device="cuda") -> List[str]:
    """Full CNV pipeline for one chromosome (grom_tpu's call_cnv). With
    ``engine="torch"`` or ``"mesh"`` the z / null-model / window-scan
    kernels run on ``device``; otherwise grom_tpu's host stage runs as it
    is."""
    if engine not in ("torch", "mesh"):
        return cnv_ref.call_cnv(chrom, rd_hi, rd_lo, rd_mq_sum, cfg, drv,
                                chr_name, is_chrx, gen1000_out=gen1000_out,
                                engine="host", release=release)
    del is_chrx   # the reference's chrX ploidy halving is dead code
    from grom_tpu.utils.timing import phase
    with phase("cnv.prep_ref"):
        feats = preprocess_reference(chrom, drv.insert_mean, cfg.min_repeat)
    depth = np.add(rd_hi, rd_lo, dtype=np.int32)
    with phase("cnv.prep"):
        prep = prep_cnv(chrom, feats, rd_hi, rd_lo, rd_mq_sum, cfg, drv,
                        depth=depth)
    # only (depth, mq_mean) per-base inputs are needed from here on
    del rd_hi, rd_lo, rd_mq_sum
    if release is not None:
        release()
    dels, dups = detect_del_dup(chrom, feats, prep, cfg, drv, cfg.ploidy,
                                depth, device, gen1000_out=gen1000_out)
    return format_cnv_rows(chr_name, dels, dups, cfg)
