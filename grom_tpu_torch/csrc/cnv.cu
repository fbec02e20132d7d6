// CNV kernels for the streamed calling path: per-base z-scores, per-seed
// window evaluation and the null window-length model, all in f64.
//
// Replaces, in grom_tpu/ops/cnv_device.py:
//   zscores_device (inner ``kern``)    -> gt_zscores
//   seed_eval_device (vmapped ``one``) -> gt_seed_eval (two tiers)
//   null_model_device (``eval_batch``) -> gt_null_model (three passes a
//                                         batch of segments)
//
// What bounds them on an H100:
//   * z-scores: per base, a forward-filled depth class, a (class, GC) bin,
//     two midrank counts in the bin's sorted row, a pval2sd bisection and
//     the mapq weight. Its bound is the bytes: 8 bytes of inputs and 8 of
//     z a base. So one pass reads each input once: persistent blocks take
//     tiles of 2,048 bases in order, with vector loads; the sticky class
//     is a running maximum of idx * 2 + class (the class rides in the low
//     bit, so no gather at the filled index) scanned per thread, warp and
//     block and carried across tiles by a decoupled look-back over one
//     state word a tile. The z before the weight is a function of (bin
//     row, depth) alone, so a first launch computes it once for every
//     depth a row's count table covers (cnt[v] = #(row <= v), built on the
//     host once per call: under a megabyte at 30x, L2-resident), and a
//     base reads it there and multiplies by its mapq's weight from a
//     shared-memory table; only depths past a row's table (a bisection of
//     the row's tail) or mapqs past the weight table are computed in place.
//   * seed evaluation: per (seed, class), a walk over the seed's window up
//     to its first fail: integer counts, one f64 add per offset into a
//     running total that must stay a sequential chain in the host's order,
//     and an f64 division per grow offset. Its bound is the card's FP64
//     rate over those adds and divisions (tens of microseconds for the
//     largest launch of a 24 Mb run), with each position read once.
//     Most seeds fail within a few offsets; a seed whose first window
//     passes may walk up to maxw = 10000. With one thread per seed a warp
//     runs as long as its longest seed, each step waits on its loads and
//     its division, and the loads scatter. So two tiers, as grom_tpu's
//     two-width scheme (valid because a fail depends only on data before
//     it). Tier 1: one thread per seed over its first window (minw
//     offsets rounded up to 32), loading 16 offsets at a time. The seeds
//     still walking are compacted on the card (an atomic slot count, no
//     host sync). Tier 2 gives each of them one warp that reads 32
//     consecutive offsets at a time, coalesced: svals plus one flag byte
//     that packs the five per-position conditions. The counts and the
//     first fail are ballot prefix counts; only the adds of the running
//     total stay serial (lane 0, from shared memory); the divisions, the
//     good tests and the maxima run on all 32 lanes. Tier 2 holds the
//     largest launches: about 8 instructions per window offset, most of
//     them lane 0's chain and the ballots, so the rate at which a warp
//     scheduler starts instructions bounds it, far above the FP64 bound.
//   * null model: per batch of segments, pass A writes each segment's
//     sequential prefix of gated z and of gate counts to scratch, one warp a
//     segment: loads and stores 64 consecutive positions at a time, the
//     counts by ballots, the f64 chain by lane 0 from registers loaded
//     from shared memory, with the gate and z loads of the next two chunks
//     already issued. A one-warp pass walks the segments' totals in order
//     into each segment's carry (the host's ``_carries``, resets included;
//     lane 0 adds), continuing a running state kept on the card. Pass B
//     gives every window length one owner thread (small blocks, so the
//     10,000 owners spread over every SM) that walks the batch's segments
//     in order, with their parameters staged in shared memory and sixteen
//     segments' loads and divisions ahead of its add chain. All batches go
//     back to back on the stream: no host round trip, one copy back of the
//     sums and counts. Pass B takes the most time, held by its loads of the
//     batch's prefixes (12 bytes per owner and segment), not by its
//     arithmetic: deeper loads ahead, other block sizes and no division at
//     all measured about the same.
//
// Exactness: results are held to the host's bits (call/cnv.py,
// native/grom_cnv.c): every sum accumulates sequentially in the host's
// order, nothing uses float atomics, and the library is built with
// --fmad=false so no multiply-add is contracted.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

inline int blocks_for(long n) { return (int)((n + BLOCK - 1) / BLOCK); }

// ---------------------------------------------------------------------------
// z-scores: one pass over the per-base data
// ---------------------------------------------------------------------------

constexpr int ZT = 256;             // threads of a z block
constexpr int ZMINB = 3;            // z blocks an SM holds (80 registers)
constexpr int ZI = 8;               // consecutive bases a thread holds
constexpr int ZTILE = ZT * ZI;      // bases of a tile
constexpr int ZTW = 4096;           // depths of a row in the z table
constexpr int ZROW = 5;             // ints per bin row (ops/cnv_device.py)
constexpr unsigned ZFULL = 0xffffffffu;
// a tile's output staged in shared memory, one pad double every 16 so
// that the per-thread writes (8 doubles apart) spread over the banks
constexpr int ZOUT = ZTILE + ZTILE / 16;
__device__ __forceinline__ int zpad(int e) { return e + (e >> 4); }

struct ZIn {
  const int32_t* depth;
  const int16_t* mq;
  const int8_t* gc;
  const int8_t* low_acgt;
  const int32_t* rows;    // [R, ZROW]: nk, width, cnt offset, tail offset,
                          // tail length
  const int32_t* cnt;     // cnt[off + v] = #(row <= v), v in [0, width)
  const int32_t* tail;    // per row, its values >= width, ascending
  const double* ave;      // [R]
  const double* std;      // [R]
  const double* pv_p;     // [P], non-decreasing
  const double* pv_sd;    // [P]
  long n;
  int R;
  int P;
  int nb;
  int min_mapq;
  double mf;              // mapq_factor
  double omf;             // 1.0 - mapq_factor, as the host computes it
  double dup_thr_factor;
  int ranks;
};

// A tile's state word for the look-back: flag << 32 | (value + 1); flag 1:
// the tile's own aggregate (value -1: no update in it), flag 2: the
// inclusive forward-fill state up to the tile's end.
__device__ __forceinline__ unsigned long long zs_word(int flag, int val) {
  return ((unsigned long long)flag << 32) | (unsigned)(val + 1);
}

// #(row <= key) for the row whose ZROW ints are ``r``
__device__ __forceinline__ long count_le(const ZIn& z, const int* r,
                                         long key) {
  if (key < 0) return 0;
  if (key < r[1]) return __ldg(z.cnt + r[2] + key);
  // past the table: the row's values below its width, then a bisection
  // of the tail (empty unless the row reaches the table cap)
  const int32_t* t = z.tail + r[3];
  int lo = 0, hi = r[4];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long)__ldg(t + mid) <= key) lo = mid + 1; else hi = mid;
  }
  return (long)(r[0] - r[4]) + lo;
}

// The z of depth d in bin row k before the mapq weight: midrank counts and
// pval2sd (ranks), or the bin's mean and stdev; ``pvp``/``pvsd`` the
// pval2sd table in shared or global memory. A function of (k, d) alone.
// Not inlined: the one-pass kernel calls it only past the (row, depth)
// table, and its ``z`` is the kernel's __grid_constant__ parameter, so
// the reference costs no copy.
__device__ __noinline__ double zs_base(const ZIn& z, const int* r, int k,
                                       long d, const double* pvp,
                                       const double* pvsd) {
  const long nk = r[0];
  const double dd = (double)d;
  const double av = z.ave[k];
  const bool below = dd < av;
  const double clamp = z.dup_thr_factor * av;
  if (z.ranks) {
    const long key_l = dd > clamp ? (long)clamp : d;
    // the reference bisection's quirk: n == 2 with result 0 gives 1
    auto fx = [nk](long c) { return (nk == 2 && c == 0) ? 1L : c; };
    long bi, bi2;
    if (below) {
      bi = fx(count_le(z, r, d));
      bi2 = fx(count_le(z, r, d - 1));
    } else {
      bi = nk - fx(count_le(z, r, key_l - 1));
      bi2 = nk - fx(count_le(z, r, d));
    }
    const double di = bi <= 0 ? 0.5 : (double)bi;
    const double di2 = bi2 <= 0 ? 0.5 : (double)bi2;
    const double prob = (di + di2) / (2.0 * (double)nk);
    int lo = 0, hi = z.P;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pvp[mid] <= prob) lo = mid + 1; else hi = mid;
    }
    const int pi = lo < z.P - 1 ? lo : z.P - 1;
    return below ? pvsd[pi] : -pvsd[pi];
  }
  const double sb = z.std[k];
  if (below || !(dd > clamp)) return sb != 0.0 ? (av - dd) / sb : 0.0;
  return sb != 0.0 ? (z.dup_thr_factor - 1.0) * (-av) / sb : 0.0;
}

// the mapq weight in numpy's order of operations (no contraction: the
// library is built with --fmad=false)
__device__ __forceinline__ double zs_weight(const ZIn& z, int mq) {
  return mq >= z.min_mapq
      ? z.mf + (z.omf * (double)(mq - z.min_mapq)) / 40.0 : z.mf;
}

constexpr int ZW = 256;   // mapq values of the weight table

// The z of every (row, depth < ZTW) pair before the mapq weight into
// ``base`` [R, ZTW], one thread a pair (grid: rows x ZTW / 256; the pval2sd
// bisections read through L1). Most bases then read their z here instead
// of computing it.
__global__ void zs_table(const __grid_constant__ ZIn z, double* base) {
  const int k = blockIdx.x;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const int* r = z.rows + k * ZROW;
  if (r[0] > 0 && v < ZTW)
    base[(long)k * ZTW + v] = zs_base(z, r, k, v, z.pv_p, z.pv_sd);
}

// A thread's ZI bases of a full tile as loaded: 64 bytes in five vector
// loads (the inputs are 16-byte aligned)
struct ZRaw {
  int4 d0, d1, mm;
  int2 gg, ll;
};

__device__ __forceinline__ void zs_load(const ZIn& z, long b0, ZRaw& w) {
  w.d0 = __ldg((const int4*)(z.depth + b0));
  w.d1 = __ldg((const int4*)(z.depth + b0) + 1);
  w.mm = __ldg((const int4*)(z.mq + b0));
  w.gg = __ldg((const int2*)(z.gc + b0));
  w.ll = __ldg((const int2*)(z.low_acgt + b0));
}

// One pass: a persistent block takes tiles of ZTILE bases in order
// (``next_tile``, claimed a tile ahead, its loads issued while the current
// tile is evaluated), loads each tile's depth, mq, gc and low_acgt once,
// finds the sticky class of every base (a running maximum of idx * 2 +
// class over the updating bases: thread, warp and block scans, then a
// decoupled look-back over the earlier tiles' state words) and writes its
// z: the (row, depth) table's z times the weight of its mapq (a table of
// ZW values in shared memory), computed in place only past either table.
__global__ void __launch_bounds__(ZT, ZMINB) zs_onepass(
    const __grid_constant__ ZIn z, const double* base,
    unsigned long long* status, int* next_tile, long ntiles, double* out) {
  extern __shared__ double zsm[];
  double* s_out = zsm;                     // [ZOUT]
  double* s_w = s_out + ZOUT;              // [ZW]
  int* s_rows = (int*)(s_w + ZW);          // [R * ZROW]
  __shared__ long s_first, s_next;
  __shared__ int s_warp[ZT / 32];
  __shared__ int s_excl;
  for (int i = threadIdx.x; i < ZW; i += ZT) s_w[i] = zs_weight(z, i);
  for (int i = threadIdx.x; i < z.R * ZROW; i += ZT) s_rows[i] = z.rows[i];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_first = atomicAdd(next_tile, 1);
  __syncthreads();
  long tile = s_first;
  ZRaw raw;
  if ((tile + 1) * ZTILE <= z.n)
    zs_load(z, tile * ZTILE + (long)threadIdx.x * ZI, raw);

  while (tile < ntiles) {
    const long b0 = tile * ZTILE + (long)threadIdx.x * ZI;
    const bool full = (tile + 1) * ZTILE <= z.n;
    // claim the next tile now; its id is read after the first barrier
    if (threadIdx.x == 0) s_next = atomicAdd(next_tile, 1);
    int dv[ZI], mv[ZI], gv[ZI], lv[ZI];
    if (full) {
      dv[0] = raw.d0.x; dv[1] = raw.d0.y; dv[2] = raw.d0.z; dv[3] = raw.d0.w;
      dv[4] = raw.d1.x; dv[5] = raw.d1.y; dv[6] = raw.d1.z; dv[7] = raw.d1.w;
      // unpacked by shifts (little-endian lanes), in registers
      const unsigned mw[4] = {(unsigned)raw.mm.x, (unsigned)raw.mm.y,
                              (unsigned)raw.mm.z, (unsigned)raw.mm.w};
      const unsigned gw[2] = {(unsigned)raw.gg.x, (unsigned)raw.gg.y};
      const unsigned lw[2] = {(unsigned)raw.ll.x, (unsigned)raw.ll.y};
#pragma unroll
      for (int j = 0; j < ZI; ++j) {
        mv[j] = (int16_t)(mw[j >> 1] >> (16 * (j & 1)));
        gv[j] = (int8_t)(gw[j >> 2] >> (8 * (j & 3)));
        lv[j] = (int8_t)(lw[j >> 2] >> (8 * (j & 3)));
      }
    } else {
#pragma unroll
      for (int j = 0; j < ZI; ++j) {
        const bool in = b0 + j < z.n;
        dv[j] = in ? z.depth[b0 + j] : 0;
        mv[j] = in ? z.mq[b0 + j] : 0;
        gv[j] = in ? z.gc[b0 + j] : 0;
        lv[j] = in ? z.low_acgt[b0 + j] : 1;   // not eligible
      }
    }

    // definite class (0 high mapq, 1 low mapq with depth, -1 none), the
    // eligibility, and the thread's running forward-fill state
    int defz[ZI], pre[ZI];
    bool elig[ZI];
    int run = -1;
#pragma unroll
    for (int j = 0; j < ZI; ++j) {
      const bool hi_mq = mv[j] >= z.min_mapq;
      defz[j] = hi_mq ? 0 : (dv[j] > 0 ? 1 : -1);
      const int ke = (hi_mq ? 0 : z.nb) + gv[j];
      elig[j] = lv[j] == 0 && s_rows[ke * ZROW] > 1;
      if (elig[j] && defz[j] >= 0) run = (int)((b0 + j) * 2 + defz[j]);
      pre[j] = run;
    }
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(ZFULL, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int texcl = __shfl_up_sync(ZFULL, incl, 1);
    if (lane == 0) texcl = -1;
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    const long next = s_next;
    if ((next + 1) * ZTILE <= z.n)
      zs_load(z, next * ZTILE + (long)threadIdx.x * ZI, raw);
    int wexcl = -1, agg = -1;
#pragma unroll
    for (int w = 0; w < ZT / 32; ++w) {
      const int v = s_warp[w];
      if (w < warp) wexcl = max(wexcl, v);
      agg = max(agg, v);
    }
    if (warp == 0) {
      // an updating tile knows its inclusive state at once (its last
      // update is the largest index so far); the others publish their
      // aggregate, look back, then their inclusive state
      if (lane == 0)
        atomicExch(status + tile, agg >= 0 ? zs_word(2, agg)
                                           : zs_word(1, -1));
      int excl = -1;
      for (long t = tile - 1; t >= 0; t -= 32) {
        const long tt = t - lane;
        int flag = 2, val = -1;
        if (tt >= 0) {
          unsigned long long w;
          do {
            w = *((volatile unsigned long long*)status + tt);
          } while ((w >> 32) == 0);
          flag = (int)(w >> 32);
          val = (int)(unsigned)(w & 0xffffffffu) - 1;
        }
        const unsigned done = __ballot_sync(ZFULL, flag == 2);
        const int stop = done ? __ffs(done) - 1 : 31;
        excl = max(excl, __reduce_max_sync(ZFULL, lane <= stop ? val : -1));
        if (done) break;
      }
      if (lane == 0) {
        s_excl = excl;
        if (agg < 0) atomicExch(status + tile, zs_word(2, excl));
      }
    }
    __syncthreads();
    const int carry = max(s_excl, max(wexcl, texcl));

#pragma unroll
    for (int j = 0; j < ZI; ++j) {
      const int fi = max(carry, pre[j]);
      const int cls = defz[j] >= 0 ? defz[j] : (fi >= 0 ? (fi & 1) : 0);
      const int k = cls * z.nb + gv[j];
      const int* r = s_rows + k * ZROW;
      const bool valid = b0 + j < z.n && elig[j] && r[0] > 0;
      double bz = 0.0, w = 0.0;
      if (valid) {
        bz = dv[j] >= 0 && dv[j] < ZTW
            ? __ldg(base + (long)k * ZTW + dv[j])
            : zs_base(z, r, k, dv[j], z.pv_p, z.pv_sd);
        w = mv[j] >= 0 && mv[j] < ZW ? s_w[mv[j]] : zs_weight(z, mv[j]);
      }
      s_out[zpad(threadIdx.x * ZI + j)] = valid ? w * bz : 0.0;
    }
    __syncthreads();
    const long t0 = tile * ZTILE;
    for (int e = threadIdx.x; e < ZTILE; e += ZT)
      if (t0 + e < z.n) out[t0 + e] = s_out[zpad(e)];
    tile = next;
  }
}

// Per-position flags of the seed walk, one byte each (ops/cnv_device.py
// pack_flags).
constexpr uint8_t F_LOWA = 1;    // low_acgt == 0 (gated)
constexpr uint8_t F_SOK0 = 2;    // passes the class-0 seed threshold
constexpr uint8_t F_SOK1 = 4;    // passes the class-1 seed threshold
constexpr uint8_t F_GCLS1 = 8;   // the last gated-definite base is class 1
constexpr uint8_t F_GDEF = 16;   // the base itself is gated-definite
constexpr unsigned FULL = 0xffffffffu;
constexpr int T1_BATCH = 16;     // offsets a tier-1 thread loads at once

struct SeedIn {
  const double* svals;
  const uint8_t* flags;
  const double* win_std;   // [maxw + 1]
  long L;
  long minw;
  long maxw;
  double max_low;
  long be;
  long tier1;              // minw rounded up to 32
};

// A seed still walking after tier 1: where its walk stands at offset
// ``tier1``.
struct SeedCarry {
  double lt;            // running total
  double c_sd0;         // first-window score when it begins, else 0
  double c_sd_grow;     // best grow score so far
  int64_t t;            // index of the seed
  int32_t n;            // window length
  int32_t inc_before;   // included bases so far
  int32_t lc;           // gated bases so far
  int32_t lastg;        // last good offset, -1 when none
  int32_t seen;         // a gated-definite base lies in the window so far
  int32_t begin0;       // the first window begins a call
};

__device__ __forceinline__ long window_len(const SeedIn& s, int64_t seed) {
  long n = s.be - seed;
  if (n < s.minw) n = s.minw;
  if (n > s.maxw) n = s.maxw;
  return n;
}

// The five outcomes of seed t, rows of the packed [5, NS] output: f1,
// begin, c_end, c_sd (its bits), n.
__device__ __forceinline__ void put(int64_t* out, long NS, long t, long f1,
                                    bool begin, int64_t c_end, double c_sd,
                                    long n) {
  out[t] = f1;
  out[NS + t] = begin ? 1 : 0;
  out[2 * NS + t] = c_end;
  out[3 * NS + t] = __double_as_longlong(c_sd);
  out[4 * NS + t] = n;
}

// The grow test at offset j (>= minw): a good base updates the best score
// and the last good offset, as the host loop does.
__device__ __forceinline__ bool grow_good(const SeedIn& s, long j, bool inc,
                                          double lt, long lc, double* tsg) {
  if (!inc || lc <= 0) return false;
  const long wl = j + 1;
  const double wsg = s.win_std[wl < s.maxw ? wl : s.maxw];
  if (!(wsg > 0.0)) return false;
  *tsg = lt / ((double)lc * wsg);
  return *tsg >= 3.0 && (double)(wl - lc) / (double)wl <= s.max_low;
}

// Tier 1: one thread per seed over its first ``tier1`` offsets, or up to
// its first fail. A seed that ends there writes its outcomes; a seed still
// walking takes a slot (atomic count) for tier 2 and leaves its carry.
__global__ void seed_eval_tier1(SeedIn s, const int64_t* seeds,
                                const int8_t* seed_cls, long NS,
                                int64_t* out, SeedCarry* carry,
                                int* n_long) {
  const long t = (long)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= NS) return;
  const int64_t seed = seeds[t];
  const int cls_m = seed_cls[t];
  const long n = window_len(s, seed);
  const long lim = n < s.tier1 ? n : s.tier1;
  long f1 = -1;               // the first fail, -1 while none
  long inc_before = 0;
  long low_count0 = 0;        // gated bases among the first minw
  long lc = 0;                // gated bases up to j
  bool seen = false;
  double lt = 0.0;            // sequential total, as the host accumulates
  double low_total0 = 0.0;
  bool any_good = false;
  long lastg = -1;
  double c_sd_grow = 0.0;
  // offsets in batches: a batch's loads are all in flight at once, so a
  // step waits on the running total, not on memory
  for (long j0 = 0; j0 < lim && f1 < 0; j0 += T1_BATCH) {
    uint8_t fb[T1_BATCH];
    double sb[T1_BATCH];
#pragma unroll
    for (int k = 0; k < T1_BATCH; ++k) {
      const long p = seed + j0 + k;
      const bool valid = j0 + k < lim && p < s.L;
      fb[k] = valid ? s.flags[p] : 0;
      sb[k] = valid ? s.svals[p] : 0.0;
    }
#pragma unroll
    for (int k = 0; k < T1_BATCH; ++k) {
      const long j = j0 + k;
      if (j >= lim) break;
      const uint8_t fl = fb[k];
      // the class at offset j: the global gated state once a
      // gated-definite base lies inside the window, else the seed's outer
      // class
      seen = seen || (fl & F_GDEF);
      const int cls_w = seen ? ((fl & F_GCLS1) ? 1 : 0) : cls_m;
      const bool lwp = fl & F_LOWA;
      const bool inc = lwp && (fl & (cls_w == 0 ? F_SOK0 : F_SOK1));
      if (!inc && 2 * inc_before < j + 1) {
        f1 = j;
        break;
      }
      inc_before += inc;
      const double svp = sb[k];
      lt = lt + (j < s.minw ? svp : (lwp ? svp : 0.0));
      if (j < s.minw) {
        low_count0 += lwp;
        if (j == s.minw - 1) {
          low_total0 = lt;
          lc = low_count0;
        }
        continue;
      }
      lc += lwp;
      double tsg;
      if (grow_good(s, j, inc, lt, lc, &tsg)) {
        if (!any_good || tsg > c_sd_grow) c_sd_grow = tsg;
        any_good = true;
        lastg = j;
      }
    }
  }
  const bool walking = f1 < 0 && lim < n;
  if (f1 < 0) f1 = n;
  const double ws_min = s.win_std[s.minw];
  const double ts0 = (low_count0 > 0 && ws_min > 0.0)
      ? low_total0 / ((double)low_count0 * ws_min) : 0.0;
  const bool begin0 = f1 >= s.minw && low_count0 > 0 && ws_min > 0.0
      && ts0 >= 3.0
      && (double)(s.minw - low_count0) / (double)s.minw <= s.max_low;
  const double c_sd0 = begin0 ? ts0 : 0.0;
  if (walking) {
    SeedCarry c;
    c.lt = lt;
    c.c_sd0 = c_sd0;
    c.c_sd_grow = c_sd_grow;
    c.t = t;
    c.n = (int32_t)n;
    c.inc_before = (int32_t)inc_before;
    c.lc = (int32_t)lc;
    c.lastg = (int32_t)lastg;
    c.seen = seen;
    c.begin0 = begin0;
    carry[atomicAdd(n_long, 1)] = c;
    return;
  }
  const double c_sd = (any_good && c_sd_grow > c_sd0) ? c_sd_grow : c_sd0;
  put(out, NS, t, f1, begin0 || any_good,
      any_good ? seed + lastg : (begin0 ? seed + s.minw : 0), c_sd, n);
}

// Tier 2: one warp per seed still walking, 32 consecutive offsets a step.
// The lanes load their offsets' svals and flags coalesced; the included
// and gated counts and the first fail are ballot prefix counts (exact
// integers); the running total stays one sequential chain in the host's
// order, added by lane 0 from shared memory; the score divisions, the good
// tests and the running maxima (order-free, so exact) run on all lanes.
// Warps past the slot count exit.
__global__ void seed_eval_tier2(SeedIn s, const int64_t* seeds,
                                const int8_t* seed_cls, long NS,
                                const SeedCarry* carry, const int* n_long,
                                int64_t* out) {
  __shared__ __align__(16) double chain[BLOCK];
  const long w = ((long)blockIdx.x * BLOCK + threadIdx.x) >> 5;
  if (w >= *n_long) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const unsigned upto = below | (1u << lane);
  double* ch = chain + (threadIdx.x & ~31);
  const SeedCarry c = carry[w];
  const int64_t seed = seeds[c.t];
  const int cls_m = seed_cls[c.t];
  const long n = c.n;
  double lt = c.lt;
  long inc_before = c.inc_before;
  long lc = c.lc;
  long lastg = c.lastg;
  bool seen = c.seen;
  bool any_good = c.lastg >= 0;
  double c_sd_grow = c.c_sd_grow;
  long f1 = n;
  // this lane's offset of the next step, loaded one step ahead
  auto load = [&](long j, uint8_t* fl, double* sv) {
    const long p = seed + j;
    const bool valid = j < n && p < s.L;
    *fl = valid ? s.flags[p] : 0;
    *sv = valid ? s.svals[p] : 0.0;
  };
  uint8_t fl_next;
  double sv_next;
  load(s.tier1 + lane, &fl_next, &sv_next);
  for (long j0 = s.tier1; j0 < n; j0 += 32) {
    const long j = j0 + lane;
    const uint8_t fl = fl_next;
    const double svp = sv_next;
    if (j0 + 32 < n) load(j + 32, &fl_next, &sv_next);
    const unsigned gdef = __ballot_sync(FULL, fl & F_GDEF);
    const bool seen_j = seen || (gdef & upto);
    const int cls_w = seen_j ? ((fl & F_GCLS1) ? 1 : 0) : cls_m;
    const bool lwp = fl & F_LOWA;
    const bool inc = lwp && (fl & (cls_w == 0 ? F_SOK0 : F_SOK1));
    const unsigned incs = __ballot_sync(FULL, inc);
    const long before = inc_before + __popc(incs & below);
    const unsigned fails =
        __ballot_sync(FULL, j < n && !inc && 2 * before < j + 1);
    const int first_fail = fails ? __ffs(fails) - 1 : 32;
    // the running total: ((lt + c0) + c1) + ..., in offset order
    ch[lane] = lwp ? svp : 0.0;
    __syncwarp();
    if (lane == 0) {
      double2* ch2 = reinterpret_cast<double2*>(ch);
      double run = lt;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        double2 v = ch2[k];
        run = run + v.x;
        v.x = run;
        run = run + v.y;
        v.y = run;
        ch2[k] = v;
      }
    }
    __syncwarp();
    const double lt_j = ch[lane];
    lt = ch[31];
    __syncwarp();
    const unsigned lws = __ballot_sync(FULL, lwp);
    const long lc_j = lc + __popc(lws & upto);
    double tsg = 0.0;
    const bool good = j < n && lane < first_fail
        && grow_good(s, j, inc, lt_j, lc_j, &tsg);
    const unsigned goods = __ballot_sync(FULL, good);
    if (goods) {
      double m = good ? tsg : 0.0;   // every good score is >= 3
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmax(m, __shfl_xor_sync(FULL, m, o));
      if (!any_good || m > c_sd_grow) c_sd_grow = m;
      any_good = true;
      lastg = j0 + 31 - __clz(goods);
    }
    if (fails) {
      f1 = j0 + first_fail;
      break;
    }
    inc_before += __popc(incs);
    lc += __popc(lws);
    seen = seen || gdef;
  }
  if (lane != 0) return;
  const double c_sd = (any_good && c_sd_grow > c.c_sd0) ? c_sd_grow : c.c_sd0;
  put(out, NS, c.t, f1, c.begin0 || any_good,
      any_good ? seed + lastg : (c.begin0 ? seed + s.minw : 0), c_sd, n);
}

// Pass A: one warp per segment of the batch: the sequential prefix of
// gated z and of gate counts (row stride maxw), plus the segment totals.
constexpr int NP_WARPS = 4;            // segments per block of pass A
constexpr int NP_CHUNK = 64;           // positions of pass A's chain a step
constexpr int NA_THREADS = 64;         // window lengths per block of pass B
constexpr int NA_AHEAD = 16;           // segments pass B loads ahead
constexpr int NA_CHUNK = 256;          // segments pass B stages at a time
constexpr unsigned NULL_FULL = 0xffffffffu;

__global__ void null_prefix(const double* z, const uint8_t* gate,
                            const int64_t* seg_s, const int64_t* seg_n,
                            long nb, long maxw, double* pz, int32_t* pc,
                            double* seg_z, int64_t* seg_c) {
  __shared__ double buf[NP_WARPS][NP_CHUNK];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long k = (long)blockIdx.x * NP_WARPS + wib;
  if (k >= nb) return;                 // the whole warp
  const long s = seg_s[k];
  const long n = seg_n[k];
  double* prow = pz + k * maxw;
  int32_t* crow = pc + k * maxw;
  double* sb = buf[wib];
  const unsigned le = (2u << lane) - 1u;   // lanes at or below this one
  double acc = 0.0;                    // lane 0's running sum
  int32_t cnt = 0;
  // a chunk is NP_CHUNK = 64 positions, two a lane (lane, lane + 32).
  // Gate and z are loaded side by side (z is not behind its gate) and two
  // chunks ahead of the chain; the gate is applied when a chunk's turn
  // comes.
  struct Raw {
    uint8_t ga, gb;
    double za, zb;
  };
  auto load = [&](long j0) {
    const long ja = j0 + lane;
    const long jb = ja + 32;
    Raw r;
    r.ga = ja < n ? gate[s + ja] : 0;
    r.za = ja < n ? z[s + ja] : 0.0;
    r.gb = jb < n ? gate[s + jb] : 0;
    r.zb = jb < n ? z[s + jb] : 0.0;
    return r;
  };
  Raw r0 = load(0);
  Raw r1 = load(NP_CHUNK);
  for (long j0 = 0; j0 < n; j0 += NP_CHUNK) {
    const long ja = j0 + lane;
    const long jb = ja + 32;
    const Raw r2 = load(j0 + 2 * NP_CHUNK);
    const bool ga = r0.ga != 0;
    const bool gb = r0.gb != 0;
    const double va = ga ? r0.za : 0.0;
    const double vb = gb ? r0.zb : 0.0;
    const unsigned bal_a = __ballot_sync(NULL_FULL, ga);
    const unsigned bal_b = __ballot_sync(NULL_FULL, gb);
    sb[lane] = va;
    sb[lane + 32] = vb;
    __syncwarp();
    if (lane == 0) {
      const long m = n - j0 < NP_CHUNK ? n - j0 : NP_CHUNK;
      double x[NP_CHUNK];
#pragma unroll
      for (int i = 0; i < NP_CHUNK; ++i) x[i] = sb[i];
      int i0 = 0;
      if (j0 == 0) {                   // numpy's cumsum: out[0] = in[0]
        acc = x[0];
        sb[0] = acc;
        i0 = 1;
      }
#pragma unroll
      for (int i = 0; i < NP_CHUNK; ++i) {
        if (i >= i0 && i < m) {
          acc = acc + x[i];
          sb[i] = acc;
        }
      }
    }
    __syncwarp();
    if (ja < n) {
      prow[ja] = sb[lane];
      crow[ja] = cnt + __popc(bal_a & le);
    }
    if (jb < n) {
      prow[jb] = sb[lane + 32];
      crow[jb] = cnt + __popc(bal_a) + __popc(bal_b & le);
    }
    cnt += __popc(bal_a) + __popc(bal_b);
    __syncwarp();
    r0 = r1;
    r1 = r2;
  }
  if (lane == 0) {
    seg_z[k] = acc;
    seg_c[k] = cnt;
  }
}

// The carries of the batch's segments in the host's order (call/cnv.py
// _null_window_model; ops/cnv_device.py _carries): the running total since
// the last reset, continued from ``state`` and left there for the next
// batch. One warp: it loads and stores 32 segments at a time, lane 0 runs
// the sequential f64 chain from shared memory.
__global__ void null_carry(const double* seg_z, const int64_t* seg_c,
                           const int64_t* seg_reset, long nb, double* state_z,
                           int64_t* state_c, double* tot0, int64_t* cnt0) {
  __shared__ double z[32], t[32];
  __shared__ int64_t c[32], r[32], tc[32];
  const int lane = threadIdx.x;
  double rz = *state_z;
  int64_t rc = *state_c;
  for (long k0 = 0; k0 < nb; k0 += 32) {
    const long k = k0 + lane;
    const bool in = k < nb;
    z[lane] = in ? seg_z[k] : 0.0;
    c[lane] = in ? seg_c[k] : 0;
    r[lane] = in ? seg_reset[k] : 0;
    __syncwarp();
    if (lane == 0) {
      const int m = nb - k0 < 32 ? (int)(nb - k0) : 32;
      for (int i = 0; i < m; ++i) {
        if (r[i]) {
          rz = 0.0;
          rc = 0;
        }
        t[i] = rz;
        tc[i] = rc;
        rz = rz + z[i];
        rc += c[i];
      }
    }
    __syncwarp();
    if (in) {
      tot0[k] = t[lane];
      cnt0[k] = tc[lane];
    }
    __syncwarp();
  }
  if (lane == 0) {
    *state_z = rz;
    *state_c = rc;
  }
}

// Pass B: one owner per window length w >= minw, the batch's segments in
// order. The block stages NA_CHUNK segments' parameters in shared memory;
// each owner then loads NA_AHEAD segments' prefix values at once (every
// load unconditional, at a valid address) and computes their squares
// before it adds them, in order, to its running sum.
__global__ void null_accum(const double* pz, const int32_t* pc,
                           const int64_t* seg_n, const int64_t* seg_w,
                           const double* tot0, const int64_t* cnt0, long nb,
                           long minw, long maxw, double* sums,
                           int64_t* counts) {
  __shared__ int64_t s_n[NA_CHUNK], s_w[NA_CHUNK], s_c[NA_CHUNK];
  __shared__ double s_t[NA_CHUNK];
  const long w = minw + (long)blockIdx.x * NA_THREADS + threadIdx.x;
  const bool own = w <= maxw;
  double sum = own ? sums[w] : 0.0;
  int64_t count = own ? counts[w] : 0;
  for (long c0 = 0; c0 < nb; c0 += NA_CHUNK) {
    const int m = nb - c0 < NA_CHUNK ? (int)(nb - c0) : NA_CHUNK;
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += NA_THREADS) {
      s_n[i] = seg_n[c0 + i];
      s_w[i] = seg_w[c0 + i];
      s_c[i] = cnt0[c0 + i];
      s_t[i] = tot0[c0 + i];
    }
    __syncthreads();
    if (!own) continue;
    for (int u0 = 0; u0 < m; u0 += NA_AHEAD) {
      double sq[NA_AHEAD], zv[NA_AHEAD];
      int32_t cv[NA_AHEAD];
      bool in[NA_AHEAD], use[NA_AHEAD];
      // every load first, unconditional and at a valid address, so all
      // NA_AHEAD segments' loads are in flight together
#pragma unroll
      for (int u = 0; u < NA_AHEAD; ++u) {
        const int i = u0 + u < m ? u0 + u : 0;
        const long j = w - s_w[i] - 1;
        in[u] = u0 + u < m && j >= 0 && j < s_n[i];
        const long at = (c0 + i) * maxw + (in[u] ? j : 0);
        cv[u] = pc[at];
        zv[u] = pz[at];
      }
#pragma unroll
      for (int u = 0; u < NA_AHEAD; ++u) {
        const int i = u0 + u < m ? u0 + u : 0;
        const int64_t c = s_c[i] + cv[u];
        use[u] = in[u] && c > 0;
        // an unused slot divides 0 by 1: no special case in the division
        const double v = (use[u] ? s_t[i] + zv[u] : 0.0)
            / (use[u] ? (double)c : 1.0);
        sq[u] = v * v;
      }
#pragma unroll
      for (int u = 0; u < NA_AHEAD; ++u) {
        if (use[u]) {
          sum = sum + sq[u];
          count += 1;
        }
      }
    }
  }
  if (own) {
    sums[w] = sum;
    counts[w] = count;
  }
}

inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// scratch of one batch of B segments: pz, pc, the totals, the carries and
// the running state
struct NullScratch {
  double* pz;
  int32_t* pc;
  double* seg_z;
  int64_t* seg_c;
  double* tot0;
  int64_t* cnt0;
  double* state_z;
  int64_t* state_c;
};

NullScratch null_carve(void* scratch, long B, long maxw) {
  char* p = (char*)scratch;
  NullScratch n;
  n.pz = (double*)p;
  p += align256(sizeof(double) * B * maxw);
  n.pc = (int32_t*)p;
  p += align256(sizeof(int32_t) * B * maxw);
  n.seg_z = (double*)p;
  p += align256(sizeof(double) * B);
  n.seg_c = (int64_t*)p;
  p += align256(sizeof(int64_t) * B);
  n.tot0 = (double*)p;
  p += align256(sizeof(double) * B);
  n.cnt0 = (int64_t*)p;
  p += align256(sizeof(int64_t) * B);
  n.state_z = (double*)p;
  n.state_c = (int64_t*)(p + sizeof(double));
  return n;
}

long null_scratch_bytes(long B, long maxw) {
  return (long)(align256(sizeof(double) * B * maxw)
                + align256(sizeof(int32_t) * B * maxw)
                + 4 * align256(8 * B) + 256);
}

}  // namespace

extern "C" {

const char* gt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Bytes of the scratch ``gt_zscores`` needs for n bases and R bin rows:
// the tile counter, a state word per tile and the (row, depth) z table.
long gt_zscores_scratch_bytes(long n, int R) {
  return 16 + 8 * ((n + ZTILE - 1) / ZTILE) + 8 * (long)R * ZTW;
}

// z of the n bases into ``out`` (f64 [n], any alignment); the per-base
// inputs 16-byte aligned; ``scratch`` holds gt_zscores_scratch_bytes(n, R)
// bytes. Two launches (the (row, depth) table, then one pass of persistent
// blocks over the bases) and one memset of the tile states.
int gt_zscores(void* depth, void* mq, void* gc, void* low_acgt, void* rows,
               void* cnt, void* tail, void* ave, void* std, void* pv_p,
               void* pv_sd, long n, int R, int P, int nb,
               int min_mapq, double mf, double omf, double dup_thr_factor,
               int ranks, void* scratch, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  ZIn z;
  z.depth = (const int32_t*)depth;
  z.mq = (const int16_t*)mq;
  z.gc = (const int8_t*)gc;
  z.low_acgt = (const int8_t*)low_acgt;
  z.rows = (const int32_t*)rows;
  z.cnt = (const int32_t*)cnt;
  z.tail = (const int32_t*)tail;
  z.ave = (const double*)ave;
  z.std = (const double*)std;
  z.pv_p = (const double*)pv_p;
  z.pv_sd = (const double*)pv_sd;
  z.n = n;
  z.R = R;
  z.P = P;
  z.nb = nb;
  z.min_mapq = min_mapq;
  z.mf = mf;
  z.omf = omf;
  z.dup_thr_factor = dup_thr_factor;
  z.ranks = ranks;
  cudaStream_t s = (cudaStream_t)stream;
  const long ntiles = (n + ZTILE - 1) / ZTILE;
  int* next_tile = (int*)scratch;
  unsigned long long* status = (unsigned long long*)((char*)scratch + 16);
  double* base = (double*)((char*)scratch + 16 + 8 * ntiles);
  const size_t smem = sizeof(double) * (ZOUT + ZW)
                      + sizeof(int) * ZROW * (size_t)R;
  cudaError_t e = cudaFuncSetAttribute(
      zs_onepass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, zs_onepass,
                                                      ZT, smem);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(scratch, 0, 16 + 8 * ntiles, s);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (R > 0) zs_table<<<dim3(R, ZTW / 256), 256, 0, s>>>(z, base);
  const long grid = (long)sms * per_sm < ntiles ? (long)sms * per_sm
                                                 : ntiles;
  zs_onepass<<<(int)grid, ZT, smem, s>>>(z, base, status, next_tile, ntiles,
                                         (double*)out);
  return (int)cudaGetLastError();
}

// Bytes of the scratch ``gt_seed_eval`` needs for NS seeds.
long gt_seed_scratch_bytes(long NS) {
  return 16 + NS * (long)sizeof(SeedCarry);
}

// Outcomes of NS seeds into the packed int64 [5, NS] ``out``; ``scratch``
// holds gt_seed_scratch_bytes(NS) bytes.
int gt_seed_eval(void* svals, void* flags, void* win_std, long L, long minw,
                 long maxw, double max_low, long be, void* seeds,
                 void* seed_cls, long NS, void* scratch, void* out,
                 void* stream) {
  if (NS <= 0) return (int)cudaGetLastError();
  SeedIn in;
  in.svals = (const double*)svals;
  in.flags = (const uint8_t*)flags;
  in.win_std = (const double*)win_std;
  in.L = L;
  in.minw = minw;
  in.maxw = maxw;
  in.max_low = max_low;
  in.be = be;
  in.tier1 = (minw + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
  int* n_long = (int*)scratch;
  SeedCarry* carry = (SeedCarry*)((char*)scratch + 16);
  const cudaError_t set = cudaMemsetAsync(n_long, 0, sizeof(int), st);
  if (set != cudaSuccess) return (int)set;
  seed_eval_tier1<<<blocks_for(NS), BLOCK, 0, st>>>(
      in, (const int64_t*)seeds, (const int8_t*)seed_cls, NS, (int64_t*)out,
      carry, n_long);
  // one warp per seed: room for every seed, warps past the count exit
  seed_eval_tier2<<<blocks_for(NS * 32), BLOCK, 0, st>>>(
      in, (const int64_t*)seeds, (const int8_t*)seed_cls, NS, carry, n_long,
      (int64_t*)out);
  return (int)cudaGetLastError();
}

// Bytes of the scratch ``gt_null_model`` needs for batches of B segments:
// about 12 * B * maxw, whatever the number of segments.
long gt_null_scratch_bytes(long B, long maxw) {
  return null_scratch_bytes(B, maxw);
}

// The null model over S segments (``segs`` int64 [4, S]: start, length,
// window length carried in, reset), in batches of B back to back on
// ``stream``; ``out`` int64 [2, maxw + 1] gets the sums (f64 bits) and the
// counts per window length. With ``pass_ms`` (float [3], else null) the
// call also sums each pass's card time over the batches (CUDA events) and
// waits for them.
int gt_null_model(void* z, void* gate, void* segs, long S, long minw,
                  long maxw, long B, void* scratch, void* out,
                  float* pass_ms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* seg = (const int64_t*)segs;
  const NullScratch n = null_carve(scratch, B, maxw);
  double* sums = (double*)out;
  int64_t* counts = (int64_t*)out + (maxw + 1);
  cudaError_t e = cudaMemsetAsync(out, 0, 2 * sizeof(int64_t) * (maxw + 1),
                                  st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(n.state_z, 0, sizeof(double) + sizeof(int64_t), st);
  if (e != cudaSuccess) return (int)e;
  const long nbatch = S > 0 ? (S + B - 1) / B : 0;
  const bool timed = pass_ms != nullptr;
  cudaEvent_t* ev = nullptr;
  if (timed) {
    ev = new cudaEvent_t[3 * nbatch + 1];
    for (long i = 0; i < 3 * nbatch + 1; ++i) cudaEventCreate(&ev[i]);
    cudaEventRecord(ev[0], st);
  }
  const long na_blocks = maxw >= minw
      ? (maxw - minw + NA_THREADS) / NA_THREADS : 0;
  for (long b = 0; b < nbatch; ++b) {
    const long b0 = b * B;
    const long nb = S - b0 < B ? S - b0 : B;
    null_prefix<<<(int)((nb + NP_WARPS - 1) / NP_WARPS), 32 * NP_WARPS, 0,
                  st>>>((const double*)z, (const uint8_t*)gate, seg + b0,
                        seg + S + b0, nb, maxw, n.pz, n.pc, n.seg_z,
                        n.seg_c);
    if (timed) cudaEventRecord(ev[3 * b + 1], st);
    null_carry<<<1, 32, 0, st>>>(n.seg_z, n.seg_c, seg + 3 * S + b0, nb,
                                n.state_z, n.state_c, n.tot0, n.cnt0);
    if (timed) cudaEventRecord(ev[3 * b + 2], st);
    if (na_blocks > 0)
      null_accum<<<(int)na_blocks, NA_THREADS, 0, st>>>(
          n.pz, n.pc, seg + S + b0, seg + 2 * S + b0, n.tot0, n.cnt0, nb,
          minw, maxw, sums, counts);
    if (timed) cudaEventRecord(ev[3 * b + 3], st);
  }
  e = cudaGetLastError();
  if (timed) {
    pass_ms[0] = pass_ms[1] = pass_ms[2] = 0.0f;
    if (nbatch > 0) cudaEventSynchronize(ev[3 * nbatch]);
    for (long b = 0; b < nbatch; ++b) {
      for (int k = 0; k < 3; ++k) {
        float t = 0.0f;
        cudaEventElapsedTime(&t, ev[3 * b + k], ev[3 * b + k + 1]);
        pass_ms[k] += t;
      }
    }
    for (long i = 0; i < 3 * nbatch + 1; ++i) cudaEventDestroy(ev[i]);
    delete[] ev;
  }
  return (int)e;
}

}  // extern "C"
