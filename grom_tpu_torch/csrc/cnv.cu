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
//   * z-scores: one thread per base, two binary searches into the base's
//     sorted (class, GC) depth row plus one into pval2sd. Bounded by the
//     dependent loads of the searches (the rows stay in L2), not by f64
//     arithmetic. The sticky-class forward fill crosses blocks, so it is a
//     separate block-maximum pass, a one-block scan over blocks and a
//     per-base resolve with an in-block scan.
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
constexpr int SCAN_THREADS = 1024;

inline int blocks_for(long n) { return (int)((n + BLOCK - 1) / BLOCK); }

struct ZIn {
  const int32_t* depth;
  const int16_t* mq;
  const int8_t* gc;
  const int8_t* low_acgt;
  const double* w;
  const int64_t* mat;     // [2 nb, maxn], rows sorted ascending
  const int64_t* lens;    // [2 nb]
  const double* ave;      // [2 nb]
  const double* std;      // [2 nb]
  const double* pv_p;     // [P], non-decreasing
  const double* pv_sd;    // [P]
  long n;
  long maxn;
  int P;
  int nb;
  int min_mapq;
  double dup_thr_factor;
  int ranks;
};

// definite class of base i: 0 high mapq, 1 low mapq with depth, -1 none
__device__ __forceinline__ int def_class(const ZIn& z, long i) {
  if (z.mq[i] >= z.min_mapq) return 0;
  return z.depth[i] > 0 ? 1 : -1;
}

// base i updates the sticky class (eligible and definite)
__device__ __forceinline__ bool updates(const ZIn& z, long i) {
  const bool hi_mq = z.mq[i] >= z.min_mapq;
  const long k = (hi_mq ? 0 : z.nb) + z.gc[i];
  const bool eligible = z.low_acgt[i] == 0 && z.lens[k] > 1;
  return eligible && def_class(z, i) >= 0;
}

__global__ void zs_block_last(ZIn z, int64_t* block_last) {
  __shared__ int64_t red[BLOCK];
  const long i = (long)blockIdx.x * BLOCK + threadIdx.x;
  red[threadIdx.x] = (i < z.n && updates(z, i)) ? i : -1;
  __syncthreads();
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s && red[threadIdx.x + s] > red[threadIdx.x])
      red[threadIdx.x] = red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) block_last[blockIdx.x] = red[0];
}

// Exclusive running maximum over ``n`` values (initial -1), one block.
__global__ void exclusive_cummax(const int64_t* in, int64_t* out, long n) {
  __shared__ int64_t part[SCAN_THREADS];
  const long per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const long b0 = threadIdx.x * per;
  const long b1 = b0 + per < n ? b0 + per : n;
  int64_t m = -1;
  for (long i = b0; i < b1; ++i) m = in[i] > m ? in[i] : m;
  part[threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t run = -1;
    for (int t = 0; t < SCAN_THREADS; ++t) {
      const int64_t v = part[t];
      part[t] = run;
      run = v > run ? v : run;
    }
  }
  __syncthreads();
  int64_t run = part[threadIdx.x];
  for (long i = b0; i < b1; ++i) {
    out[i] = run;
    run = in[i] > run ? in[i] : run;
  }
}

// number of row[0:len) elements <= key (right) or < key (left)
__device__ __forceinline__ long row_search(const int64_t* row, long len,
                                           int64_t key, bool right) {
  long lo = 0, hi = len;
  while (lo < hi) {
    const long mid = (lo + hi) >> 1;
    const bool go = right ? row[mid] <= key : row[mid] < key;
    if (go) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int pv_search(const double* pv, int P, double x) {
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pv[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void zs_eval(ZIn z, const int64_t* carry, double* out) {
  __shared__ int64_t scan[BLOCK];
  const long i = (long)blockIdx.x * BLOCK + threadIdx.x;
  const bool in = i < z.n;
  scan[threadIdx.x] = (in && updates(z, i)) ? i : -1;
  __syncthreads();
  // inclusive in-block running maximum (Hillis-Steele)
  for (int s = 1; s < BLOCK; s <<= 1) {
    const int64_t v = threadIdx.x >= s ? scan[threadIdx.x - s] : -1;
    __syncthreads();
    if (v > scan[threadIdx.x]) scan[threadIdx.x] = v;
    __syncthreads();
  }
  if (!in) return;
  int64_t fi = scan[threadIdx.x];
  if (carry[blockIdx.x] > fi) fi = carry[blockIdx.x];

  const int defz = def_class(z, i);
  const bool hi_mq = z.mq[i] >= z.min_mapq;
  const long k_elig = (hi_mq ? 0 : z.nb) + z.gc[i];
  const bool eligible = z.low_acgt[i] == 0 && z.lens[k_elig] > 1;
  const int last_cls = fi >= 0 ? def_class(z, fi) : 0;
  const int cls = defz >= 0 ? defz : last_cls;
  const long k = (long)cls * z.nb + z.gc[i];
  const long nk = z.lens[k];
  if (!(eligible && nk > 0)) {
    out[i] = 0.0;
    return;
  }
  const int64_t d = z.depth[i];
  const double dd = (double)d;
  const double av = z.ave[k];
  const int64_t* row = z.mat + k * z.maxn;
  const bool below = dd < av;
  const double clamp = z.dup_thr_factor * av;
  double base;
  if (z.ranks) {
    const int64_t key_l = dd > clamp ? (int64_t)clamp : d;
    long bi, bi2;
    // the reference bisection's quirk: n == 2 with result 0 returns 1
    auto fx = [nk](long s) { return (nk == 2 && s == 0) ? 1L : s; };
    if (below) {
      bi = fx(row_search(row, nk, d, true));
      bi2 = fx(row_search(row, nk, d, false));
    } else {
      bi = nk - fx(row_search(row, nk, key_l, false));
      bi2 = nk - fx(row_search(row, nk, d, true));
    }
    const double di = bi <= 0 ? 0.5 : (double)bi;
    const double di2 = bi2 <= 0 ? 0.5 : (double)bi2;
    const double prob = (di + di2) / (2.0 * (double)nk);
    int pi = pv_search(z.pv_p, z.P, prob);
    if (pi > z.P - 1) pi = z.P - 1;
    base = below ? z.pv_sd[pi] : -z.pv_sd[pi];
  } else {
    const double sb = z.std[k];
    if (below || !(dd > clamp)) {
      base = sb != 0.0 ? (av - dd) / sb : 0.0;
    } else {
      base = sb != 0.0 ? (z.dup_thr_factor - 1.0) * (-av) / sb : 0.0;
    }
  }
  out[i] = z.w[i] * base;
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

// ``block_last`` and ``carry`` are int64 scratch of ceil(n / 256) entries.
int gt_zscores(void* depth, void* mq, void* gc, void* low_acgt, void* w,
               void* mat, void* lens, void* ave, void* std, void* pv_p,
               void* pv_sd, long n, long maxn, int P, int nb, int min_mapq,
               double dup_thr_factor, int ranks, void* block_last,
               void* carry, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  ZIn z;
  z.depth = (const int32_t*)depth;
  z.mq = (const int16_t*)mq;
  z.gc = (const int8_t*)gc;
  z.low_acgt = (const int8_t*)low_acgt;
  z.w = (const double*)w;
  z.mat = (const int64_t*)mat;
  z.lens = (const int64_t*)lens;
  z.ave = (const double*)ave;
  z.std = (const double*)std;
  z.pv_p = (const double*)pv_p;
  z.pv_sd = (const double*)pv_sd;
  z.n = n;
  z.maxn = maxn;
  z.P = P;
  z.nb = nb;
  z.min_mapq = min_mapq;
  z.dup_thr_factor = dup_thr_factor;
  z.ranks = ranks;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = blocks_for(n);
  zs_block_last<<<nblk, BLOCK, 0, s>>>(z, (int64_t*)block_last);
  exclusive_cummax<<<1, SCAN_THREADS, 0, s>>>(
      (const int64_t*)block_last, (int64_t*)carry, nblk);
  zs_eval<<<nblk, BLOCK, 0, s>>>(z, (const int64_t*)carry, (double*)out);
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
