// CNV kernels for the streamed calling path: per-base z-scores, per-seed
// window evaluation and the null window-length model, all in f64.
//
// Replaces, in grom_tpu/ops/cnv_device.py:
//   zscores_device (inner ``kern``)    -> gt_zscores
//   seed_eval_device (vmapped ``one``) -> gt_seed_eval
//   null_model_device (``eval_batch``) -> gt_null_prefix + gt_null_accum
//
// What bounds them on an H100:
//   * z-scores: one thread per base, two binary searches into the base's
//     sorted (class, GC) depth row plus one into pval2sd. Bounded by the
//     dependent loads of the searches (the rows stay in L2), not by f64
//     arithmetic. The sticky-class forward fill crosses blocks, so it is a
//     separate block-maximum pass, a one-block scan over blocks and a
//     per-base resolve with an in-block scan.
//   * seed evaluation: one thread per (seed, class), a sequential f64 loop
//     over the seed's window up to its first fail. Bounded by the longest
//     surviving seed (up to maxw = 10000 steps); most seeds fail early.
//   * null model: pass A writes each segment's sequential prefix of gated z
//     and of gate counts to scratch (one thread per segment, segments in
//     bounded batches); pass B gives every window length one owner thread
//     that walks the segments in order. Bounded by pass A's sequential
//     walk of maxw positions.
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

struct SeedIn {
  const double* svals;
  const uint8_t* lowa;
  const uint8_t* sok0;
  const uint8_t* sok1;
  const int64_t* gcls_idx;
  const int8_t* gcls_val;
  const double* win_std;   // [maxw + 1]
  long L;
  long minw;
  long maxw;
  double max_low;
  long be;
};

__global__ void seed_eval(SeedIn s, const int64_t* seeds,
                          const int8_t* seed_cls, long NS, int64_t* f1_out,
                          uint8_t* begin_out, int64_t* c_end_out,
                          double* c_sd_out, int64_t* n_out) {
  const long t = (long)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= NS) return;
  const int64_t seed = seeds[t];
  const int cls_m = seed_cls[t];
  long n = s.be - seed;
  if (n < s.minw) n = s.minw;
  if (n > s.maxw) n = s.maxw;
  const double ws_min = s.win_std[s.minw];

  long f1 = n;
  long inc_before = 0;        // inc count before offset j
  long low_count0 = 0;        // gated bases among the first minw
  long lc = 0;                // gated bases up to j
  double lt = 0.0;            // sequential total, as the host accumulates
  double low_total0 = 0.0;
  bool any_good = false;
  long lastg = -1;
  double c_sd_grow = 0.0;
  for (long j = 0; j < n; ++j) {
    const long p = seed + j;
    const bool valid = p < s.L;
    // class at offset j: the global gated state if its last update is
    // inside the window, else the seed's outer class
    int cls_w = cls_m;
    if (valid && s.gcls_idx[p] >= seed) cls_w = s.gcls_val[p];
    const bool lwp = valid && s.lowa[p];
    const bool sokw = valid && (cls_w == 0 ? s.sok0[p] : s.sok1[p]);
    const bool inc = lwp && sokw;
    const long wl = j + 1;
    if (!inc && 2 * inc_before < wl) { f1 = j; break; }
    inc_before += inc;
    const double svp = valid ? s.svals[p] : 0.0;
    const double contrib = j < s.minw ? svp : (lwp ? svp : 0.0);
    lt = lt + contrib;
    if (j < s.minw) {
      low_count0 += lwp;
      if (j == s.minw - 1) {
        low_total0 = lt;
        lc = low_count0;
      }
      continue;
    }
    lc += lwp;
    const double wsg = s.win_std[wl < s.maxw ? wl : s.maxw];
    const double tsg = (lc > 0 && wsg > 0.0) ? lt / ((double)lc * wsg) : 0.0;
    const bool good = inc && wsg > 0.0 && tsg >= 3.0
        && (double)(wl - lc) / (double)wl <= s.max_low;
    if (good) {
      if (!any_good || tsg > c_sd_grow) c_sd_grow = tsg;
      any_good = true;
      lastg = j;
    }
  }
  const bool ok_first = f1 >= s.minw;
  const double ts0 = (low_count0 > 0 && ws_min > 0.0)
      ? low_total0 / ((double)low_count0 * ws_min) : 0.0;
  const bool begin0 = ok_first && low_count0 > 0 && ws_min > 0.0
      && ts0 >= 3.0
      && (double)(s.minw - low_count0) / (double)s.minw <= s.max_low;
  double c_sd = begin0 ? ts0 : 0.0;
  if (any_good && c_sd_grow > c_sd) c_sd = c_sd_grow;
  f1_out[t] = f1;
  begin_out[t] = (begin0 || any_good) ? 1 : 0;
  c_end_out[t] = any_good ? seed + lastg : (begin0 ? seed + s.minw : 0);
  c_sd_out[t] = c_sd;
  n_out[t] = n;
}

// Pass A: per segment, the sequential prefix of gated z and gate counts
// (row stride maxw), plus the segment totals.
__global__ void null_prefix(const double* z, const uint8_t* gate,
                            const int64_t* seg_s, const int64_t* seg_n,
                            long S, long maxw, double* pz, int32_t* pc,
                            double* seg_z, int64_t* seg_c) {
  const long i = (long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= S) return;
  const long s = seg_s[i];
  const long n = seg_n[i];
  double acc = 0.0;
  int32_t cnt = 0;
  for (long j = 0; j < n; ++j) {
    const bool g = gate[s + j] != 0;
    const double v = g ? z[s + j] : 0.0;
    acc = j == 0 ? v : acc + v;      // numpy cumsum: out[0] = in[0]
    cnt += g;
    pz[i * maxw + j] = acc;
    pc[i * maxw + j] = cnt;
  }
  seg_z[i] = acc;
  seg_c[i] = cnt;
}

// Pass B: one thread per window length w, segments in order.
__global__ void null_accum(const double* pz, const int32_t* pc,
                           const int64_t* seg_n, const int64_t* seg_w,
                           const double* tot0, const int64_t* cnt0, long S,
                           long minw, long maxw, double* sums,
                           int64_t* counts) {
  const long w = (long)blockIdx.x * BLOCK + threadIdx.x + 1;
  if (w > maxw || w < minw) return;
  double sum = sums[w];
  int64_t count = counts[w];
  for (long i = 0; i < S; ++i) {
    const long j = w - seg_w[i] - 1;
    if (j < 0 || j >= seg_n[i]) continue;
    const int64_t c = cnt0[i] + pc[i * maxw + j];
    if (c <= 0) continue;
    const double v = (tot0[i] + pz[i * maxw + j]) / (double)c;
    sum = sum + v * v;
    count += 1;
  }
  sums[w] = sum;
  counts[w] = count;
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

int gt_seed_eval(void* svals, void* lowa, void* sok0, void* sok1,
                 void* gcls_idx, void* gcls_val, void* win_std, long L,
                 long minw, long maxw, double max_low, long be, void* seeds,
                 void* seed_cls, long NS, void* f1, void* begin, void* c_end,
                 void* c_sd, void* n, void* stream) {
  if (NS <= 0) return (int)cudaGetLastError();
  SeedIn in;
  in.svals = (const double*)svals;
  in.lowa = (const uint8_t*)lowa;
  in.sok0 = (const uint8_t*)sok0;
  in.sok1 = (const uint8_t*)sok1;
  in.gcls_idx = (const int64_t*)gcls_idx;
  in.gcls_val = (const int8_t*)gcls_val;
  in.win_std = (const double*)win_std;
  in.L = L;
  in.minw = minw;
  in.maxw = maxw;
  in.max_low = max_low;
  in.be = be;
  seed_eval<<<blocks_for(NS), BLOCK, 0, (cudaStream_t)stream>>>(
      in, (const int64_t*)seeds, (const int8_t*)seed_cls, NS,
      (int64_t*)f1, (uint8_t*)begin, (int64_t*)c_end, (double*)c_sd,
      (int64_t*)n);
  return (int)cudaGetLastError();
}

// Pass A for one batch of S segments; ``pz``/``pc`` are [S, maxw].
int gt_null_prefix(void* z, void* gate, void* seg_s, void* seg_n, long S,
                   long maxw, void* pz, void* pc, void* seg_z, void* seg_c,
                   void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  null_prefix<<<blocks_for(S), BLOCK, 0, (cudaStream_t)stream>>>(
      (const double*)z, (const uint8_t*)gate, (const int64_t*)seg_s,
      (const int64_t*)seg_n, S, maxw, (double*)pz, (int32_t*)pc,
      (double*)seg_z, (int64_t*)seg_c);
  return (int)cudaGetLastError();
}

// Pass B for the same batch; ``sums``/``counts`` ([maxw + 1]) carry over
// from batch to batch in segment order.
int gt_null_accum(void* pz, void* pc, void* seg_n, void* seg_w, void* tot0,
                  void* cnt0, long S, long minw, long maxw, void* sums,
                  void* counts, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  null_accum<<<blocks_for(maxw), BLOCK, 0, (cudaStream_t)stream>>>(
      (const double*)pz, (const int32_t*)pc, (const int64_t*)seg_n,
      (const int64_t*)seg_w, (const double*)tot0, (const int64_t*)cnt0, S,
      minw, maxw, (double*)sums, (int64_t*)counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
