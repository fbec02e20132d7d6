// SV evidence-entry scorer: action kind, min-disc and insert-geometry
// gates, the binomial-table gather (scaled-trials branch when rd > mt), the
// f32 weak/strong evidence-ratio gate and the hez gather, per entry.
//
// Replaces grom_tpu/ops/sv_device.py:31 DeviceSvScorer, which jits
// grom_tpu/call/sv_screen.py:121 score_sv_entries and :93 binom_pair_vec.
//
// What bounds it on an H100: one thread per entry, the nine int64 entry
// columns read once (one packed buffer, uploaded once a window), three
// gathers into two 1001 x 1001 f64 tables (8 MB each, L2-resident after the
// first window) and one packed output (binom, hez, kind, accept) copied
// back once. A detect window holds at most tens of thousands of entries,
// so a launch is bounded by its fixed cost and the call by the host's
// packing and its one copy each way, not by the card. The divisions are
// numpy's flooring ``//``: where both operands fit in 32 bits (every
// count of a real window) they run as 32-bit divisions, which the card
// emulates in far fewer instructions than 64-bit ones; the scaled-trials
// quotients are computed only for entries with rd > mt.
//
// Exactness: every output equals numpy's score_sv_entries bit for bit.
//   * numpy's ``//`` floors (and gives 0 for a zero divisor); C's ``/``
//     truncates, so every division goes through floordiv().
//   * The ratio gate is (float)weak / (float)strong <= 0.25f with IEEE f32
//     division (__fdiv_rn) and round-to-nearest int64 -> f32 conversions:
//     0/0 is NaN and x/0 is inf, and both compare false.
//   * Table indices wrap once when negative, as numpy's do.
//   * The ctx_r variant gates on (weak_f, ctx_f_here) only in the rd <= mt
//     branch (src/GROM.c:12068, as sv_screen.py:107-108 reproduces it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int N_COLS = 9;   // pos, etype, count, rs, re, rd, weak_f,
                            // weak_r, ctx_f_here (ops/sv_device.py)

struct SvIn {
  const int64_t* e;         // [N_COLS, n], row-major
  const double* mq_tab;     // [rows, cols], row-major
  const double* hez_tab;    // [rows, cols]
  const int32_t* kind_tab;  // [n_etype]: etype -> action kind
  const int32_t* rev_tab;   // [n_etype]: etype -> reverse-side flag
  long n;
  long rows;
  long cols;
  int n_etype;
  int e_ctx_r;
  int64_t af, mt, md, mean, lseq;
  double thr1;
};

__device__ __forceinline__ bool fits32(int64_t a) {
  return a == (int64_t)(int32_t)a;
}

// numpy's a // b: floors, and 0 for b == 0
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  if (b == 0) return 0;
  if (fits32(a) && fits32(b) && !(a == INT32_MIN && b == -1)) {
    const int32_t x = (int32_t)a, y = (int32_t)b;
    int32_t q = x / y;
    if ((x % y != 0) && ((x < 0) != (y < 0))) --q;
    return q;
  }
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int64_t wrap(int64_t i, long dim) {
  return i < 0 ? i + dim : i;
}

__device__ __forceinline__ double gather(const double* tab, const SvIn& s,
                                         int64_t r, int64_t c) {
  return tab[wrap(r, s.rows) * s.cols + wrap(c, s.cols)];
}

__device__ __forceinline__ bool ratio_gate(int64_t weak, int64_t strong) {
  return __fdiv_rn((float)weak, (float)strong) <= 0.25f;
}

__global__ void sv_score_kernel(SvIn s, double* binom_out, double* hez_out,
                                int32_t* kind, uint8_t* accept) {
  const long i = (long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= s.n) return;
  const int64_t* e = s.e + i;
  const long n = s.n;
  const int64_t p = e[0];
  const int64_t et = e[n];
  const int64_t strong = e[2 * n];
  const int64_t rd = e[5 * n];
  const int64_t wf = e[6 * n];
  const int ei = (int)(et < 0 ? et + s.n_etype : et);
  const bool rev = s.rev_tab[ei] != 0;
  const int64_t weak = rev ? e[7 * n] : wf;

  const int64_t k_small = floordiv(strong, s.af);
  const bool md_ok = k_small >= s.md;
  const bool geom_ok = rev ? (e[3 * n] + s.lseq - p < s.mean)
                           : (p - e[4 * n] < s.mean);

  // binom_pair_vec; the scaled-trials quotients only where rd > mt
  const bool big = rd > s.mt;
  const int64_t row = big ? s.mt : rd;
  const int64_t k2 = floordiv(strong + weak, s.af);
  int64_t col, hez_col;
  if (big) {
    const int64_t den = s.af * (rd > 1 ? rd : 1);
    const int64_t k_big = floordiv(strong * s.mt, den);
    const int64_t k2i = floordiv((strong + weak) * s.mt, den);
    col = k_big < s.mt ? k_big : s.mt;
    hez_col = k2 < rd ? (k2i < s.mt ? k2i : s.mt) : s.mt;
  } else {
    col = k_small < s.mt ? k_small : s.mt;
    hez_col = k2 < rd ? k2 : rd;
  }
  const double binom = gather(s.mq_tab, s, row, col);
  const double hez_val = gather(s.hez_tab, s, row, hez_col);

  bool gate;
  if (et == s.e_ctx_r && !big)
    gate = ratio_gate(wf, e[8 * n]);
  else
    gate = ratio_gate(weak, strong);

  kind[i] = s.kind_tab[ei];
  accept[i] = (md_ok && geom_ok && rd > 0 && binom <= s.thr1) ? 1 : 0;
  binom_out[i] = binom;
  hez_out[i] = gate ? hez_val : 2.0;
}

}  // namespace

extern "C" {

const char* gt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ``entries`` int64 [9, n] (ops/sv_device.py ENTRY_KEYS, row-major);
// tables f64 [rows, cols]; kind/rev tables int32 [n_etype]. ``out`` gets
// the packed result: binom f64 [n], hez f64 [n], kind int32 [n], accept
// u8 (0/1) [n], back to back. Every etype must lie in [-n_etype, n_etype).
int gt_sv_score(void* entries, long n, void* mq_tab, void* hez_tab,
                long rows, long cols, void* kind_tab, void* rev_tab,
                int n_etype, int e_ctx_r, long af, long mt, long md,
                double thr1, long mean, long lseq, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  SvIn s;
  s.e = (const int64_t*)entries;
  s.mq_tab = (const double*)mq_tab;
  s.hez_tab = (const double*)hez_tab;
  s.kind_tab = (const int32_t*)kind_tab;
  s.rev_tab = (const int32_t*)rev_tab;
  s.n = n;
  s.rows = rows;
  s.cols = cols;
  s.n_etype = n_etype;
  s.e_ctx_r = e_ctx_r;
  s.af = af;
  s.mt = mt;
  s.md = md;
  s.mean = mean;
  s.lseq = lseq;
  s.thr1 = thr1;
  double* binom = (double*)out;
  double* hez = binom + n;
  int32_t* kind = (int32_t*)(hez + n);
  uint8_t* accept = (uint8_t*)(kind + n);
  const int blocks = (int)((n + BLOCK - 1) / BLOCK);
  sv_score_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      s, binom, hez, kind, accept);
  return (int)cudaGetLastError();
}

}  // extern "C"
