// SV evidence-entry scorer: action kind, min-disc and insert-geometry
// gates, the binomial-table gather (scaled-trials branch when rd > mt), the
// f32 weak/strong evidence-ratio gate and the hez gather, per entry.
//
// Replaces grom_tpu/ops/sv_device.py:31 DeviceSvScorer, which jits
// grom_tpu/call/sv_screen.py:121 score_sv_entries and :93 binom_pair_vec.
//
// What bounds it on an H100: one thread per entry, a handful of int64
// divisions and three gathers into two 1001 x 1001 f64 tables (8 MB each,
// L2-resident after the first window). A detect window holds thousands of
// entries, so a launch is bounded by its fixed cost, not by the card.
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

struct SvIn {
  const int64_t* pos;
  const int32_t* etype;
  const int64_t* count;
  const int64_t* rs;
  const int64_t* re;
  const int64_t* rd;
  const int64_t* weak_f;
  const int64_t* weak_r;
  const int64_t* ctx_f;
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

__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  if (b == 0) return 0;
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

__global__ void sv_score_kernel(SvIn s, int32_t* kind, uint8_t* accept,
                                double* binom_out, double* hez_out) {
  const long i = (long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= s.n) return;
  const int et = s.etype[i];
  const int ei = et < 0 ? et + s.n_etype : et;
  const bool rev = s.rev_tab[ei] != 0;
  const int64_t p = s.pos[i];
  const int64_t strong = s.count[i];
  const int64_t rd = s.rd[i];
  const int64_t wf = s.weak_f[i];
  const int64_t weak = rev ? s.weak_r[i] : wf;

  const bool md_ok = floordiv(strong, s.af) >= s.md;
  const bool geom_ok = rev ? (s.rs[i] + s.lseq - p < s.mean)
                           : (p - s.re[i] < s.mean);

  // binom_pair_vec
  const bool big = rd > s.mt;
  const int64_t den = s.af * (rd > 1 ? rd : 1);
  const int64_t row = big ? s.mt : rd;
  const int64_t k_big = floordiv(strong * s.mt, den);
  const int64_t k_small = floordiv(strong, s.af);
  const int64_t col = big ? (k_big < s.mt ? k_big : s.mt)
                          : (k_small < s.mt ? k_small : s.mt);
  const double binom = gather(s.mq_tab, s, row, col);

  const int64_t k2 = floordiv(strong + weak, s.af);
  const bool k2_lt = k2 < rd;
  int64_t k2i = floordiv((strong + weak) * s.mt, den);
  k2i = k2i < s.mt ? k2i : s.mt;
  const int64_t hez_col = big ? (k2_lt ? k2i : s.mt) : (k2_lt ? k2 : rd);
  const double hez_val = gather(s.hez_tab, s, row, hez_col);

  bool gate;
  if (et == s.e_ctx_r && !big)
    gate = ratio_gate(wf, s.ctx_f[i]);
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

// Inputs int64 [n] (etype int32 [n]); tables f64 [rows, cols]; kind/rev
// tables int32 [n_etype]. Outputs: kind int32, accept u8 (0/1), binom and
// hez f64, all [n]. Every etype must lie in [-n_etype, n_etype).
int gt_sv_score(void* pos, void* etype, void* count, void* rs, void* re,
                void* rd, void* weak_f, void* weak_r, void* ctx_f,
                void* mq_tab, void* hez_tab, long rows, long cols,
                void* kind_tab, void* rev_tab, int n_etype, int e_ctx_r,
                long n, long af, long mt, long md, double thr1, long mean,
                long lseq, void* kind, void* accept, void* binom, void* hez,
                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  SvIn s;
  s.pos = (const int64_t*)pos;
  s.etype = (const int32_t*)etype;
  s.count = (const int64_t*)count;
  s.rs = (const int64_t*)rs;
  s.re = (const int64_t*)re;
  s.rd = (const int64_t*)rd;
  s.weak_f = (const int64_t*)weak_f;
  s.weak_r = (const int64_t*)weak_r;
  s.ctx_f = (const int64_t*)ctx_f;
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
  const int blocks = (int)((n + BLOCK - 1) / BLOCK);
  sv_score_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      s, (int32_t*)kind, (uint8_t*)accept, (double*)binom, (double*)hez);
  return (int)cudaGetLastError();
}

}  // extern "C"
