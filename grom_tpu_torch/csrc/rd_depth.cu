// caf_rd_* depth lists of one genome cell: the endpoint-delta scatter (K5)
// and the carried prefix scan with the high-mapq depth histogram (K6).
//
// Replaces the non-tile part of grom_tpu/parallel/pipeline.py:54
// build_mesh_step: the per-cell delta scatter of ``cell_fn`` (:83-89) and,
// inside ``step``, the per-cell cumsum from the carried base (:110-112) and
// the 256-bin histogram of clip(rd_hi, 0, 255) (:115-120). The exchange of
// cell totals, their exclusive prefix and the cross-launch carry (:99-109)
// stay in the wrapper (grom_tpu_torch/parallel/pipeline.py), as
// torch.distributed collectives over a few integers per cell.
//
// What bounds them on an H100: a cell is at most 2^18 positions, so the
// three int32 delta rows (3 MB) stay in L2; both kernels are bound by their
// launches and one pass over those rows, not by arithmetic.
//   * rd_scatter: one thread per delta, integer atomicAdd into the three
//     rows (exact in any order, so the deltas need no sort on the card),
//     and a warp-shuffle + shared-memory block reduction of the three cell
//     totals, one atomicAdd per block and channel.
//   * rd_scan: block sums (one block per 1024 positions and channel), a
//     one-block exclusive scan of the block sums seeded with the cell's
//     base, then a block-local inclusive scan that adds the block's offset.
//     The rd_hi blocks also build a shared-memory histogram of their first
//     ``npos`` positions, flushed to global with integer atomics.
//
// Everything is int32 and wraps like JAX's int32 arithmetic (sums run in
// uint32).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int ITEMS = 4;
constexpr int CHUNK = BLOCK * ITEMS;     // positions per scan block
constexpr int SCAN_THREADS = 1024;
constexpr int HIST_BINS = 256;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Inclusive scan of ``v`` over the block (BLOCK threads); ``warp_tot`` is
// shared scratch of BLOCK / 32 entries.
__device__ __forceinline__ uint32_t block_incl_scan(uint32_t v,
                                                    uint32_t* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += up;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < BLOCK / 32 ? warp_tot[lane] : 0u;
    for (int o = 1; o < BLOCK / 32; o <<= 1) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += up;
    }
    if (lane < BLOCK / 32) warp_tot[lane] = w;
  }
  __syncthreads();
  return warp > 0 ? v + warp_tot[warp - 1] : v;
}

// K5: delta rows [3, n] (zeroed) += the weights at their positions; tot[3]
// (zeroed) += the weights. Positions outside [0, n) are dropped.
__global__ void rd_scatter_kernel(const int32_t* pos, const int32_t* w_mq,
                                  const int8_t* w_hi, const int8_t* w_lo,
                                  long D, long n, int32_t* delta,
                                  int32_t* tot) {
  __shared__ uint32_t part[3][BLOCK / 32];
  const long i = (long)blockIdx.x * BLOCK + threadIdx.x;
  uint32_t a = 0, b = 0, c = 0;
  if (i < D) {
    const long p = pos[i];
    if (p >= 0 && p < n) {
      a = (uint32_t)w_mq[i];
      b = (uint32_t)(int32_t)w_hi[i];
      c = (uint32_t)(int32_t)w_lo[i];
      atomicAdd((unsigned int*)delta + p, a);
      atomicAdd((unsigned int*)delta + n + p, b);
      atomicAdd((unsigned int*)delta + 2 * n + p, c);
    }
  }
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
    part[2][warp] = c;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    uint32_t s = 0;
    for (int w = 0; w < BLOCK / 32; ++w) s += part[threadIdx.x][w];
    if (s) atomicAdd((unsigned int*)tot + threadIdx.x, s);
  }
}

// Sums of each CHUNK of each channel: block_sum[c * nblk + b].
__global__ void rd_block_sums(const int32_t* delta, long n, int nblk,
                              uint32_t* block_sum) {
  __shared__ uint32_t part[BLOCK / 32];
  const int c = blockIdx.y;
  const long base = (long)blockIdx.x * CHUNK + (long)threadIdx.x * ITEMS;
  const int32_t* row = delta + (long)c * n;
  uint32_t s = 0;
  for (int k = 0; k < ITEMS; ++k)
    if (base + k < n) s += (uint32_t)row[base + k];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
    for (int w = 0; w < BLOCK / 32; ++w) t += part[w];
    block_sum[(long)c * nblk + blockIdx.x] = t;
  }
}

// Exclusive scan of one channel's block sums (one block per channel),
// seeded with base[c].
__global__ void rd_block_offsets(const uint32_t* block_sum, int nblk,
                                 const int32_t* base, uint32_t* block_off) {
  __shared__ uint32_t part[SCAN_THREADS];
  const int c = blockIdx.x;
  const uint32_t* in = block_sum + (long)c * nblk;
  uint32_t* out = block_off + (long)c * nblk;
  const int per = (nblk + SCAN_THREADS - 1) / SCAN_THREADS;
  const int b0 = threadIdx.x * per;
  const int b1 = b0 + per < nblk ? b0 + per : nblk;
  uint32_t s = 0;
  for (int i = b0; i < b1; ++i) s += in[i];
  part[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t run = (uint32_t)base[c];
    for (int t = 0; t < SCAN_THREADS; ++t) {
      const uint32_t v = part[t];
      part[t] = run;
      run += v;
    }
  }
  __syncthreads();
  uint32_t run = part[threadIdx.x];
  for (int i = b0; i < b1; ++i) {
    out[i] = run;
    run += in[i];
  }
}

// rd[c, p] = block_off + inclusive in-block prefix; channel 1 (rd_hi) also
// bins clip(rd, 0, 255) of its positions below npos into hist.
__global__ void rd_block_scan(const int32_t* delta, long n, long npos,
                              int nblk, const uint32_t* block_off,
                              int32_t* rd, int32_t* hist) {
  __shared__ uint32_t warp_tot[BLOCK / 32];
  __shared__ int32_t sh_hist[HIST_BINS];
  const int c = blockIdx.y;
  const bool binning = c == 1;
  if (binning)
    for (int k = threadIdx.x; k < HIST_BINS; k += BLOCK) sh_hist[k] = 0;
  const long base = (long)blockIdx.x * CHUNK + (long)threadIdx.x * ITEMS;
  const int32_t* row = delta + (long)c * n;
  uint32_t v[ITEMS];
  uint32_t s = 0;
  for (int k = 0; k < ITEMS; ++k) {
    s += base + k < n ? (uint32_t)row[base + k] : 0u;
    v[k] = s;
  }
  const uint32_t incl = block_incl_scan(s, warp_tot);
  const uint32_t off = block_off[(long)c * nblk + blockIdx.x] + (incl - s);
  int32_t* out = rd + (long)c * n;
  for (int k = 0; k < ITEMS; ++k) {
    const long p = base + k;
    if (p < n) {
      const int32_t r = (int32_t)(off + v[k]);
      out[p] = r;
      if (binning && p < npos)
        atomicAdd(&sh_hist[r < 0 ? 0 : (r > HIST_BINS - 1 ? HIST_BINS - 1
                                                          : r)], 1);
    }
  }
  if (binning) {
    __syncthreads();
    for (int k = threadIdx.x; k < HIST_BINS; k += BLOCK)
      if (sh_hist[k]) atomicAdd(hist + k, sh_hist[k]);
  }
}

}  // namespace

extern "C" {

const char* gt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K5. ``pos`` int32 [D] (cell-relative), ``w_mq`` int32, ``w_hi``/``w_lo``
// int8 [D]; ``delta`` int32 [3, n] and ``tot`` int32 [3] are zeroed here.
int gt_rd_scatter(void* pos, void* w_mq, void* w_hi, void* w_lo, long D,
                  long n, void* delta, void* tot, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(delta, 0, sizeof(int32_t) * 3 * (size_t)n, s);
  cudaMemsetAsync(tot, 0, sizeof(int32_t) * 3, s);
  if (D > 0) {
    const int blocks = (int)((D + BLOCK - 1) / BLOCK);
    rd_scatter_kernel<<<blocks, BLOCK, 0, s>>>(
        (const int32_t*)pos, (const int32_t*)w_mq, (const int8_t*)w_hi,
        (const int8_t*)w_lo, D, n, (int32_t*)delta, (int32_t*)tot);
  }
  return (int)cudaGetLastError();
}

// K6. ``delta`` int32 [3, n], ``base`` int32 [3] (on the card); ``rd``
// int32 [3, n]; ``hist`` int32 [256] is zeroed here. ``block_sum`` and
// ``block_off`` are int32 scratch of 3 * ceil(n / 1024) entries.
int gt_rd_scan(void* delta, void* base, long n, long npos, void* block_sum,
               void* block_off, void* rd, void* hist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(hist, 0, sizeof(int32_t) * HIST_BINS, s);
  if (n <= 0) return (int)cudaGetLastError();
  const int nblk = (int)((n + CHUNK - 1) / CHUNK);
  const dim3 grid(nblk, 3);
  rd_block_sums<<<grid, BLOCK, 0, s>>>((const int32_t*)delta, n, nblk,
                                       (uint32_t*)block_sum);
  rd_block_offsets<<<3, SCAN_THREADS, 0, s>>>(
      (const uint32_t*)block_sum, nblk, (const int32_t*)base,
      (uint32_t*)block_off);
  rd_block_scan<<<grid, BLOCK, 0, s>>>((const int32_t*)delta, n, npos, nblk,
                                       (const uint32_t*)block_off,
                                       (int32_t*)rd, (int32_t*)hist);
  return (int)cudaGetLastError();
}

}  // extern "C"
