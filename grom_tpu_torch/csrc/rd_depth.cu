// caf_rd_* depth lists of the mesh engine's genome cells: the endpoint-delta
// scatter from the run's spans (K5) and the carried prefix scan with the
// high-mapq depth histogram (K6).
//
// Replaces the non-tile part of grom_tpu/parallel/pipeline.py:54
// build_mesh_step, and the host work that fed it: the endpoint deltas that
// grom_tpu's MeshAccumulator.run builds on the host from the spans (span
// rules of call/scan.py _accumulate_rd_lists), the per-cell delta scatter
// of ``cell_fn`` (:83-89) and, inside ``step``, the exclusive prefix of the
// cell totals with the cross-launch carry (:98-109), the per-cell cumsum
// from that base (:110-112) and the 256-bin histogram of clip(rd_hi, 0,
// 255) (:114-120). The exchange of cell totals between processes stays in
// the wrapper (grom_tpu_torch/parallel/pipeline.py), one all_gather of a
// few integers per cell.
//
// What bounds them on an H100: bytes. K5 reads the run's spans (12 bytes
// each, plus two bytes per read) and writes the delta rows of its group of
// cells (12 bytes per position); K6 reads one cell's rows and writes its
// depth (12 bytes per position each way). Neither has arithmetic worth
// counting. What used to hold them back was host work around the launches
// (a sort and slicing of the endpoints on the host, four blocking uploads
// per cell, a three-launch scan); the design removes it:
//   * rd_scatter (K5), one launch per group of cells: one thread per span
//     applies the endpoint rules (eligible read, whole-span rule ref >= 0
//     && ref + len < L, clipped to [lo, hi), end dropped at hi) and adds
//     +w / -w with integer atomics into the delta rows of the cell owning
//     each endpoint, skipping cells owned by another card or process.
//     Integer atomics are exact in any order, so the spans need no sort. In
//     the same pass it sums each cell's three totals and each 1,024-position
//     chunk of each row: a span whose two endpoints fall in one chunk (or
//     one cell) adds nothing there, and the rest are summed across the warp
//     by key (__match_any_sync) before one atomic per key.
//   * rd_scan (K6), one launch per cell: a block per 1,024-position chunk
//     and channel takes its offset as the carry plus the earlier cells'
//     totals of the launch plus the cell's earlier chunk sums (at most 255,
//     all in L2), scans its chunk reading the rows once with 16-byte loads,
//     writes the depth straight into the caller's output, and bins rd_hi in
//     shared memory before one atomic per bin. The block of chunk 0 of the
//     writing cell also stores the next launch's carry (the carry plus every
//     total of the launch) into a second buffer.
// Nothing syncs with the host and nothing is allocated: the wrappers pass
// the outputs in.
//
// Everything is int32 and wraps like JAX's int32 arithmetic (sums run in
// uint32).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int ITEMS = 4;
constexpr int CHUNK = BLOCK * ITEMS;     // positions per scan block
constexpr int CHUNK_SHIFT = 10;
constexpr int HIST_BINS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;   // key of a lane that adds nothing
constexpr int SCATTER_MAX_BLOCKS = 132 * 16;

static_assert(CHUNK == 1 << CHUNK_SHIFT, "chunk width");

// Sum of a, b, c over the lanes of the warp that share ``peers`` (the
// lanes' __match_any_sync result); the lowest lane of each group ends with
// its group's sums. Every lane of the warp must call it.
__device__ __forceinline__ void reduce_peers(unsigned peers, uint32_t& a,
                                             uint32_t& b, uint32_t& c) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;        // the group's higher lanes
  while (__any_sync(FULL, peers)) {
    const int next = __ffs(peers);     // 1 + the next higher peer, or 0
    const int src = next ? next - 1 : lane;
    const uint32_t ta = __shfl_sync(FULL, a, src);
    const uint32_t tb = __shfl_sync(FULL, b, src);
    const uint32_t tc = __shfl_sync(FULL, c, src);
    if (next) {
      a += ta;
      b += tb;
      c += tc;
    }
    peers &= ~__ballot_sync(FULL, rel & 1);
    rel >>= 1;
  }
}

// Adds (a, b, c) to out[key], out[key + stride], out[key + 2 * stride] where
// ``key`` is not NONE, with one atomic per distinct key of the warp. Every
// lane of the warp must call it.
__device__ __forceinline__ void warp_add3(unsigned key, uint32_t a,
                                          uint32_t b, uint32_t c,
                                          uint32_t* out, long stride,
                                          long key_scale) {
  if (!__any_sync(FULL, key != NONE)) return;
  const unsigned peers = __match_any_sync(FULL, key);
  reduce_peers(peers, a, b, c);
  const int lane = threadIdx.x & 31;
  if (key != NONE && (__ffs(peers) - 1) == lane) {
    uint32_t* o = out + (long)(key / key_scale) * 3 * stride
                  + (long)(key % key_scale);
    if (a) atomicAdd(o, a);
    if (b) atomicAdd(o + stride, b);
    if (c) atomicAdd(o + 2 * stride, c);
  }
}

struct ScatterArgs {
  const int32_t* ref;      // [S] span start
  const int32_t* len;      // [S] span length
  const int32_t* sread;    // [S] read of the span
  const uint8_t* mapq;     // [R]
  const uint8_t* elig;     // [R]
  const int32_t* slot_of;  // [n_launch]: launch cell -> slot on this card
  long S;
  long lo, hi, L;
  int min_mapq;
  long seg_l;
  int n_launch;            // cells per launch (every process)
  int n_dev;               // cells per launch on this card
  long g0, ng;             // the group: launches [g0, g0 + ng)
  int nchunk;              // ceil(seg_l / CHUNK)
  uint32_t* rows;          // [ng * n_dev, 3, seg_l]
  uint32_t* tot;           // [ng * n_dev, 3]
  uint32_t* csum;          // [ng * n_dev, 3, nchunk]
};

// The slot (cell of this group on this card) and cell offset of position
// ``p`` in [lo, hi); false where another card, process or group owns it.
__device__ __forceinline__ bool locate(const ScatterArgs& A, long p,
                                       long& slot, long& off) {
  const long c = (p - A.lo) / A.seg_l;
  const long r = c / A.n_launch;
  if (r < A.g0 || r >= A.g0 + A.ng) return false;
  const int s = A.slot_of[c - r * A.n_launch];
  if (s < 0) return false;
  slot = (r - A.g0) * A.n_dev + s;
  off = p - A.lo - c * A.seg_l;
  return true;
}

__global__ void __launch_bounds__(BLOCK) rd_scatter_kernel(ScatterArgs A) {
  for (long i0 = (long)blockIdx.x * BLOCK; i0 < A.S;
       i0 += (long)gridDim.x * BLOCK) {
    const long i = i0 + threadIdx.x;
    bool ks = false, ke = false;
    long slot_s = 0, off_s = 0, slot_e = 0, off_e = 0;
    uint32_t wm = 0, wh = 0, wl = 0;
    if (i < A.S) {
      const int r = A.sread[i];
      if (A.elig[r]) {
        const long a = A.ref[i];
        const long e_full = a + (long)A.len[i];
        if (a >= 0 && e_full < A.L) {
          const long s = a > A.lo ? a : A.lo;
          const long e = e_full < A.hi ? e_full : A.hi;
          if (e > s) {
            const int q = A.mapq[r];
            wm = (uint32_t)q;
            wh = q >= A.min_mapq ? 1u : 0u;
            wl = 1u - wh;
            ks = locate(A, s, slot_s, off_s);
            ke = e < A.hi && locate(A, e, slot_e, off_e);
          }
        }
      }
    }
    // the rows: +w at the start, -w at the end
    if (ks) {
      uint32_t* p = A.rows + slot_s * 3 * A.seg_l + off_s;
      if (wm) atomicAdd(p, wm);
      if (wh) atomicAdd(p + A.seg_l, wh);
      if (wl) atomicAdd(p + 2 * A.seg_l, wl);
    }
    if (ke) {
      uint32_t* p = A.rows + slot_e * 3 * A.seg_l + off_e;
      if (wm) atomicAdd(p, 0u - wm);
      if (wh) atomicAdd(p + A.seg_l, 0u - wh);
      if (wl) atomicAdd(p + 2 * A.seg_l, 0u - wl);
    }
    // chunk sums and cell totals; a span adds nothing to a key that holds
    // both its endpoints
    unsigned cs = ks ? (unsigned)(slot_s * A.nchunk + (off_s >> CHUNK_SHIFT))
                     : NONE;
    unsigned ce = ke ? (unsigned)(slot_e * A.nchunk + (off_e >> CHUNK_SHIFT))
                     : NONE;
    if (cs == ce) cs = ce = NONE;
    warp_add3(cs, wm, wh, wl, A.csum, A.nchunk, A.nchunk);
    warp_add3(ce, 0u - wm, 0u - wh, 0u - wl, A.csum, A.nchunk, A.nchunk);
    unsigned ts = ks ? (unsigned)slot_s : NONE;
    unsigned te = ke ? (unsigned)slot_e : NONE;
    if (ts == te) ts = te = NONE;
    warp_add3(ts, wm, wh, wl, A.tot, 1, 1);
    warp_add3(te, 0u - wm, 0u - wh, 0u - wl, A.tot, 1, 1);
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

struct ScanArgs {
  const uint32_t* rows;     // [3, n] the cell's delta rows
  const uint32_t* csum;     // [3, nchunk] their chunk sums
  const uint32_t* tot_all;  // [n_launch, 3] every cell's totals
  const uint32_t* carry_in; // [3] the depth before the launch
  uint32_t* carry_out;      // [3] the depth after it, or null
  int j;                    // the cell's index in the launch
  int n_launch;
  long n, npos;
  int nchunk;
  int vec;                  // n % 4 == 0: 16-byte loads and stores
  int32_t* rd;              // [3, n]
  int32_t* hist;            // [256], added to
};

__global__ void __launch_bounds__(BLOCK) rd_scan_kernel(ScanArgs A) {
  __shared__ uint32_t warp_tot[BLOCK / 32];
  __shared__ uint32_t warp_part[BLOCK / 32];
  __shared__ int32_t sh_hist[HIST_BINS];
  const int c = blockIdx.y;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long p0 = (long)b * CHUNK + (long)threadIdx.x * ITEMS;
  const bool binning = c == 1 && (long)b * CHUNK < A.npos;
  const uint32_t* row = A.rows + (long)c * A.n;

  // this thread's four positions, loaded first
  uint32_t v[ITEMS];
  if (A.vec && p0 + ITEMS <= A.n) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + p0);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    for (int k = 0; k < ITEMS; ++k) v[k] = p0 + k < A.n ? row[p0 + k] : 0u;
  }
  if (binning)
    for (int k = threadIdx.x; k < HIST_BINS; k += BLOCK) sh_hist[k] = 0;

  // the chunk's offset: carry + earlier cells' totals + earlier chunks
  uint32_t part = threadIdx.x == 0 ? A.carry_in[c] : 0u;
  for (int t = threadIdx.x; t < b; t += BLOCK) part += A.csum[(long)c * A.nchunk + t];
  for (int t = threadIdx.x; t < A.j; t += BLOCK) part += A.tot_all[3 * t + c];
  part = warp_sum(part);

  // inclusive scan of the four positions, then over the block
  for (int k = 1; k < ITEMS; ++k) v[k] += v[k - 1];
  uint32_t s = v[ITEMS - 1];
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_up_sync(FULL, s, o);
    if (lane >= o) s += up;
  }
  if (lane == 31) warp_tot[warp] = s;
  if (lane == 0) warp_part[warp] = part;
  __syncthreads();
  uint32_t before = 0, off = 0;
  for (int w = 0; w < BLOCK / 32; ++w) {
    if (w < warp) before += warp_tot[w];
    off += warp_part[w];
  }
  const uint32_t add = off + before + (s - v[ITEMS - 1]);

  int32_t r[ITEMS];
  for (int k = 0; k < ITEMS; ++k) r[k] = (int32_t)(add + v[k]);
  int32_t* out = A.rd + (long)c * A.n;
  if (A.vec && p0 + ITEMS <= A.n) {
    *reinterpret_cast<int4*>(out + p0) = make_int4(r[0], r[1], r[2], r[3]);
  } else {
    for (int k = 0; k < ITEMS; ++k)
      if (p0 + k < A.n) out[p0 + k] = r[k];
  }

  if (A.carry_out && b == 0 && threadIdx.x == 0) {
    uint32_t t = A.carry_in[c];
    for (int i = 0; i < A.n_launch; ++i) t += A.tot_all[3 * i + c];
    A.carry_out[c] = t;
  }

  if (binning) {
    // (the barrier above ordered the clearing of sh_hist)
    // neighbouring positions mostly share a depth: one add per run of it
    int prev = -1, cnt = 0;
    for (int k = 0; k < ITEMS; ++k) {
      if (p0 + k >= A.npos) break;
      const int bin = r[k] < 0 ? 0 : (r[k] > HIST_BINS - 1 ? HIST_BINS - 1
                                                            : r[k]);
      if (bin != prev) {
        if (cnt) atomicAdd(&sh_hist[prev], cnt);
        prev = bin;
        cnt = 0;
      }
      ++cnt;
    }
    if (cnt) atomicAdd(&sh_hist[prev], cnt);
    __syncthreads();
    for (int k = threadIdx.x; k < HIST_BINS; k += BLOCK)
      if (sh_hist[k]) atomicAdd(A.hist + k, sh_hist[k]);
  }
}

}  // namespace

extern "C" {

const char* gt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K5 over the group of launches [g0, g0 + ng): ``rows`` int32 [ng * n_dev,
// 3, seg_l], ``tot`` [ng * n_dev, 3] and ``csum`` [ng * n_dev, 3, nchunk]
// are cleared here, then filled. The spans (``ref``, ``len``, ``sread``
// int32 [S]) index the reads' ``mapq`` and ``elig`` (u8 [R]); ``slot_of``
// int32 [n_launch] maps a launch's cells to this card's slots (-1: not
// this card's).
int gt_rd_scatter(void* ref, void* len, void* sread, void* mapq, void* elig,
                  void* slot_of, long S, long lo, long hi, long L,
                  int min_mapq, long seg_l, int n_launch, int n_dev, long g0,
                  long ng, void* rows, void* tot, void* csum, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long cells = ng * n_dev;
  const int nchunk = (int)((seg_l + CHUNK - 1) / CHUNK);
  cudaMemsetAsync(rows, 0, sizeof(int32_t) * 3 * (size_t)(cells * seg_l), st);
  cudaMemsetAsync(tot, 0, sizeof(int32_t) * 3 * (size_t)cells, st);
  cudaMemsetAsync(csum, 0, sizeof(int32_t) * 3 * (size_t)(cells * nchunk),
                  st);
  if (S > 0 && cells > 0) {
    ScatterArgs A;
    A.ref = (const int32_t*)ref;
    A.len = (const int32_t*)len;
    A.sread = (const int32_t*)sread;
    A.mapq = (const uint8_t*)mapq;
    A.elig = (const uint8_t*)elig;
    A.slot_of = (const int32_t*)slot_of;
    A.S = S;
    A.lo = lo;
    A.hi = hi;
    A.L = L;
    A.min_mapq = min_mapq;
    A.seg_l = seg_l;
    A.n_launch = n_launch;
    A.n_dev = n_dev;
    A.g0 = g0;
    A.ng = ng;
    A.nchunk = nchunk;
    A.rows = (uint32_t*)rows;
    A.tot = (uint32_t*)tot;
    A.csum = (uint32_t*)csum;
    long blocks = (S + BLOCK - 1) / BLOCK;
    if (blocks > SCATTER_MAX_BLOCKS) blocks = SCATTER_MAX_BLOCKS;
    rd_scatter_kernel<<<(int)blocks, BLOCK, 0, st>>>(A);
  }
  return (int)cudaGetLastError();
}

// K6 of cell ``j`` of a launch: ``rows`` int32 [3, n] and ``csum`` [3,
// ceil(n / 1024)] from K5, ``tot_all`` [n_launch, 3] the launch's cell
// totals, ``carry_in`` [3]; writes ``rd`` [3, n], adds the histogram of
// clip(rd_hi[:npos], 0, 255) into ``hist`` [256], and, when ``carry_out``
// is not null, stores carry_in + every total of the launch there.
int gt_rd_scan(void* rows, void* csum, void* tot_all, int j, int n_launch,
               void* carry_in, void* carry_out, long n, long npos, void* rd,
               void* hist, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  ScanArgs A;
  A.rows = (const uint32_t*)rows;
  A.csum = (const uint32_t*)csum;
  A.tot_all = (const uint32_t*)tot_all;
  A.carry_in = (const uint32_t*)carry_in;
  A.carry_out = (uint32_t*)carry_out;
  A.j = j;
  A.n_launch = n_launch;
  A.n = n;
  A.npos = npos;
  A.nchunk = (int)((n + CHUNK - 1) / CHUNK);
  A.vec = (n % ITEMS) == 0 && ((uintptr_t)rows % 16) == 0
          && ((uintptr_t)rd % 16) == 0;
  A.rd = (int32_t*)rd;
  A.hist = (int32_t*)hist;
  const dim3 grid(A.nchunk, 3);
  rd_scan_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // extern "C"
