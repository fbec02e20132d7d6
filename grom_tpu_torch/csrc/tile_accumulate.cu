// Per-tile accumulate + SNV superset screen for the streamed calling path.
//
// Replaces grom_tpu/ops/accumulate.py:tile_kernel_core (the jitted
// jax.numpy tile kernel): span expansion into per-aligned-base events,
// byte-level mismatch test, exact read-name dedup on the high-quality
// mismatch subset, per-base int32 tallies, base_tot and the f32 ratio
// screen compacted in ascending position order.
//
// What bounds it on an H100: memory traffic and atomics. Every aligned base
// is one event that reads ~8 bytes of read state and issues a few int32
// atomics into ~22 L-long tally arrays (2^18 positions x 4 B x 22 = 23 MB,
// L2-resident). The design keeps the event pass free of sorting: the JAX
// version sorts all events by position, here only the (rare) high-quality
// mismatch events go through a per-position CSR and a per-position
// insertion sort by event index, which is what the dedup ranking needs.
// A coverage spike makes one position's sort quadratic; it stays correct.
//
// Passes, all on the caller's stream:
//   (a) tile_events   one thread per event: classify, atomically tally the
//                     events dedup cannot touch, count hi&mm per position
//   (b) tile_fill     one thread per event: place hi&mm event indices into
//                     the per-position CSR (offsets from a host-side cumsum)
//   (c) tile_dedup    one thread per position: sort its events by event
//                     index, walk them with a table of stored short names,
//                     tally the survivors
//   (d) tile_screen   one thread per position: base_tot, the f32 screen,
//                     candidate flag, per-block candidate counts
//   (e) tile_compact  one thread per position: ordered write of candidates
//
// Exactness: every tally is an integer, so atomic order does not matter;
// the dedup order is the event index (spans in SpanIndex order, then offset
// within the span), as in the reference. Built with --fmad=false and
// without fast math: the f32 division and comparison are IEEE.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 4;
constexpr int BLOCK = 256;

struct Tile {
  const int32_t* span_read;
  const int32_t* span_ref;
  const int32_t* span_off;
  const int32_t* cum;      // [S + 1], cum[0] = 0
  int S;
  const uint8_t* elig;
  const uint8_t* mapq;
  const int32_t* flag;
  const int32_t* lseq;
  const int32_t* seq_off;
  const int32_t* name_id;
  const uint8_t* name_len;
  const uint8_t* seq;
  const uint8_t* qual;
  const uint8_t* chrom_up;
  int L;
  int min_mapq;
  int min_bq;
  int name_len_cap;
};

struct Event {
  int pos;
  int ridx;
  int code;
  int q;
  int mq;
  int lsq;
  int nid;
  bool ok;
  bool hi;
  bool mm;
  bool fwd;
  bool nshort;
};

__device__ __forceinline__ int base_code(int b) {
  switch (b) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return 4;
  }
}

__device__ Event decode(const Tile& t, int e) {
  // span of event e: the largest s with cum[s] <= e
  int lo = 0, hi = t.S;
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (t.cum[mid] <= e) lo = mid; else hi = mid;
  }
  const int within = e - t.cum[lo];
  const int rid = t.span_read[lo];
  Event ev;
  ev.pos = t.span_ref[lo] + within;
  ev.ridx = t.span_off[lo] + within;
  ev.ok = t.elig[rid] > 0 && ev.pos >= 0 && ev.pos < t.L;
  if (!ev.ok) {
    ev.hi = ev.mm = ev.fwd = ev.nshort = false;
    ev.code = NT; ev.q = ev.mq = ev.lsq = 0; ev.nid = -1;
    return ev;
  }
  const int flat = t.seq_off[rid] + ev.ridx;
  const int sb = t.seq[flat];
  ev.code = base_code(sb);
  ev.q = t.qual[flat];
  ev.mq = t.mapq[rid];
  ev.fwd = (t.flag[rid] & 16) == 0;
  ev.lsq = t.lseq[rid];
  ev.nid = t.name_id[rid];
  ev.nshort = t.name_len[rid] < t.name_len_cap;
  ev.hi = ev.mq >= t.min_mapq && ev.q >= t.min_bq;
  // byte-level mismatch: toupper(ref) != read byte (IUPAC must not collide)
  ev.mm = t.chrom_up[ev.pos] != sb;
  return ev;
}

// Tally arrays, each [L] or [NT, L] int32, zeroed by the caller.
struct Tally {
  int32_t* snv;      // [NT, L]
  int32_t* lowmq;    // [NT, L]
  int32_t* fstrand;  // [NT, L]
  int32_t* pir;      // [NT, L]
  int32_t* bq;       // counted
  int32_t* bq_low;   // low
  int32_t* mq;
  int32_t* mq_low;
  int32_t* n_hi;
  int32_t* n_low;
};

__global__ void tile_events(Tile t, Tally a, int E, int32_t* mm_count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const Event ev = decode(t, e);
  if (!ev.ok) return;
  if (ev.hi && ev.mm) {            // dedup decides these in tile_dedup
    atomicAdd(&mm_count[ev.pos], 1);
    return;
  }
  if (ev.code >= NT) return;
  const int p = ev.pos;
  const int cl = ev.code * t.L + p;
  if (ev.hi) {
    atomicAdd(&a.snv[cl], 1);
    if (ev.fwd) atomicAdd(&a.fstrand[cl], 1);
    // pos_in_read: ridx when mm | fwd, else lseq - ridx (mm is false here)
    atomicAdd(&a.pir[cl], ev.fwd ? ev.ridx : ev.lsq - ev.ridx);
    atomicAdd(&a.bq[p], ev.q);
    atomicAdd(&a.mq[p], ev.mq);
    atomicAdd(&a.n_hi[p], 1);
  } else {
    atomicAdd(&a.lowmq[cl], 1);
    atomicAdd(&a.bq_low[p], ev.q);
    atomicAdd(&a.mq_low[p], ev.mq);
    atomicAdd(&a.n_low[p], 1);
  }
}

__global__ void tile_fill(Tile t, int E, const int64_t* off, int32_t* fill,
                          int32_t* csr) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const Event ev = decode(t, e);
  if (!(ev.ok && ev.hi && ev.mm)) return;
  const int slot = atomicAdd(&fill[ev.pos], 1);
  csr[off[ev.pos] + slot] = e;
}

__global__ void tile_dedup(Tile t, Tally a, const int64_t* off,
                           const int32_t* mm_count, int32_t* csr,
                           int32_t* table, int min_snv) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= t.L) return;
  const int k = mm_count[p];
  if (k == 0) return;
  int32_t* ev_idx = csr + off[p];
  int32_t* tab = table + off[p];   // stored short names, at most k
  // arrival order = event index
  for (int i = 1; i < k; ++i) {
    const int32_t v = ev_idx[i];
    int j = i - 1;
    while (j >= 0 && ev_idx[j] > v) { ev_idx[j + 1] = ev_idx[j]; --j; }
    ev_idx[j + 1] = v;
  }
  int stored = 0;
  for (int i = 0; i < k; ++i) {
    const Event ev = decode(t, ev_idx[i]);
    bool seen = false;
    for (int s = 0; s < stored; ++s) {
      if (tab[s] == ev.nid) { seen = true; break; }
    }
    // a repeat of a stored (pos, name) group is skipped
    if (seen) continue;
    // a short group is stored iff fewer than min_snv short groups arrived
    // before it at this position
    if (ev.nshort && stored < min_snv) tab[stored++] = ev.nid;
    if (ev.code >= NT) continue;
    const int cl = ev.code * t.L + p;
    a.snv[cl] += 1;
    if (ev.fwd) a.fstrand[cl] += 1;
    a.pir[cl] += ev.ridx;           // mm: pos_in_read is ridx
    a.bq[p] += ev.q;
    a.mq[p] += ev.mq;
    a.n_hi[p] += 1;
  }
}

__device__ __forceinline__ int32_t wrap_add(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x + (uint32_t)y);
}

__global__ void tile_screen(Tile t, Tally a, const uint8_t* is_n,
                            const uint8_t* gate, float thr, int min_snv,
                            int32_t* base_tot, uint8_t* flag,
                            int32_t* block_count) {
  __shared__ int warp_count[BLOCK / 32];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  bool cand = false;
  if (p < t.L) {
    int32_t snv[NT];
    int32_t total = 0, low = 0;
    for (int c = 0; c < NT; ++c) {
      snv[c] = a.snv[c * t.L + p];
      total = wrap_add(total, snv[c]);
      low = wrap_add(low, a.lowmq[c * t.L + p]);
    }
    base_tot[p] = wrap_add(total, low);
    const int ref_code = base_code(t.chrom_up[p]);
    if (gate[p] > 0 && !is_n[p]) {
      const float tf = (float)total;
      for (int c = 0; c < NT; ++c) {
        // IEEE f32 division: 0/0 is NaN and fails the comparison
        const float ratio = (float)snv[c] / tf;
        if (c != ref_code && ratio >= thr && snv[c] >= min_snv) cand = true;
      }
    }
    flag[p] = cand ? 1 : 0;
  }
  const unsigned bal = __ballot_sync(0xffffffffu, cand);
  if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = __popc(bal);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < BLOCK / 32; ++w) s += warp_count[w];
    block_count[blockIdx.x] = s;
  }
}

struct Cand {
  int64_t* pos;
  int32_t* counts;       // [NT, K]
  int32_t* lowmq;        // [NT, K]
  int32_t* pos_in_read;  // [NT, K]
  int32_t* fstrand;      // [NT, K]
  int32_t* bq;
  int32_t* bq_all;
  int32_t* mq;
  int32_t* mq_all;
  int32_t* bq_read_count;
  int32_t* mq_read_count;
  int32_t* read_count_all;
  int K;
};

__global__ void tile_compact(Tile t, Tally a, const uint8_t* flag,
                             const int64_t* block_off, Cand c) {
  __shared__ int warp_base[BLOCK / 32];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool cand = p < t.L && flag[p];
  const unsigned bal = __ballot_sync(0xffffffffu, cand);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_base[warp] = __popc(bal);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < BLOCK / 32; ++w) {
      const int n = warp_base[w];
      warp_base[w] = s;
      s += n;
    }
  }
  __syncthreads();
  if (!cand) return;
  const int64_t r = block_off[blockIdx.x] + warp_base[warp]
      + __popc(bal & ((1u << lane) - 1u));
  c.pos[r] = p;
  for (int k = 0; k < NT; ++k) {
    c.counts[k * c.K + r] = a.snv[k * t.L + p];
    c.lowmq[k * c.K + r] = a.lowmq[k * t.L + p];
    c.pos_in_read[k * c.K + r] = a.pir[k * t.L + p];
    c.fstrand[k * c.K + r] = a.fstrand[k * t.L + p];
  }
  c.bq[r] = a.bq[p];
  c.bq_all[r] = wrap_add(a.bq[p], a.bq_low[p]);
  c.mq[r] = a.mq[p];
  c.mq_all[r] = wrap_add(a.mq[p], a.mq_low[p]);
  c.bq_read_count[r] = a.n_hi[p];
  c.mq_read_count[r] = a.n_hi[p];
  c.read_count_all[r] = wrap_add(a.n_hi[p], a.n_low[p]);
}

inline int blocks_for(long n) { return (int)((n + BLOCK - 1) / BLOCK); }

Tile make_tile(void* span_read, void* span_ref, void* span_off, void* cum,
               int S, void* elig, void* mapq, void* flag, void* lseq,
               void* seq_off, void* name_id, void* name_len, void* seq,
               void* qual, void* chrom_up, int L, int min_mapq, int min_bq,
               int name_len_cap) {
  Tile t;
  t.span_read = (const int32_t*)span_read;
  t.span_ref = (const int32_t*)span_ref;
  t.span_off = (const int32_t*)span_off;
  t.cum = (const int32_t*)cum;
  t.S = S;
  t.elig = (const uint8_t*)elig;
  t.mapq = (const uint8_t*)mapq;
  t.flag = (const int32_t*)flag;
  t.lseq = (const int32_t*)lseq;
  t.seq_off = (const int32_t*)seq_off;
  t.name_id = (const int32_t*)name_id;
  t.name_len = (const uint8_t*)name_len;
  t.seq = (const uint8_t*)seq;
  t.qual = (const uint8_t*)qual;
  t.chrom_up = (const uint8_t*)chrom_up;
  t.L = L;
  t.min_mapq = min_mapq;
  t.min_bq = min_bq;
  t.name_len_cap = name_len_cap;
  return t;
}

Tally make_tally(void* tally, int L) {
  // one zeroed int32 buffer [22, L]: snv, lowmq, fstrand, pir ([4, L]
  // each), then bq, bq_low, mq, mq_low, n_hi, n_low
  int32_t* b = (int32_t*)tally;
  const long l = L;
  Tally a;
  a.snv = b;
  a.lowmq = b + 4 * l;
  a.fstrand = b + 8 * l;
  a.pir = b + 12 * l;
  a.bq = b + 16 * l;
  a.bq_low = b + 17 * l;
  a.mq = b + 18 * l;
  a.mq_low = b + 19 * l;
  a.n_hi = b + 20 * l;
  a.n_low = b + 21 * l;
  return a;
}

}  // namespace

#define TILE_ARGS                                                          \
  void *span_read, void *span_ref, void *span_off, void *cum, int S,       \
      void *elig, void *mapq, void *flag, void *lseq, void *seq_off,       \
      void *name_id, void *name_len, void *seq, void *qual,                \
      void *chrom_up, int L, int min_mapq, int min_bq, int name_len_cap
#define TILE_PASS                                                          \
  span_read, span_ref, span_off, cum, S, elig, mapq, flag, lseq, seq_off,  \
      name_id, name_len, seq, qual, chrom_up, L, min_mapq, min_bq,         \
      name_len_cap

extern "C" {

const char* gt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Pass (a) + the fill of pass (b). ``tally`` is a zeroed int32 [22, L];
// ``mm_count`` a zeroed int32 [L]. ``off`` is the exclusive prefix of
// mm_count ([L] int64), computed by the caller between the two launches.
int gt_tile_events(TILE_ARGS, int E, void* tally, void* mm_count,
                   void* stream) {
  if (E <= 0) return (int)cudaGetLastError();
  const Tile t = make_tile(TILE_PASS);
  tile_events<<<blocks_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
      t, make_tally(tally, L), E, (int32_t*)mm_count);
  return (int)cudaGetLastError();
}

// Passes (b) fill, (c) dedup and (d) screen. ``fill`` is a zeroed int32
// [L]; ``csr`` and ``table`` int32 [max(n_mm, 1)]; ``block_count`` int32
// [ceil(L / 256)].
int gt_tile_dedup_screen(TILE_ARGS, int E, void* tally, void* mm_count,
                         void* off, void* fill, void* csr, void* table,
                         int min_snv, void* is_n, void* gate, float thr,
                         void* base_tot, void* cand_flag, void* block_count,
                         void* stream) {
  const Tile t = make_tile(TILE_PASS);
  const Tally a = make_tally(tally, L);
  cudaStream_t s = (cudaStream_t)stream;
  if (E > 0) {
    tile_fill<<<blocks_for(E), BLOCK, 0, s>>>(
        t, E, (const int64_t*)off, (int32_t*)fill, (int32_t*)csr);
    tile_dedup<<<blocks_for(L), BLOCK, 0, s>>>(
        t, a, (const int64_t*)off, (const int32_t*)mm_count, (int32_t*)csr,
        (int32_t*)table, min_snv);
  }
  tile_screen<<<blocks_for(L), BLOCK, 0, s>>>(
      t, a, (const uint8_t*)is_n, (const uint8_t*)gate, thr, min_snv,
      (int32_t*)base_tot, (uint8_t*)cand_flag, (int32_t*)block_count);
  return (int)cudaGetLastError();
}

// Pass (e): ``block_off`` is the exclusive prefix of block_count (int64);
// the candidate outputs hold K = n_cand entries ([4, K] for the channels).
int gt_tile_compact(TILE_ARGS, void* tally, void* cand_flag, void* block_off,
                    void* pos, void* counts, void* lowmq, void* pos_in_read,
                    void* fstrand, void* bq, void* bq_all, void* mq,
                    void* mq_all, void* bq_read_count, void* mq_read_count,
                    void* read_count_all, int K, void* stream) {
  if (K <= 0) return (int)cudaGetLastError();
  const Tile t = make_tile(TILE_PASS);
  Cand c;
  c.pos = (int64_t*)pos;
  c.counts = (int32_t*)counts;
  c.lowmq = (int32_t*)lowmq;
  c.pos_in_read = (int32_t*)pos_in_read;
  c.fstrand = (int32_t*)fstrand;
  c.bq = (int32_t*)bq;
  c.bq_all = (int32_t*)bq_all;
  c.mq = (int32_t*)mq;
  c.mq_all = (int32_t*)mq_all;
  c.bq_read_count = (int32_t*)bq_read_count;
  c.mq_read_count = (int32_t*)mq_read_count;
  c.read_count_all = (int32_t*)read_count_all;
  c.K = K;
  tile_compact<<<blocks_for(L), BLOCK, 0, (cudaStream_t)stream>>>(
      t, make_tally(tally, L), (const uint8_t*)cand_flag,
      (const int64_t*)block_off, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
