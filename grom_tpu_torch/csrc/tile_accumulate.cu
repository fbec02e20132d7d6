// Per-tile accumulate + SNV superset screen for the streamed calling path.
//
// Replaces grom_tpu/ops/accumulate.py:tile_kernel_core (the jitted
// jax.numpy tile kernel): span expansion into per-aligned-base events,
// byte-level mismatch test, exact read-name dedup on the high-quality
// mismatch subset, per-base int32 tallies, base_tot and the f32 ratio
// screen compacted in ascending position order.
//
// What bounds it on an H100: the bytes of the tile's inputs (about 21 MB of
// spans, reads' bases and qualities for a full 2^18-base tile at 30x), read
// once: 6-7 us at 3.35 TB/s. The design keeps everything else on chip:
//
//   tile_window   one block per window of W = 512 positions. The block
//                 searches (two warps, 32 probes a round) for the spans
//                 that reach its window (spans arrive sorted by start,
//                 SpanIndex order, and none is longer than ``max_span``)
//                 and clips them to the window itself. A warp looks up 32
//                 spans and their reads in one round of loads, then walks
//                 them one at a time, 32 bases a step, with coalesced loads
//                 of bases and qualities. The 20 per-position tallies live
//                 in shared memory (40 KB) and take integer shared-memory
//                 atomics, exact in any order. The high-quality mismatch
//                 events, whose read-name dedup depends on arrival order, go
//                 to a per-position list in shared memory; one thread per
//                 position then resolves its list (below) and tallies the
//                 survivors. The same block computes base_tot, the f32
//                 screen and its candidate rows in ascending order.
//   tile_compact  one block per window: the prefix of the candidate counts
//                 of earlier windows (summed on the card), then its rows to
//                 their place; the last block writes the header.
//
// A window whose mismatch list overflows shared memory (a coverage spike)
// takes room in a global pool sized by the tile's aligned bases (a bound
// known on the host) and walks its spans a second time to fill it: the
// host never sees it. The host makes no sync between the launches and sizes
// no buffer from the card's counts.
//
// Dedup, exactly as the reference's slot table: at one position, the hi &
// mm events group by read name; a group is "stored" iff it is short (name
// shorter than name_len_cap) and fewer than min_snv short groups arrived
// before it; every event of a stored group but its first is skipped. The
// arrival order of events at one position is their span's index (one span
// covers a position at most once), so the position's thread finds the
// stored groups by min_snv rounds of "earliest short event whose name is
// not yet grouped": no sort, the same answer as the ordered walk.
//
// Exactness: integer tallies with uint32 wrapping (JAX's int32 wraps);
// the byte-level mismatch against the uppercased reference byte; the f32
// IEEE division and >= against the f32 threshold (built with --fmad=false,
// never fast math); candidates in ascending position order.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 4;
constexpr int W = 512;           // positions per window block
constexpr int THREADS = 512;     // threads per window block: one a position
constexpr int WARPS = THREADS / 32;
constexpr int CAP = 1536;        // mismatch events a window keeps on chip
constexpr int REC = 24;          // int32 per candidate row
constexpr int HDR = 8;           // int32 header of the result buffer
constexpr int COMPACT_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// tally rows in shared memory, W int32 each
enum {
  T_SNV = 0, T_LOW = 4, T_FST = 8, T_PIR = 12,
  T_BQ = 16, T_BQL = 17, T_MQ = 18, T_MQL = 19, T_ROWS = 20
};
// header of the result buffer
enum { H_NMM = 0, H_K = 1, H_ERR = 2 };
// state of a mismatch event in dedup
enum : uint8_t { E_SHORT = 1, E_GROUPED = 2, E_SKIP = 4 };

struct Tile {
  const int32_t* span_read;
  const int32_t* span_ref;   // non-decreasing
  const int32_t* span_off;
  const int32_t* cum;        // [S + 1], cum[0] = 0
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
  const uint8_t* is_n;
  const uint8_t* gate;
  int L;
  int max_span;
  int min_mapq;
  int min_bq;
  int min_snv;
  int name_len_cap;
  float thr;
};

// per-window results that tile_compact reads
struct WinInfo {
  int count;   // candidate rows
  int n_mm;    // hi & mm events
  int err;     // spans out of order in the block's slice
  int pad;
};

struct Scratch {
  int* pool_top;        // zeroed before tile_window
  WinInfo* info;        // [nwin]
  int32_t* stage;       // [nwin * W * REC]
  int32_t* pool_span;   // [E]
  int32_t* pool_nid;    // [E]
  uint8_t* pool_state;  // [E]
};

// one window's mismatch list: shared memory, or its share of the pool
struct List {
  int32_t* span;
  int32_t* nid;
  uint8_t* state;
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

__device__ __forceinline__ int32_t wrap_add(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x + (uint32_t)y);
}

// First s in [0, S) with a[s] >= v (S if none), a non-decreasing; by one
// warp, 32 probes a round, so about log32(S) rounds of dependent loads.
__device__ int first_at_least(const int32_t* a, int S, int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = S;                  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long step = (long)(hi - lo) * (lane + 1) / 33;
    const int at = lo + (int)step;     // lo <= at < hi
    const unsigned below = __ballot_sync(FULL, a[at] < v);
    // probes are increasing, so ``below`` is a run of low bits
    const int nb = __popc(below);
    const int new_lo = nb ? lo + (int)((long)(hi - lo) * nb / 33) + 1 : lo;
    const int new_hi = nb < 32 ? lo + (int)((long)(hi - lo) * (nb + 1) / 33)
                               : hi;
    lo = new_lo;
    hi = new_hi;
  }
  const int at = lo + lane;
  const unsigned below = __ballot_sync(FULL, at < hi && a[at] < v);
  return lo + __popc(below);
}

// One event (a base of a span at window position pl): COLLECT tallies it
// unless it is hi & mm, which it counts and appends to the raw list;
// otherwise (a spilled window's second walk) only hi & mm events are
// placed, into their position's slot of ``lst``.
template <bool COLLECT>
__device__ __forceinline__ void event(
    const Tile& t, int s, int pl, int sb, int q, int rb, int ridx,
    bool mq_hi, int mq, bool fwd, int lsq, int nid, uint8_t shrt,
    int32_t* tl, int32_t* mcnt, int* nraw, int32_t* raw_span,
    uint16_t* raw_pl, const int32_t* moff, List lst) {
  const bool hq = mq_hi && q >= t.min_bq;
  if (hq && rb != sb) {
    if (COLLECT) {
      atomicAdd(&mcnt[pl], 1);
      const int r = atomicAdd(nraw, 1);
      if (r < CAP) {
        raw_span[r] = s;
        raw_pl[r] = (uint16_t)pl;
      }
    } else {
      const int slot = moff[pl] + atomicAdd(&mcnt[pl], 1);
      lst.span[slot] = s;
      lst.nid[slot] = nid;
      lst.state[slot] = shrt;
    }
    return;
  }
  if (!COLLECT) return;
  const int code = base_code(sb);
  if (code >= NT) return;
  if (hq) {
    atomicAdd(&tl[(T_SNV + code) * W + pl], 1);
    if (fwd) atomicAdd(&tl[(T_FST + code) * W + pl], 1);
    // pos_in_read: ridx when mm | fwd, else lseq - ridx (mm is false)
    atomicAdd(&tl[(T_PIR + code) * W + pl], fwd ? ridx : lsq - ridx);
    atomicAdd(&tl[T_BQ * W + pl], q);
    atomicAdd(&tl[T_MQ * W + pl], mq);
  } else {
    atomicAdd(&tl[(T_LOW + code) * W + pl], 1);
    atomicAdd(&tl[T_BQL * W + pl], q);
    atomicAdd(&tl[T_MQL * W + pl], mq);
  }
}

// Walk the window's spans. The warps take the spans in turn (warp w the
// spans s_lo + w + WARPS k), 32 of them a round: each lane looks up one
// span and its read (one round of loads for all 32), then the warp walks
// the spans that reach the window one after the other, 32 bases a step,
// with the bytes of up to UNROLL steps loaded before any is used
// (coalesced). COLLECT and the spilled second walk as in ``event``.
constexpr int UNROLL = 4;

template <bool COLLECT>
__device__ void walk(const Tile& t, int w0, int w1, int s_lo, int s_hi,
                     int32_t* tl, int32_t* mcnt, int* nraw,
                     int32_t* raw_span, uint16_t* raw_pl,
                     const int32_t* moff, List lst) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the warp's spans: s_lo + warp + WARPS * k, 32 of them a round
  for (int s0 = s_lo + warp; s0 < s_hi; s0 += WARPS * 32) {
    const int sm = s0 + WARPS * lane;
    int lo = 0, hi = 0, off = 0, base = 0, mq = 0, lsq = 0, nid = 0;
    bool fwd = false;
    uint8_t shrt = 0;
    if (sm < s_hi) {
      const int ref = t.span_ref[sm];
      lo = max(ref, w0);
      hi = min(ref + (t.cum[sm + 1] - t.cum[sm]), w1);
      if (lo < hi) {
        const int rid = t.span_read[sm];
        if (t.elig[rid] == 0) {
          hi = lo;
        } else {
          mq = t.mapq[rid];
          fwd = (t.flag[rid] & 16) == 0;
          lsq = t.lseq[rid];
          off = t.span_off[sm] - ref;        // ridx = off + p
          base = t.seq_off[rid] + off;       // flat = base + p
          if (!COLLECT) {
            nid = t.name_id[rid];
            shrt = t.name_len[rid] < t.name_len_cap ? E_SHORT : 0;
          }
        }
      }
    }
    unsigned live = __ballot_sync(FULL, lo < hi);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const int s = s0 + WARPS * src;
      const int slo = __shfl_sync(FULL, lo, src);
      const int shi = __shfl_sync(FULL, hi, src);
      const int soff = __shfl_sync(FULL, off, src);
      const int sbase = __shfl_sync(FULL, base, src);
      const int smq = __shfl_sync(FULL, mq, src);
      const bool sfwd = __shfl_sync(FULL, fwd, src);
      const int slsq = __shfl_sync(FULL, lsq, src);
      const int snid = __shfl_sync(FULL, nid, src);
      const uint8_t sshrt = (uint8_t)__shfl_sync(FULL, (int)shrt, src);
      const bool mq_hi = smq >= t.min_mapq;
      for (int p0 = slo + lane; p0 < shi; p0 += 32 * UNROLL) {
        int sb[UNROLL], q[UNROLL], rb[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int p = p0 + 32 * u;
          if (p < shi) {
            sb[u] = __ldg(t.seq + sbase + p);
            q[u] = __ldg(t.qual + sbase + p);
            rb[u] = __ldg(t.chrom_up + p);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int p = p0 + 32 * u;
          if (p < shi)
            event<COLLECT>(t, s, p - w0, sb[u], q[u], rb[u], soff + p,
                           mq_hi, smq, sfwd, slsq, snid, sshrt, tl, mcnt,
                           nraw, raw_span, raw_pl, moff, lst);
        }
      }
    }
  }
}

// exclusive prefix of v over the block (one value a thread); *total gets
// the sum. ``wsum`` holds WARPS ints.
__device__ int block_exclusive_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) wsum[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const int before = (warp ? wsum[warp - 1] : 0) + x - v;
  *total = wsum[WARPS - 1];
  __syncthreads();
  return before;
}

constexpr size_t SMEM_BYTES =
    sizeof(int32_t) * (T_ROWS * W + W + (W + 1) + 3 * CAP)
    + sizeof(uint16_t) * CAP + sizeof(uint8_t) * CAP;

__global__ void __launch_bounds__(THREADS, 2)
tile_window(Tile t, Scratch sc, int32_t* base_tot) {
  extern __shared__ int32_t smem[];
  int32_t* tl = smem;                         // [T_ROWS * W]
  int32_t* mcnt = tl + T_ROWS * W;            // [W] mismatch count / fill
  int32_t* moff = mcnt + W;                   // [W + 1] exclusive prefix
  int32_t* raw_span = moff + W + 1;           // [CAP] arrival list
  int32_t* c_span = raw_span + CAP;           // [CAP] per-position list
  int32_t* c_nid = c_span + CAP;              // [CAP]
  uint16_t* raw_pl = (uint16_t*)(c_nid + CAP);  // [CAP]
  uint8_t* c_state = (uint8_t*)(raw_pl + CAP);  // [CAP]
  __shared__ int nraw, s_lo, s_hi, pool_base;
  __shared__ int wsum[WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int w0 = b * W;
  const int w1 = min(w0 + W, t.L);
  const int nw = w1 - w0;

  for (int i = tid; i < T_ROWS * W; i += THREADS) tl[i] = 0;
  for (int i = tid; i < W; i += THREADS) mcnt[i] = 0;
  if (tid == 0) nraw = 0;
  // a span reaches the window iff ref < w1 and ref + len > w0; with
  // len <= max_span the second needs ref > w0 - max_span
  if (tid < 32) {
    const int v = first_at_least(t.span_ref, t.S, w0 - t.max_span + 1);
    if (tid == 0) s_lo = v;
  } else if (tid < 64) {
    const int v = first_at_least(t.span_ref, t.S, w1);
    if (tid == 32) s_hi = v;
  }
  // the spans must be sorted by start: each block checks its slice
  int bad = 0;
  {
    const int chunk = (t.S + gridDim.x - 1) / gridDim.x;
    const int a = b * chunk;
    const int e = min(a + chunk, t.S - 1);
    for (int s = a + tid; s < e; s += THREADS)
      bad |= t.span_ref[s] > t.span_ref[s + 1];
  }
  bad = __syncthreads_or(bad);

  // (1) tallies and the raw mismatch list
  walk<true>(t, w0, w1, s_lo, s_hi, tl, mcnt, &nraw, raw_span, raw_pl,
             nullptr, List{nullptr, nullptr, nullptr});
  __syncthreads();

  // (2) per-position offsets of the mismatch list
  int n;
  const int cnt_p = tid < W ? mcnt[tid] : 0;
  const int before = block_exclusive_scan(cnt_p, wsum, &n);
  if (tid < W) {
    moff[tid] = before;
    mcnt[tid] = 0;                 // from here: fill counters
  }
  if (tid == 0) moff[W] = n;
  __syncthreads();

  List lst{c_span, c_nid, c_state};
  if (n <= CAP) {
    for (int r = tid; r < n; r += THREADS) {
      const int pl = raw_pl[r];
      const int s = raw_span[r];
      const int slot = moff[pl] + atomicAdd(&mcnt[pl], 1);
      const int rid = t.span_read[s];
      c_span[slot] = s;
      c_nid[slot] = t.name_id[rid];
      c_state[slot] = t.name_len[rid] < t.name_len_cap ? E_SHORT : 0;
    }
  } else {
    // spill: this window's share of the pool, filled by a second walk
    if (tid == 0) pool_base = atomicAdd(sc.pool_top, n);
    __syncthreads();
    lst = List{sc.pool_span + pool_base, sc.pool_nid + pool_base,
               sc.pool_state + pool_base};
    walk<false>(t, w0, w1, s_lo, s_hi, tl, mcnt, &nraw, raw_span, raw_pl,
                moff, lst);
  }
  __syncthreads();

  // (3) dedup: one thread per position resolves its list
  for (int pl = tid; pl < nw; pl += THREADS) {
    const int a = moff[pl];
    const int e = moff[pl + 1];
    if (a == e) continue;
    for (int r = 0; r < t.min_snv; ++r) {
      // the earliest arrival of a short name not yet grouped
      int best = INT_MAX, bnid = 0;
      for (int i = a; i < e; ++i) {
        if ((lst.state[i] & (E_SHORT | E_GROUPED)) == E_SHORT &&
            lst.span[i] < best) {
          best = lst.span[i];
          bnid = lst.nid[i];
        }
      }
      if (best == INT_MAX) break;
      // a stored group: all its events but the first are skipped
      for (int i = a; i < e; ++i) {
        if ((lst.state[i] & E_SHORT) && lst.nid[i] == bnid)
          lst.state[i] |= E_GROUPED | (lst.span[i] != best ? E_SKIP : 0);
      }
    }
    const int p = w0 + pl;
    for (int i = a; i < e; ++i) {
      if (lst.state[i] & E_SKIP) continue;
      const int s = lst.span[i];
      const int rid = t.span_read[s];
      const int ridx = t.span_off[s] + p - t.span_ref[s];
      const int flat = t.seq_off[rid] + ridx;
      const int code = base_code(t.seq[flat]);
      if (code >= NT) continue;
      int32_t* c = tl + pl;
      c[(T_SNV + code) * W] = wrap_add(c[(T_SNV + code) * W], 1);
      if ((t.flag[rid] & 16) == 0)
        c[(T_FST + code) * W] = wrap_add(c[(T_FST + code) * W], 1);
      c[(T_PIR + code) * W] = wrap_add(c[(T_PIR + code) * W], ridx);  // mm
      c[T_BQ * W] = wrap_add(c[T_BQ * W], t.qual[flat]);
      c[T_MQ * W] = wrap_add(c[T_MQ * W], t.mapq[rid]);
    }
  }
  __syncthreads();

  // (4) base_tot, the screen, the block's candidate rows in order
  const int pl = tid;
  bool cand = false;
  int32_t total = 0, low = 0;
  if (pl < nw) {
    const int p = w0 + pl;
    int32_t snv[NT];
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      snv[c] = tl[(T_SNV + c) * W + pl];
      total = wrap_add(total, snv[c]);
      low = wrap_add(low, tl[(T_LOW + c) * W + pl]);
    }
    base_tot[p] = wrap_add(total, low);
    if (t.gate[p] > 0 && !t.is_n[p]) {
      const int ref_code = base_code(t.chrom_up[p]);
      const float tf = (float)total;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        // IEEE f32 division: 0/0 is NaN and fails the comparison
        const float ratio = (float)snv[c] / tf;
        if (c != ref_code && ratio >= t.thr && snv[c] >= t.min_snv)
          cand = true;
      }
    }
  }
  int n_c;
  const int idx = block_exclusive_scan(cand ? 1 : 0, wsum, &n_c);
  if (cand) {
    int32_t* r = sc.stage + ((size_t)b * W + idx) * REC;
    const int32_t* c = tl + pl;
    r[0] = w0 + pl;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      r[1 + k] = c[(T_SNV + k) * W];
      r[5 + k] = c[(T_LOW + k) * W];
      r[9 + k] = c[(T_PIR + k) * W];
      r[13 + k] = c[(T_FST + k) * W];
    }
    r[17] = c[T_BQ * W];
    r[18] = wrap_add(c[T_BQ * W], c[T_BQL * W]);
    r[19] = c[T_MQ * W];
    r[20] = wrap_add(c[T_MQ * W], c[T_MQL * W]);
    r[21] = total;                       // n_hi: every counted event
    r[22] = total;
    r[23] = wrap_add(total, low);        // n_hi + n_low
  }
  if (tid == 0) sc.info[b] = WinInfo{n_c, n, bad, 0};
}

__global__ void tile_compact(Scratch sc, int nwin, int32_t* res, int L) {
  __shared__ int part[COMPACT_THREADS / 32][3];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const bool last = b == nwin - 1;
  // candidates of the windows before b; the last block also sums the
  // mismatch events and ORs the order errors of all windows
  int cnt = 0, nmm = 0, err = 0;
  for (int i = tid; i < (last ? nwin : b); i += COMPACT_THREADS) {
    const WinInfo w = sc.info[i];
    if (i < b) cnt += w.count;
    nmm += w.n_mm;
    err |= w.err;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(FULL, cnt, o);
    nmm += __shfl_xor_sync(FULL, nmm, o);
    err |= __shfl_xor_sync(FULL, err, o);
  }
  if ((tid & 31) == 0) {
    part[tid >> 5][0] = cnt;
    part[tid >> 5][1] = nmm;
    part[tid >> 5][2] = err;
  }
  __syncthreads();
  int prefix = 0;
  nmm = err = 0;
  for (int w = 0; w < COMPACT_THREADS / 32; ++w) {
    prefix += part[w][0];
    nmm += part[w][1];
    err |= part[w][2];
  }
  const int mine = sc.info[b].count;
  const int32_t* src = sc.stage + (size_t)b * W * REC;
  int32_t* dst = res + HDR + L + (size_t)prefix * REC;
  for (int i = tid; i < mine * REC; i += COMPACT_THREADS) dst[i] = src[i];
  if (last && tid == 0) {
    res[H_NMM] = nmm;
    res[H_K] = prefix + mine;
    res[H_ERR] = err;
  }
}

// Optional CUDA events between launches, for timing the passes.
class Marks {
 public:
  Marks(bool on, int n, cudaStream_t s)
      : n_(on ? n : 0), s_(s), ev_(n_ ? new cudaEvent_t[n_] : nullptr) {
    for (int i = 0; i < n_; ++i) cudaEventCreate(&ev_[i]);
  }
  ~Marks() {
    for (int i = 0; i < n_; ++i) cudaEventDestroy(ev_[i]);
    delete[] ev_;
  }
  void mark(int i) {
    if (i < n_) cudaEventRecord(ev_[i], s_);
  }
  // milliseconds from mark a to mark b (waits for b)
  float ms(int a, int b) {
    float t = 0.0f;
    cudaEventSynchronize(ev_[b]);
    cudaEventElapsedTime(&t, ev_[a], ev_[b]);
    return t;
  }
  cudaError_t error() const { return cudaGetLastError(); }

 private:
  int n_;
  cudaStream_t s_;
  cudaEvent_t* ev_;
};

inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

int num_windows(int L) { return (L + W - 1) / W; }

Scratch carve(void* scratch, int L, long E) {
  const int nwin = num_windows(L);
  char* p = (char*)scratch;
  Scratch sc;
  sc.pool_top = (int*)p;
  p += 256;
  sc.info = (WinInfo*)p;
  p += align256(sizeof(WinInfo) * nwin);
  sc.stage = (int32_t*)p;
  p += align256(sizeof(int32_t) * (size_t)nwin * W * REC);
  sc.pool_span = (int32_t*)p;
  p += align256(sizeof(int32_t) * (size_t)E);
  sc.pool_nid = (int32_t*)p;
  p += align256(sizeof(int32_t) * (size_t)E);
  sc.pool_state = (uint8_t*)p;
  return sc;
}

}  // namespace

extern "C" {

const char* gt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Bytes of the scratch ``gt_tile_accumulate`` needs for a tile of L
// positions and E aligned bases.
long gt_tile_scratch_bytes(int L, long E) {
  const int nwin = num_windows(L);
  return (long)(256 + align256(sizeof(WinInfo) * nwin)
                + align256(sizeof(int32_t) * (size_t)nwin * W * REC)
                + 2 * align256(sizeof(int32_t) * (size_t)E)
                + align256((size_t)E));
}

// Int32 entries of the result buffer for L positions: the header, base_tot
// and room for a candidate row at every position.
long gt_tile_result_len(int L) { return HDR + (long)L * (1 + REC); }

// The whole tile on ``stream``: res = [header (HDR) | base_tot (L) |
// K candidate rows of REC]. Spans must be sorted by span_ref (header
// H_ERR is set otherwise); E = cum[S]; max_span >= every span's length.
// With ``pass_ms`` (float [2], else null) the call also times its two
// passes with CUDA events and waits for them.
int gt_tile_accumulate(void* span_read, void* span_ref, void* span_off,
                       void* cum, int S, void* elig, void* mapq, void* flag,
                       void* lseq, void* seq_off, void* name_id,
                       void* name_len, void* seq, void* qual, void* chrom_up,
                       void* is_n, void* gate, int L, long E, int max_span,
                       int min_mapq, int min_bq, int min_snv,
                       int name_len_cap, float thr, void* scratch, void* res,
                       float* pass_ms, void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
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
  t.is_n = (const uint8_t*)is_n;
  t.gate = (const uint8_t*)gate;
  t.L = L;
  t.max_span = max_span;
  t.min_mapq = min_mapq;
  t.min_bq = min_bq;
  t.min_snv = min_snv;
  t.name_len_cap = name_len_cap;
  t.thr = thr;
  cudaStream_t s = (cudaStream_t)stream;
  const Scratch sc = carve(scratch, L, E);
  const int nwin = num_windows(L);
  cudaError_t e = cudaFuncSetAttribute(
      tile_window, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(sc.pool_top, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  Marks ev(pass_ms != nullptr, 3, s);
  ev.mark(0);
  tile_window<<<nwin, THREADS, SMEM_BYTES, s>>>(t, sc, (int32_t*)res + HDR);
  ev.mark(1);
  tile_compact<<<nwin, COMPACT_THREADS, 0, s>>>(sc, nwin, (int32_t*)res, L);
  ev.mark(2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (pass_ms) {
    pass_ms[0] = ev.ms(0, 1);
    pass_ms[1] = ev.ms(1, 2);
  }
  return (int)ev.error();
}

}  // extern "C"
