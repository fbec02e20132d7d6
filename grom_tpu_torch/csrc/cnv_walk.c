// The outer window walk of the device CNV stage (ops/cnv_device.py
// window_scan), in plain host C: the reference's walk over a block's bases
// (src/GROM.c:19358-19380) with the per-seed window math taken from
// seed_eval's outcomes.
//
// The walk keeps the sticky outer class (mq_index: set by every definite
// base it stands on) and a cursor into the block's ascending candidates
// (the positions that pass either class's seed threshold). Only a
// candidate can start a window, so the walk goes from candidate to
// candidate and reads back from each to the last definite base it passed
// over: that base sets the class, as a step over every base would. The
// cursor moves forward with the position, by a binary search after a jump.
//
// gw_walk runs until one of three events and returns it:
//   GW_BATCH: the candidate the walk stands on (ci) has no outcome in the
//             current batch of its outer class (cls); the caller evaluates
//             a batch from ci in that class, sets lo/hi/res[cls] and calls
//             again;
//   GW_CALL:  the window of the seed at pos (candidate ci, class cls)
//             begins a call; the caller runs the slide and trim phases and
//             calls again with pos past the call;
//   GW_DONE:  the walk reached be.
// A seed that fails inside its first window (f1 < minw) jumps f1 + 1; any
// other seed that begins no call steps one base: both stay in here.
//
// Built with cc by grom_tpu_torch/_build.py (HOST_LIBRARIES), loaded with
// ctypes; mirrored by ops/cnv_device.py _Walk.

#include <stdint.h>

enum { F_SOK0 = 2, F_SOK1 = 4, F_DEF = 32, F_CLS1 = 64 };
enum { GW_DONE = 0, GW_BATCH = 1, GW_CALL = 2 };

typedef struct {
    int64_t pos;          // where the walk stands
    int64_t be;           // the block's end (exclusive)
    int64_t ci;           // cursor: index in cand of the first candidate >= pos
    int64_t bases;        // positions the walk stood on
    int64_t lo[2], hi[2]; // each class's batch: candidates [lo, hi) ...
    const int64_t *res[2];  // ... and their outcomes, int64 [5, hi - lo]
    int32_t mq_index;     // the sticky outer class
    int32_t cls;          // GW_BATCH / GW_CALL: the class of candidate ci
} gw_walk_t;

// first index in [lo, hi) whose candidate is >= x (hi if none)
static int64_t lower_bound(const int32_t *cand, int64_t lo, int64_t hi,
                           int64_t x)
{
    while (lo < hi) {
        int64_t mid = lo + (hi - lo) / 2;
        if (cand[mid] < x)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

int gw_walk(const uint8_t *flags, const int32_t *cand, int64_t ncand,
            int64_t minw, gw_walk_t *w)
{
    int64_t pos = w->pos, ci = w->ci, bases = w->bases;
    const int64_t be = w->be;
    int mqi = w->mq_index;
    int ev = GW_DONE;

    while (pos < be) {
        if (ci < ncand && cand[ci] < pos)
            ci = lower_bound(cand, ci + 1, ncand, pos);
        if (ci == ncand) {
            // no candidate left: the bases up to be set no window
            bases += be - pos;
            pos = be;
            break;
        }
        const int64_t c = cand[ci];
        for (int64_t q = c; q >= pos; q--)
            if (flags[q] & F_DEF) {
                mqi = (flags[q] & F_CLS1) != 0;
                break;
            }
        bases += c - pos;
        pos = c;
        if (!(flags[c] & (mqi ? F_SOK1 : F_SOK0))) {
            bases++;
            pos = c + 1;
            ci++;
            continue;
        }
        if (ci < w->lo[mqi] || ci >= w->hi[mqi]) {
            ev = GW_BATCH;
            break;
        }
        const int64_t ns = w->hi[mqi] - w->lo[mqi], k = ci - w->lo[mqi];
        const int64_t f1 = w->res[mqi][k], begin = w->res[mqi][ns + k];
        bases++;
        if (f1 < minw) {
            pos = c + f1 + 1;
        } else if (begin) {
            ev = GW_CALL;
            break;
        } else {
            pos = c + 1;
            ci++;
        }
    }
    w->pos = pos;
    w->ci = ci;
    w->bases = bases;
    w->mq_index = mqi;
    w->cls = mqi;
    return ev;
}
