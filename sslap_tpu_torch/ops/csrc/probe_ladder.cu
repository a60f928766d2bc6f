// P16-P17: K3 rebuilt in stages, on one unified int32 state table or on
// three tables (sm_90a).
//
// Replaces benchmarks/probe_mosaic_gs.py::_gs_ladder_uni (:838) and
// ::_gs_ladder (:997).  Per bid, until the ring is empty or max_bids:
//   stage 1: u = queue[head]; j = cols[u, 0], v0 = vals[u, 0] + 0, pk =
//            prices[j] + 0; acc = (acc + pk) + v0
//   stage 2: + prices[j] = pk + 0.5, owner[j] = u
//   stage 3: + prev = owner[j] read first, pushed at the tail if >= 0
// and it writes (bids, rows left) and acc.  acc is the stage's only use of
// the loads in stage 1; without it as an output the compiler could delete
// them and the stage's time would mean nothing.  The +0 on price and value
// reads give the TPU kernel's one-hot read bits (-0.0 -> +0.0).
//
// The unified table keeps the price column as int32 bits in one state
// table (rows queue | price bits | owner, each `width` wide); P17 keeps
// three tables, prices f32.  The TPU needed the unified table because its
// second and third aliased VMEM tables read zeros; on the GPU both layouts
// are flat global arrays, and both run one kernel (lookahead_kernel), which
// reads and writes the price column as int32 bits through a pointer to the
// price table's first entry: a gather lane loads single entries, so neither
// layout needs a gather of its own.
//
// Bound on an H100: the bytes (20 a bid plus the tables written) are
// nothing; the float32 chain (two dependent adds a bid, in bid order) is
// the function's floor, ~4 ns a bid.  What costs is latency: a bid is the
// dependent chain queue slot -> row's first entry -> price (-> owner ->
// stores), three to four global round trips.
//
// lookahead_kernel takes the chain off the critical path.
// One block: warp 0 commits, G gather warps read ahead.
//   Gather lanes.  Lane g of the G x 32 takes ring positions g, g + 32 G,
//   ...  A FIFO slot is final once written (positions below the published
//   tail), and rows are immutable, so a lane reads ahead of the head: once
//   pos < tail and pos - count < S (its shared slot is free; S = 64 G) it
//   claims slot pos mod S, takes the commit count c0 it read (behind an
//   acquire fence: every commit before c0 is visible), loads u =
//   queue[pos], then cols[u K] and vals[u K], then the price (and at stage
//   3 the owner) of that column, and publishes them tagged pos (release).
//   With 32 G bids in flight, the chain's latency is hidden.
//   The commit warp, the only writer of the tables, takes positions in
//   ring order, up to 32 a pass: lane i takes position t + i if its slot
//   is filled, and the pass is the run of filled slots from t.  A slot is
//   stale exactly when a commit in [c0, t + i) wrote its column.  Commits
//   before the pass stamp their index at hash(j) in a shared table of
//   kStamps entries (as K3 does), with the column and the price and owner
//   they stored; a stamp >= c0 takes those values when the entry names j
//   (the last commit on the hash is then the last on j), else re-reads
//   the tables (a hash collision costs a re-read, never a wrong result).
//   The pass ends before the first slot whose column an earlier slot of
//   the pass takes (__match_any_sync), so no slot depends on the pass's
//   own stores.  Then the float chain runs over the pass in bid order (the
//   one serial part: two adds a bid), each lane stores its column's price
//   and owner and pushes its evicted row at the tail (ballot + popc), and
//   one release fence per pass orders the stores before the published
//   tail and count.  A slot no lane has filled is read by lane 0 itself, a
//   pass of one, when no lane has claimed it or when it was pushed at most
//   kFresh commits ago (in a short ring a lane's whole chain would still
//   be ahead of it); the row of a recent push comes from a small shared
//   ring of them, the price and owner from the stamp table when it names
//   the column.  While the ring holds kShortRing rows or fewer, lane 0
//   runs the bids one by one in that way (a pass has a fixed cost of
//   ~1,000 cycles, see below) and nothing is published (no fence): the
//   lanes could not run ahead of it there.
//   Waiting gather lanes sleep briefly between polls.
// Measured on an H100 (700 W; PERF.md) at n = m = 1M, K = 10: P16 16.4 /
// 31.5 / 32.3 ns a bid at stages 1-3 (G = 4), against 466 / 464 / 483 for
// the one-thread kernel P16 and P17 had before; a pass of 32 costs ~1,000
// cycles at stage 1 and ~2,000 with stores (the release fence).  On a ring
// of two rows (every bid on one column) 299 ns a bid, the one-thread
// kernel 291.
// Wait loops trap after 10 s with no progress (sync.cuh).
#include "common.cuh"
#include "sync.cuh"

namespace {

constexpr int kMaxGather = 8;                // gather warps at most
constexpr int kStampBits = 12;               // as K3's (gs.cu)
constexpr int kStamps = 1 << kStampBits;
constexpr int kRecent = 64;                  // pushes the commit warp keeps
constexpr int kFresh = 32;                   // a push younger (in commits)
                                             // is read by the commit warp
constexpr int kShortRing = 32;               // rings this short: no publish
constexpr unsigned kFull = 0xFFFFFFFFu;

// One look-ahead result, in shared memory; one lane writes slot s (ring
// positions = s mod S), the commit warp reads it.
struct Slot {
  long long tag;                   // position, written last (release)
  long long claim;                 // position the lane is reading
  long long c0;                    // commits the lane's reads saw at least
  int32_t u, j, pbits, own;
  float v;
};

// The last commit on a stamp hash: its index, column and what it stored.
struct Stamp {
  int32_t t, j, pbits, own;
};

// Published by the commit warp (after a release fence), read by lanes.
struct Ctl {
  long long count;                 // bids committed
  long long tail;                  // absolute ring tail
  int stop;
};

// Gather lane g: positions g, g + 32 G, ... (see the header).
template <int STAGE>
__device__ __forceinline__ void gather(const int32_t* __restrict__ cols,
                                       const float* __restrict__ vals,
                                       int32_t K, int32_t* q, int32_t* pbits,
                                       int32_t* owner, long long max_bids,
                                       long long cap, int G, Slot* slots,
                                       Ctl* ctl, int g) {
  const int L = 32 * G, S = 2 * L;
  long long pos = g;
  int s = g;
  while (pos < max_bids) {
    long long c, T, seen = -1;
    sslap::Watchdog dog;
    for (;;) {
      c = sslap::ld_rlx(&ctl->count);
      T = sslap::ld_rlx(&ctl->tail);
      if (sslap::ld_rlx(&ctl->stop)) return;
      if (c > pos || (pos < T && pos - c < S)) break;
      if (c != seen) {
        seen = c;
        dog = sslap::Watchdog();
      }
      dog.tick();
      __nanosleep(32);             // leave the issue slots to the commit warp
    }
    if (c <= pos) {                  // not passed yet
      // every commit before c is visible to the loads below
      cuda::atomic_thread_fence(cuda::memory_order_acquire,
                                cuda::thread_scope_block);
      Slot* sl = slots + s;
      sslap::st_rlx(&sl->claim, pos);
      const int32_t u = sslap::ld_rlx(q + pos % cap);
      const long long at = static_cast<long long>(u) * K;
      const int32_t j = __ldg(cols + at);
      const float v = __ldg(vals + at);
      const int32_t pb = sslap::ld_rlx(pbits + j);
      const int32_t own = STAGE >= 3 ? sslap::ld_rlx(owner + j) : -1;
      sl->c0 = c;
      sl->u = u;
      sl->j = j;
      sl->v = v;
      sl->pbits = pb;
      sl->own = own;
      sslap::st_rel(&sl->tag, pos);
    }
    pos += L;
    s = s + L >= S ? s + L - S : s + L;
  }
}

// One block of 32 (G + 1) threads: warp 0 commits, warps 1..G gather.
// `pbits` is the price table as int32 bits (either layout); counters (or
// null): bids taken from a lane's slot, of those re-read as stale, bids the
// commit warp read itself, passes (publishes), and the commit warp's clock64
// cycles waiting for a lane's slot and in all.
template <int STAGE>
__global__ void lookahead_kernel(const int32_t* __restrict__ cols,
                                 const float* __restrict__ vals, int32_t K,
                                 int32_t* q, int32_t* pbits, int32_t* owner,
                                 long long qcount, long long max_bids,
                                 long long cap, int G, int32_t* stats,
                                 float* acc_out, long long* counters) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stamp* stamps = reinterpret_cast<Stamp*>(smem);          // [kStamps]
  Slot* slots = reinterpret_cast<Slot*>(stamps + kStamps);  // [S]
  __shared__ int32_t recent[kRecent];       // the row pushed at position p
  __shared__ long long pushed_at[kRecent];  // and the commit that pushed it
  __shared__ Ctl ctl;
  const int S = 64 * G;
  for (int i = threadIdx.x; i < kStamps; i += blockDim.x)
    stamps[i] = Stamp{-1, -1, 0, -1};
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    slots[i].tag = -1;
    slots[i].claim = -1;
  }
  if (threadIdx.x == 0) {
    ctl.count = 0;
    ctl.tail = qcount;
    ctl.stop = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp > 0) {
    gather<STAGE>(cols, vals, K, q, pbits, owner, max_bids, cap, G, slots,
                  &ctl, threadIdx.x - 32);
    return;
  }
  // warp 0 commits; lane i looks at position t + i of each pass
  const unsigned below = (1u << lane) - 1u;
  long long t = 0, T = qcount, h = 0, tq = qcount;  // h, tq: t, T mod cap
  long long from_lane = 0, stale = 0, self = 0, passes = 0;
  long long cyc_wait = 0;                           // clock64: waiting
  const long long cyc0 = clock64();
  float acc = 0.0f;
  int s = 0;                                        // t mod S
  while (t != T && t < max_bids) {
    int si = s + lane;
    if (si >= S) si -= S;
    const unsigned run = __ballot_sync(
        kFull, sslap::ld_rlx(&slots[si].tag) == t + lane);
    int k = run == kFull ? 32 : __ffs(~run) - 1;  // leading filled slots
    int32_t u = 0, j = 0, pb = 0, own = -1;
    float v = 0.0f;
    if (k == 0) {
      // t pushed kFresh commits ago or less (a short ring): the commit
      // warp reads it, since a lane that claimed it has its whole chain to
      // run; else it waits for a lane that holds t
      const bool held = t >= qcount && T - t <= kRecent;
      int wait = 0;
      if (lane == 0)
        wait = !(held && t - pushed_at[t & (kRecent - 1)] <= kFresh) &&
               sslap::ld_rlx(&slots[s].claim) == t;
      if (__shfl_sync(kFull, wait, 0)) {
        if (lane == 0) {
          const long long c = clock64();
          sslap::Watchdog dog;
          while (sslap::ld_rlx(&slots[s].tag) != t) dog.tick();
          cyc_wait += clock64() - c;
        }
        __syncwarp();
        continue;
      }
      if (T - t <= kShortRing) {
        // a short ring: lane 0 runs the bids one by one while it stays
        // short (no scan, no pass, no publish; the lanes cannot help)
        if (lane == 0) {
          while (t != T && t < max_bids && T - t <= kShortRing) {
            const int32_t ur = t >= qcount ? recent[t & (kRecent - 1)]
                                           : sslap::ld_rlx(q + h);
            const long long at = static_cast<long long>(ur) * K;
            const int32_t jr = __ldg(cols + at);
            const float vr = __ldg(vals + at);
            const Stamp e = stamps[jr & (kStamps - 1)];
            int32_t pr, orr = -1;
            if (e.j == jr) {        // the last commit on j: what it stored
              pr = e.pbits;
              orr = e.own;
            } else {
              pr = sslap::ld_rlx(pbits + jr);
              if (STAGE >= 3) orr = sslap::ld_rlx(owner + jr);
            }
            const float pk = __int_as_float(pr) + 0.0f;
            acc = (acc + pk) + (vr + 0.0f);
            if (STAGE >= 3 && orr >= 0) {
              sslap::st_rlx(q + tq, orr);
              recent[T & (kRecent - 1)] = orr;
              pushed_at[T & (kRecent - 1)] = t;
              tq = tq + 1 == cap ? 0 : tq + 1;
              ++T;
            }
            if (STAGE >= 2) {
              const int32_t bits = __float_as_int(pk + 0.5f);
              sslap::st_rlx(pbits + jr, bits);
              sslap::st_rlx(owner + jr, ur);
              stamps[jr & (kStamps - 1)] =
                  Stamp{static_cast<int32_t>(t), jr, bits, ur};
            }
            ++t;
            ++self;
            h = h + 1 == cap ? 0 : h + 1;
            s = s + 1 == S ? 0 : s + 1;
          }
        }
        t = __shfl_sync(kFull, t, 0);      // lane 0's state to the warp
        T = __shfl_sync(kFull, T, 0);
        h = __shfl_sync(kFull, h, 0);
        tq = __shfl_sync(kFull, tq, 0);
        s = __shfl_sync(kFull, s, 0);
        self = __shfl_sync(kFull, self, 0);
        acc = __shfl_sync(kFull, acc, 0);
        __syncwarp();
        continue;
      }
      // lane 0 reads t
      if (lane == 0) {
        u = held ? recent[t & (kRecent - 1)] : sslap::ld_rlx(q + h);
        const long long at = static_cast<long long>(u) * K;
        j = __ldg(cols + at);
        v = __ldg(vals + at);
        const Stamp e = stamps[j & (kStamps - 1)];
        if (e.j == j) {             // the last commit on j: what it stored
          pb = e.pbits;
          own = e.own;
        } else {
          pb = sslap::ld_rlx(pbits + j);
          if (STAGE >= 3) own = sslap::ld_rlx(owner + j);
        }
      }
      k = 1;
      ++self;
    } else {
      // the tags were read relaxed; this fence makes them acquire
      cuda::atomic_thread_fence(cuda::memory_order_acquire,
                                cuda::thread_scope_block);
      long long c0 = 0;
      if (lane < k) {
        const Slot* sl = slots + si;
        u = sl->u;
        j = sl->j;
        v = sl->v;
        pb = sl->pbits;
        own = sl->own;
        c0 = sl->c0;
      }
      bool redo = false;
      if (STAGE >= 2) {
        // the pass ends before the first slot whose column an earlier
        // slot of the pass writes: that slot reads what this pass stores
        const unsigned same = __match_any_sync(kFull, lane < k ? j : -1 - lane);
        const unsigned dup = __ballot_sync(kFull, lane < k && (same & below));
        if (dup) k = __ffs(dup) - 1;
        // a stamp in [c0, t), modulo 2**32 (one from 2**31 commits before
        // c0 reads as a conflict, never the other way): a commit before
        // this pass wrote the column after the lane read it.  Its entry
        // holds what the last commit on j stored, if it names j; else (a
        // hash collision) the tables are read again
        const Stamp e = stamps[lane < k ? j & (kStamps - 1) : 0];
        redo = lane < k && static_cast<int32_t>(
                               static_cast<uint32_t>(e.t) -
                               static_cast<uint32_t>(c0)) >= 0;
        if (redo && e.j == j) {
          pb = e.pbits;
          own = e.own;
        } else if (redo) {
          pb = sslap::ld_rlx(pbits + j);
          if (STAGE >= 3) own = sslap::ld_rlx(owner + j);
        }
      }
      stale += __popc(__ballot_sync(kFull, redo));
      from_lane += k;
    }
    // the pass: positions t .. t + k - 1, lane i holding t + i
    const bool act = lane < k;
    const float pk = __int_as_float(pb) + 0.0f;
    const float v0 = v + 0.0f;
    // the bid order; unrolled so the shuffles run ahead of the adds
    if (k == 1) {
      acc = (acc + __shfl_sync(kFull, pk, 0)) + __shfl_sync(kFull, v0, 0);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float a = __shfl_sync(kFull, pk, i);
        const float b = __shfl_sync(kFull, v0, i);
        if (i < k) acc = (acc + a) + b;
      }
    }
    if (STAGE >= 3) {
      const bool push = act && own >= 0;
      const unsigned pushes = __ballot_sync(kFull, push);
      if (push) {
        const int off = __popc(pushes & below);
        long long at = tq + off;
        if (at >= cap) at -= cap;
        sslap::st_rlx(q + at, own);
        recent[(T + off) & (kRecent - 1)] = own;
        pushed_at[(T + off) & (kRecent - 1)] = t + lane;
      }
      const int np = __popc(pushes);
      T += np;
      tq += np;
      if (tq >= cap) tq -= cap;
    }
    if (STAGE >= 2) {
      if (act) {
        sslap::st_rlx(pbits + j, __float_as_int(pk + 0.5f));
        sslap::st_rlx(owner + j, u);
      }
      // the pass's last lane on each stamp hash stamps it
      const int hj = act ? (j & (kStamps - 1)) : -1 - lane;
      const unsigned same = __match_any_sync(kFull, hj);
      if (act && (same >> lane) == 1u)
        stamps[hj] = Stamp{static_cast<int32_t>(t + lane), j,
                           __float_as_int(pk + 0.5f), u};
    }
    t += k;
    h += k;                       // k <= the ring's length < cap
    if (h >= cap) h -= cap;
    s += k;
    if (s >= S) s -= S;
    ++passes;
    __syncwarp();                 // every lane's stores before the publish
    // a ring too short for the lanes to run ahead: no publish (and no
    // fence); lane 0 reads what no lane has filled
    if (lane == 0 && T - t > kShortRing) {
      // one release fence orders the pass's stores (and its reads of the
      // slots) before the tail and count the lanes read
      cuda::atomic_thread_fence(cuda::memory_order_release,
                                cuda::thread_scope_block);
      sslap::st_rlx(&ctl.tail, T);
      sslap::st_rlx(&ctl.count, t);
    }
  }
  if (lane != 0) return;
  sslap::st_rel(&ctl.stop, 1);
  stats[0] = static_cast<int32_t>(t);
  stats[1] = static_cast<int32_t>(T - t);
  acc_out[0] = acc;
  if (counters != nullptr) {
    counters[0] = from_lane;
    counters[1] = stale;
    counters[2] = self;
    counters[3] = passes;
    counters[4] = cyc_wait;
    counters[5] = clock64() - cyc0;
  }
}

template <int STAGE>
cudaError_t launch(const int32_t* clines, const float* vlines, int32_t K,
                   int32_t* q, int32_t* pbits, int32_t* owner, int64_t qcount,
                   int64_t max_bids, int64_t cap, int gather_warps,
                   int32_t* stats, float* acc, long long* counters,
                   cudaStream_t stream) {
  if (gather_warps < 1 || gather_warps > kMaxGather)
    return cudaErrorInvalidValue;
  const int smem = kStamps * sizeof(Stamp) + 64 * gather_warps * sizeof(Slot);
  static bool opted_in = false;               // above 48 KB, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        lookahead_kernel<STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStamps * static_cast<int>(sizeof(Stamp)) +
            64 * kMaxGather * static_cast<int>(sizeof(Slot)));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  lookahead_kernel<STAGE><<<1, 32 * (1 + gather_warps), smem, stream>>>(
      clines, vlines, K, q, pbits, owner, qcount, max_bids, cap, gather_warps,
      stats, acc, counters);
  return cudaGetLastError();
}

}  // namespace

// P16 and P17: the look-ahead kernel with `gather_warps` gather warps on
// the queue, the price table as int32 bits and the owner table; `counters`
// int64[6] or null.
extern "C" int sslap_probe_ladder(int stage, const int32_t* clines,
                                  const float* vlines, int32_t K, int32_t* q,
                                  int32_t* pbits, int32_t* owner,
                                  int64_t qcount, int64_t max_bids,
                                  int64_t cap, int gather_warps,
                                  int32_t* stats, float* acc,
                                  long long* counters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define SSLAP_LADDER(S)                                                    \
  launch<S>(clines, vlines, K, q, pbits, owner, qcount, max_bids, cap,     \
            gather_warps, stats, acc, counters, st)
  cudaError_t err = cudaErrorInvalidValue;
  if (stage == 1) err = SSLAP_LADDER(1);
  if (stage == 2) err = SSLAP_LADDER(2);
  if (stage == 3) err = SSLAP_LADDER(3);
#undef SSLAP_LADDER
  return static_cast<int>(err);
}
