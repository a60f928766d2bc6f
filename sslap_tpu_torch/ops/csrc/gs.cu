// K3: serial FIFO Gauss-Seidel auction (sm_90a).
//
// Replaces sslap_tpu/ops/gs_kernel.py::_gs_kernel (the Pallas kernel behind
// gs_auction_device), with the bid semantics of the native auction_gs
// (sslap_tpu/native/sslap_native.cpp), its oracle.  Per bid t:
//   u      = queue[head], head = (head + 1) mod cap
//   w_k    = (vals[u,k]+0) - (prices[cols[u,k]]+0) where vals[u,k] >
//            real_min, else neg                     (the +0 mirror the TPU
//            kernel's one-hot reads, which turn -0.0 into +0.0)
//   v1     = max_k w_k at the lowest slot reaching it; v2 = max of the
//            rest; v2 = v1 - bigp unless v2 > neg * 0.5
//   bid    = (a* - v2) + eps on j* = cols[u, slot]; the previous owner of
//            j* is pushed at the tail; prices[j*] = bid, owner[j*] = u.
// It stops when the ring is empty or after max_bids bids, and writes
// (bids, rows left in the ring) and the counters below.  Padding is the
// port's neg sentinel (real_min = half of it), not the TPU kernel's "vals <=
// -bigp", which misreads real entries of min problems whose costs are all
// >= 1.  The reference's bisect stubs are kept as SCAN: kConst bids
// (prices[cols[u,0]] + 0) + eps on the row's first slot, kNoPrices reads
// every price as 0.
//
// Bound on an H100: latency.  A bid is a chain of dependent accesses (queue
// slot, the row's cols/vals, the prices at those columns, the owner of the
// winner) with nothing else on the card to hide it.  The design does two
// things about it.
//
// A. A shorter chain.  Price and owner live in one 8-byte entry of a packed
// [m] table (filled from prices/owner by pack_kernel before the run and
// split back by unpack_kernel after it), so each lane's gather brings the
// owner of its column along with the price: owner[j*] is known the moment
// the merge picks j*.  The lane merge runs ceil(log2(min(K, 32))) levels,
// not 5.  The next row is in flight before this bid's stores: when the
// ring holds more rows, the row of t + 1 is loaded (and the queue entry of
// t + 2 read) as bid t starts, since ring entries before the tail are
// final and rows are immutable; at a ring of one row the evicted owner's
// row is loaded as soon as the merge names it.
//
// B. Look-ahead (bid_warps W > 0).  One CTA: warp 0 commits, warps 1..W bid
// ahead.  Bid warp i takes ring positions t = i, i + W, ...; it starts t
// once t < tail and t - (commits) <= W as the commit warp last published
// them (ring entries before the tail are final), takes the commit count
// c0 it read (the warp's minimum over its lanes, behind an acquire fence),
// computes the bid of queue[t] against the packed table as part A does
// (the row of t + W, once final, is read ahead while it bids), and
// publishes (u, j*, bid, prev, c0) and the row's real columns in
// shared-memory slot t mod 2W, tagged t (release).  The commit warp takes positions strictly in ring
// order.  At a ring of one row it bids itself (the chain is serial there).
// Otherwise it waits for slot t and checks whether a commit in [c0, t) wrote
// one of the row's columns: each commit stamps its index at hash(j*) in a
// shared table of kStamps entries, so a stamp >= c0 on a hash of the row
// means a possible conflict (a false one only costs a redo).  No conflict:
// every value the bid read is the one the serial kernel reads at t, so the
// result is committed with stores only.  A conflict: the commit warp redoes
// the bid.  After its stores it publishes (tail, commit count) behind one
// release fence.  A bid warp's loads of the tables the kernel writes (packed,
// queue) and the commit warp's stores to them are relaxed .cta atomics; the
// commit warp, their only writer, loads them plainly.  None is read with
// __ldg/.nc, and no table value is held across commits.  All warps share
// the SM's L1, so the block scope suffices.
//
// Counters (stats[2..12]): bids committed from a speculative result,
// results redone after a conflict, bids taken with the ring holding one row,
// the ring length at each bid in buckets 1, 2-3, 4-15, 16-63, >= 64 (with W
// > 0 the first three add up to the bids), and the commit warp's clock64
// cycles waiting for slots, bidding itself and committing.
//
// Measured on an H100 (700 W) over the 1M headline's 5,107,288-bid tail
// (PERF.md): 0.62 us/bid with W = 4 (the default, ops/gs_kernel.py
// BID_WARPS), against 0.82-0.89 for the one-warp kernel this replaces;
// 90% of the bids commit speculatively.  The commit warp sets the pace:
// per bid ~300 clock cycles waiting for bid warps (at rings of 2-3 rows
// they can start only 1-2 positions ahead) and ~230 storing and
// publishing, beside its own instruction latency.  Part A alone (W = 0)
// runs at ~1.0 us/bid, slower than the one-warp kernel's 0.82.
#include <algorithm>
#include <climits>

#include "common.cuh"
#include "sync.cuh"

namespace {

using u64 = unsigned long long;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNone = 0x7FFFFFFF;   // no slot seen yet (sorts after all)
constexpr int kStampBits = 12;      // ops/gs_kernel.py: STAMP_BITS
constexpr int kStamps = 1 << kStampBits;
constexpr int kMaxBidWarps = 31;
enum Scan { kFullScan = 0, kConst = 1, kNoPrices = 2 };

using sslap::ld_acq;
using sslap::ld_rlx;
using sslap::st_rel;
using sslap::st_rlx;
using sslap::Watchdog;

__device__ __forceinline__ u64 pack(float price, int32_t owner) {
  return static_cast<u64>(__float_as_uint(price)) |
         (static_cast<u64>(static_cast<uint32_t>(owner)) << 32);
}
__device__ __forceinline__ float price_of(u64 e) {
  return __uint_as_float(static_cast<uint32_t>(e));
}
__device__ __forceinline__ int32_t owner_of(u64 e) {
  return static_cast<int32_t>(e >> 32);
}

__device__ __forceinline__ float fmax_sel(float a, float b) {
  return b > a ? b : a;
}

// The warp's minimum of a 64-bit value whose lanes differ by little.
__device__ __forceinline__ long long warp_min(long long x) {
  const long long x0 = __shfl_sync(kFull, x, 0);
  const long long d = x - x0;
  const int di = d < INT_MIN ? INT_MIN : d > INT_MAX ? INT_MAX
                                                     : static_cast<int>(d);
  return x0 + __reduce_min_sync(kFull, di);
}

struct Params {
  const int32_t* cols;
  const float* vals;
  int32_t K;
  int levels;                        // lane-merge levels
  int32_t* queue;
  long long cap, qcount;
  u64* packed;
  float eps, bigp, neg, half, real_min;
  long long max_bids;
  int W;                             // bid warps
  long long* stats;
};

// Published by the commit warp (release), read by the bid warps (acquire).
struct Ctl {
  long long count;                   // bids committed
  long long tail;                    // absolute ring tail
  int stop;
};

// One speculative result, tagged with its ring position.
struct Slot {
  long long tag;                     // position t, written last (release)
  long long c0;                      // commits the bid's reads saw at least
  int32_t u, j, prev, found;
  float bid;
  int32_t pad;
};

// A lane's (then the warp's) top 2 with the winner's column, owner, a*.
struct Top {
  float v1, v2, a;
  int slot;
  int32_t j, own;
};

struct Bid {
  int32_t j;
  float bid;
  int32_t prev;
  bool found;
};

// A table entry the kernel writes.  The commit warp is the only writer, so
// its own loads are plain (ordered after its lanes' stores by
// __syncwarp, as loads of one thread); a bid warp's load races with its
// stores and is a relaxed .cta atomic, as are the stores when bid warps
// run (SPEC).
template <bool RELAXED, class T>
__device__ __forceinline__ T load(T* p) {
  if constexpr (RELAXED) return ld_rlx(p);
  else return *p;
}
template <bool RELAXED, class T>
__device__ __forceinline__ void store(T* p, T v) {
  if constexpr (RELAXED) st_rlx(p, v);
  else *p = v;
}

template <int SCAN, bool RELAXED>
__device__ __forceinline__ void scan_slot(Top& t, const Params& P, int32_t c,
                                          float v, int k, int32_t* mark) {
  const float a = v + 0.0f;
  const bool real = a > P.real_min;
  float w = P.neg;
  int32_t own = -1;
  if (real) {
    const u64 e = load<RELAXED>(P.packed + c);
    own = owner_of(e);
    w = a - (SCAN == kNoPrices ? 0.0f : price_of(e) + 0.0f);
  }
  if (mark != nullptr) mark[k] = real ? c : -1;
  // strict '>': the lowest slot keeps a tie
  if (w > t.v1) {
    t.v2 = t.v1;
    t.v1 = w;
    t.slot = k;
    t.j = c;
    t.own = own;
    t.a = a;
  } else {
    t.v2 = fmax_sel(t.v2, w);
  }
}

// Merge the lanes: the higher v1 wins, then the lower slot; the loser's v1
// competes for the second place.  Lanes >= K hold nothing, so `levels`
// butterfly steps merge every slot into lane 0, which broadcasts; the
// winner's column, owner and a* come from the lane holding its slot (its
// own best, at lane slot mod 32).
__device__ __forceinline__ void merge(Top& t, int levels) {
  for (int d = (1 << levels) >> 1; d > 0; d >>= 1) {
    const float o1 = __shfl_xor_sync(kFull, t.v1, d);
    const float o2 = __shfl_xor_sync(kFull, t.v2, d);
    const int os = __shfl_xor_sync(kFull, t.slot, d);
    if (o1 > t.v1 || (o1 == t.v1 && os < t.slot)) {
      t.v2 = fmax_sel(t.v1, o2);
      t.v1 = o1;
      t.slot = os;
    } else {
      t.v2 = fmax_sel(t.v2, o1);
    }
  }
  if (levels < 5) {
    t.v1 = __shfl_sync(kFull, t.v1, 0);
    t.v2 = __shfl_sync(kFull, t.v2, 0);
    t.slot = __shfl_sync(kFull, t.slot, 0);
  }
  const int src = t.slot & 31;
  t.j = __shfl_sync(kFull, t.j, src);
  t.own = __shfl_sync(kFull, t.own, src);
  t.a = __shfl_sync(kFull, t.a, src);
}

// The bid of row u, warp-wide (every lane gets it).  Lane l holds slots l,
// l + 32, ...; with `pre`, slot `lane` of the row is already in (c0r, v0r).
// `mark` (bid warps) receives the row's real columns, -1 for padding.
// `mid()` runs once the gathers are issued, before the merge.
template <int SCAN, bool RELAXED, class Mid>
__device__ __forceinline__ Bid row_bid(const Params& P, int32_t u, bool pre,
                                       int32_t c0r, float v0r, int lane,
                                       int32_t* mark, Mid mid) {
  const long long row = static_cast<long long>(u) * P.K;
  Bid b;
  if constexpr (SCAN == kConst) {
    int32_t j = 0, prev = 0;
    float bid = 0.0f;
    if (lane == 0) {
      j = pre ? c0r : __ldg(P.cols + row);
      const u64 e = load<RELAXED>(P.packed + j);
      bid = (price_of(e) + 0.0f) + P.eps;
      prev = owner_of(e);
    }
    mid();
    b.j = __shfl_sync(kFull, j, 0);
    b.bid = __shfl_sync(kFull, bid, 0);
    b.prev = __shfl_sync(kFull, prev, 0);
    b.found = true;
    return b;
  }
  Top t{P.neg, P.neg, P.neg, kNone, 0, -1};
  for (int k = lane; k < P.K; k += 32) {
    const bool here = pre && k == lane;
    const int32_t c = here ? c0r : __ldg(P.cols + row + k);
    const float v = here ? v0r : __ldg(P.vals + row + k);
    scan_slot<SCAN, RELAXED>(t, P, c, v, k, mark);
  }
  mid();
  merge(t, P.levels);
  b.found = t.v1 > P.neg;
  if (!b.found) {
    // No real slot (excluded by the contract): the TPU kernel's initial
    // j* = column 0 and a* = neg.
    t.j = 0;
    t.a = P.neg;
    t.own = owner_of(load<RELAXED>(P.packed));
  }
  float v2 = t.v2;
  if (!(v2 > P.half)) v2 = t.v1 - P.bigp;
  b.j = t.j;
  b.bid = (t.a - v2) + P.eps;
  b.prev = t.own;
  return b;
}

// Slot `lane` of row u, or nothing for a lane past the row.
__device__ __forceinline__ void load_slot(const Params& P, int32_t u,
                                          int lane, int32_t& c, float& v) {
  if (lane < P.K) {
    const long long row = static_cast<long long>(u) * P.K;
    c = __ldg(P.cols + row + lane);
    v = __ldg(P.vals + row + lane);
  }
}

// Warp 0.  SPEC: bid warps run beside it (their slots, stamps and the
// published counters); else it bids every position itself and keeps one
// row in flight ahead of the bid: at position t the row of t + 1 (final
// when the ring holds more rows) is loaded and the queue entry of t + 2
// read, and at a ring of one row the evicted owner's row is loaded before
// the stores.
template <int SCAN, bool SPEC>
__device__ __forceinline__ void commit_warp(const Params& P, Ctl* ctl,
                                            int32_t* stamps, Slot* slots,
                                            int32_t* scols, int lane) {
  const long long cap = P.cap;
  const int32_t K = P.K;
  const int nslots = 2 * P.W;
  long long t = 0, tail = P.qcount, head = 0, tq = P.qcount;
  long long spec = 0, redo = 0, single = 0;
  long long cyc_wait = 0, cyc_self = 0, cyc_commit = 0;   // clock64 cycles
  long long h1 = 0, h3 = 0, h15 = 0, h63 = 0, h64 = 0;  // ring lengths
  int32_t u = -1;                    // row of position t, if known
  bool pre = false;                  // its slot `lane` is in (cr, vr)
  int32_t cr = 0;
  float vr = 0.0f;
  int32_t u1 = -1;                   // !SPEC: row of t + 1, if read
  int s = 0;                         // SPEC: slot of position t
  while (t != tail && t < P.max_bids) {
    const long long len = tail - t;
    h1 += len == 1;
    h3 += len > 1 && len < 4;
    h15 += len >= 4 && len < 16;
    h63 += len >= 16 && len < 64;
    h64 += len >= 64;
    Bid b;
    bool have = false;
    if (SPEC && len > 1) {
      Slot* sl = slots + s;
      Watchdog dog;
      const long long c0w = clock64();
      while (!__all_sync(kFull, ld_acq(&sl->tag) == t)) dog.tick();
      cyc_wait += clock64() - c0w;
      const uint32_t c0 = static_cast<uint32_t>(sl->c0);
      bool hit = !sl->found;
      const int32_t* mk = scols + static_cast<long long>(s) * K;
      for (int k = lane; k < K; k += 32) {
        const int32_t c = mk[k];
        // a stamp in [c0, t): modulo 2**32, so a stamp left from 2**31
        // commits before c0 reads as a conflict, never the other way
        if (c >= 0 && static_cast<int32_t>(static_cast<uint32_t>(
                          stamps[c & (kStamps - 1)]) - c0) >= 0)
          hit = true;
      }
      hit = __any_sync(kFull, hit);
      u = sl->u;
      pre = false;
      if (!hit) {
        b.j = sl->j;
        b.bid = sl->bid;
        b.prev = sl->prev;
        have = true;
        ++spec;
      } else {
        ++redo;
      }
    } else if (len == 1) {
      ++single;
    }
    const long long c1 = clock64();
    int32_t next = -1, cn = 0, q1 = 0, q2 = 0;
    float vn = 0.0f;
    bool npre = false;
    const bool ahead = !SPEC && len > 1 && t + 1 < P.max_bids;
    const bool read2 = !SPEC && len > 2 && t + 2 < P.max_bids;
    if (ahead) {
      // the row of t + 1 goes out now if its queue entry is known, else
      // once this row's gathers are out (mid); the entry of t + 2 too
      if (u1 >= 0) load_slot(P, u1, lane, cn, vn);
      else if (lane == 0) q1 = P.queue[head + 1 == cap ? 0 : head + 1];
      if (read2 && lane == 0) {
        long long h2 = head + 2;
        if (h2 >= cap) h2 -= cap;
        q2 = P.queue[h2];
      }
    }
    if (!have) {
      if (u < 0) {
        int32_t q = 0;
        if (lane == 0) q = P.queue[head];
        u = __shfl_sync(kFull, q, 0);
        pre = false;
      }
      b = row_bid<SCAN, false>(P, u, pre, cr, vr, lane, nullptr, [&] {
        if (ahead && u1 < 0) {
          u1 = __shfl_sync(kFull, q1, 0);
          load_slot(P, u1, lane, cn, vn);
        }
      });
      cyc_self += clock64() - c1;
    }
    if (ahead) {
      next = u1;
      npre = true;
    }
    // A ring of one row: the next bid is the evicted owner's.
    if (len == 1 && b.prev >= 0 && t + 1 < P.max_bids) {
      next = b.prev;
      npre = true;
      load_slot(P, next, lane, cn, vn);
    }
    const long long c2 = clock64();
    if (lane == 0) {
      store<SPEC>(P.packed + b.j, pack(b.bid, u));
      if (b.prev >= 0) store<SPEC>(P.queue + tq, b.prev);
      if (SPEC) stamps[b.j & (kStamps - 1)] = static_cast<int32_t>(t);
    }
    if (b.prev >= 0) {
      tq = tq + 1 == cap ? 0 : tq + 1;
      ++tail;
    }
    ++t;
    head = head + 1 == cap ? 0 : head + 1;
    u = next;
    pre = npre;
    cr = cn;
    vr = vn;
    u1 = read2 ? __shfl_sync(kFull, q2, 0) : -1;
    if (SPEC) {
      s = s + 1 == nslots ? 0 : s + 1;
      if (lane == 0) {
        // one release fence orders this commit's stores before both
        // counters; the bid warps read them and then fence (acquire)
        cuda::atomic_thread_fence(cuda::memory_order_release,
                                  cuda::thread_scope_block);
        if (b.prev >= 0) st_rlx(&ctl->tail, tail);
        st_rlx(&ctl->count, t);
      }
    }
    __syncwarp();
    cyc_commit += clock64() - c2;
  }
  if (lane == 0) {
    if (SPEC) st_rel(&ctl->stop, 1);  // every bid warp leaves
    long long* st = P.stats;
    st[0] = t;
    st[1] = tail - t;
    st[2] = spec;
    st[3] = redo;
    st[4] = single;
    st[5] = h1;
    st[6] = h3;
    st[7] = h15;
    st[8] = h63;
    st[9] = h64;
    st[10] = cyc_wait;
    st[11] = cyc_self;
    st[12] = cyc_commit;
  }
}

// Warps 1..W: bid warp w takes positions w, w + W, ... (see the header).
// Once it has taken t, the queue entry and row of t + W are read if they
// are final already (rows are immutable), so its next bid starts with its
// row in registers.
__device__ __forceinline__ void bid_warp(const Params& P, Ctl* ctl,
                                         Slot* slots, int32_t* scols, int w,
                                         int lane) {
  const int W = P.W, nslots = 2 * P.W;
  long long t = w, qpos = w % P.cap;
  int s = w;
  int32_t nu = -1, cr = 0;           // the row of t, when read ahead
  float vr = 0.0f;
  while (t < P.max_bids) {
    long long c, T, seen = -1;
    Watchdog dog;
    for (;;) {
      const long long cl = ld_rlx(&ctl->count);
      const long long tl = ld_rlx(&ctl->tail);
      const int stop = ld_rlx(&ctl->stop);
      if (__any_sync(kFull, stop != 0)) return;
      c = warp_min(cl);
      T = warp_min(tl);
      if (c > t || (t < T && t - c <= W)) break;
      if (c != seen) {
        seen = c;
        dog = Watchdog();
      }
      dog.tick();
    }
    // every commit before the counts this lane read is visible after this
    cuda::atomic_thread_fence(cuda::memory_order_acquire,
                              cuda::thread_scope_block);
    long long qnext = qpos + W;
    while (qnext >= P.cap) qnext -= P.cap;
    const bool ahead = t + W < T && t + W < P.max_bids;
    // Passed, or a ring of one row at t (the commit warp bids there).
    if (!(c > t || (c == t && T == t + 1))) {
      int32_t q = 0;
      if (lane == 0 && nu < 0) q = ld_rlx(P.queue + qpos);
      const bool pre = nu >= 0;
      const int32_t u = pre ? nu : __shfl_sync(kFull, q, 0);
      nu = -1;
      // t + W's entry and row once this row's gathers are out
      const Bid b = row_bid<kFullScan, true>(
          P, u, pre, cr, vr, lane, scols + static_cast<long long>(s) * P.K,
          [&] {
            if (ahead) {
              int32_t qn = 0;
              if (lane == 0) qn = ld_rlx(P.queue + qnext);
              nu = __shfl_sync(kFull, qn, 0);
              load_slot(P, nu, lane, cr, vr);
            }
          });
      __syncwarp();
      if (lane == 0) {
        Slot* sl = slots + s;
        sl->c0 = c;
        sl->u = u;
        sl->j = b.j;
        sl->bid = b.bid;
        sl->prev = b.prev;
        sl->found = b.found;
        st_rel(&sl->tag, t);
      }
    } else {
      nu = -1;
    }
    t += W;
    s += W;
    if (s >= nslots) s -= nslots;
    qpos = qnext;
  }
}

template <int SCAN, bool SPEC>
__global__ void __launch_bounds__(1024) gs_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Ctl ctl;
  int32_t* stamps = reinterpret_cast<int32_t*>(smem);
  Slot* slots = reinterpret_cast<Slot*>(smem + kStamps * sizeof(int32_t));
  int32_t* scols = reinterpret_cast<int32_t*>(slots + 2 * P.W);
  if constexpr (SPEC) {
    for (int i = threadIdx.x; i < kStamps; i += blockDim.x) stamps[i] = -1;
    for (int i = threadIdx.x; i < 2 * P.W; i += blockDim.x)
      slots[i].tag = -1;
    if (threadIdx.x == 0) {
      ctl.count = 0;
      ctl.tail = P.qcount;
      ctl.stop = 0;
    }
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0)
    commit_warp<SCAN, SPEC>(P, &ctl, stamps, slots, scols, lane);
  else if constexpr (SPEC)
    bid_warp(P, &ctl, slots, scols, warp - 1, lane);
}

__global__ void pack_kernel(const float* __restrict__ prices,
                            const int32_t* __restrict__ owner, u64* packed,
                            long long m) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < m; i += static_cast<long long>(gridDim.x) * blockDim.x)
    packed[i] = pack(prices[i], owner[i]);
}

__global__ void unpack_kernel(const u64* __restrict__ packed, float* prices,
                              int32_t* owner, long long m) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < m; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const u64 e = packed[i];
    prices[i] = price_of(e);
    owner[i] = owner_of(e);
  }
}

int merge_levels(int32_t K) {
  int levels = 0;
  while (levels < 5 && (1 << levels) < K) ++levels;
  return levels;
}

}  // namespace

// Dynamic shared memory of a launch with W bid warps at row width K.
extern "C" long long sslap_gs_smem(int32_t K, int W) {
  return W > 0 ? static_cast<long long>(kStamps) * sizeof(int32_t) +
                     2LL * W * (sizeof(Slot) + 4LL * K)
               : 0;
}

extern "C" int sslap_gs_f32(const int32_t* cols, const float* vals,
                            int32_t K, int32_t* queue, int64_t cap,
                            int64_t qcount, float* prices, int32_t* owner,
                            int64_t m, void* packed, float eps, float bigp,
                            float neg, float half, float real_min,
                            int64_t max_bids, int bid_warps, int scan,
                            int64_t* stats, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int W = scan == kFullScan ? bid_warps : 0;
  if (W < 0 || W > kMaxBidWarps || scan < kFullScan || scan > kNoPrices)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* table = static_cast<u64*>(packed);
  const unsigned grid =
      m > 0 ? std::min<unsigned>(sslap::grid_for(m), 1024u) : 0u;
  if (grid > 0) {
    pack_kernel<<<grid, sslap::kBlock, 0, st>>>(prices, owner, table, m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Params P{cols, vals, K, merge_levels(K), queue,
                 static_cast<long long>(cap), static_cast<long long>(qcount),
                 table, eps, bigp, neg, half, real_min,
                 static_cast<long long>(max_bids), W,
                 reinterpret_cast<long long*>(stats)};
  const size_t smem = static_cast<size_t>(sslap_gs_smem(K, W));
  auto kernel = W > 0               ? gs_kernel<kFullScan, true>
                : scan == kFullScan ? gs_kernel<kFullScan, false>
                : scan == kConst    ? gs_kernel<kConst, false>
                                    : gs_kernel<kNoPrices, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<1, 32 * (W + 1), smem, st>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || grid == 0) return static_cast<int>(err);
  unpack_kernel<<<grid, sslap::kBlock, 0, st>>>(table, prices, owner, m);
  return static_cast<int>(cudaGetLastError());
}
