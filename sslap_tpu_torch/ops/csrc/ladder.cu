// The eps-phase ladder: K1 + K2 redesigned as one persistent kernel
// (sm_90a).
//
// Redesigns sslap_tpu/ops/bid.py::_bid_kernel (K1) and
// sslap_tpu/ops/commit.py::_commit_kernel (K2) for the square tiered
// solve.  The reference runs each eps phase as one device program
// (sslap_tpu/compact.py::solve_rowpack_tiered: run_phase and the
// lax.while_loops of tier_ladder); ops/ladder.py::ladder_phase_plain is
// the same phase as a host loop over the kernels' plain versions, a torch
// sort for the relist and one count read back per round.
//
// One cooperative launch runs one whole phase: the phase-start round over
// rows 0..n-1 (taken implicitly; with the eps-CS violator scan after the
// first phase), the wide loop, and the ladder down to `threshold` or
// max_iter.  A round is two stages, each closed by a grid barrier:
//   A  bid + resolve: per live id, round.cuh's bid_row (K1), then one
//      atomicMax of K2's (bid, ~row) key on keys[tgt];
//   B  commit + relist: round.cuh's commit_bid (K2); the loser, or the
//      evictee of a won column, is appended to the other id buffer with a
//      warp-aggregated atomicAdd on a device counter.  That count is the
//      next round's active count: every block reads it after the barrier
//      and takes the same decision (a divergent one would deadlock the
//      next barrier).
// The ids are appended in no fixed order; nothing depends on it: bids are
// per row and the key makes the resolve order-free, so sigma, prices,
// owner and the round count equal the plain version's bit for bit.
//
// The tier a ladder round counts under is computed from its active count
// a, which never grows within a phase: min{ti : a > max(tiers[ti + 1] or
// 0, threshold)}; the phase start and wide rounds count under index 0.
// The histogram lives in block 0's shared memory and goes out with the
// round count, the active count and the timers in one small array, the
// phase's one read back.
//
// Once at most kThreads rows are live, block 0 carries on alone (the
// other blocks return): ids in shared memory, each thread's target and
// bid in its registers, __syncthreads() as the barrier.
//
// Cross-SM visibility: prices, owner, sigma, keys, ids, tgt and bid are
// written in one stage and read by other SMs in the next, so every load of
// them goes through L2 (__ldcg), never the non-coherent read-only path;
// the barrier is an arrival counter plus a generation word with
// acquire/release at gpu scope (cooperative launch makes every block
// resident).  cols, vals_m and nvalid are read-only.
//
// Bound on an H100: a wide round reads each live row's 8K bytes and makes
// a few random 4-8 byte accesses per row into [m] tables that stay in the
// 50 MB L2; a narrow round is a chain of dependent L2 round trips (id, row,
// K prices, the key's atomic, key, owner) plus two barriers.  The design
// takes the host out of every round (no launch, no allocation, no sync)
// and drops the grid barrier once the live rows fit in one block.
#include "round.cuh"

namespace {

constexpr int kThreads = 1024;   // block size; the one-block tail's limit
constexpr int kMaxTiers = 63;    // the histogram has kMaxTiers + 1 slots
// A grid barrier waits microseconds; one still waiting after this long
// can only be a fault, and traps (the launch fails) instead of hanging.
constexpr unsigned long long kBarrierTimeoutNs = 10000000000ull;

// Device control words: zero when first allocated, and left with
// bar_count == 0 by every completed barrier, so they need no reset
// between launches (each append counter is cleared before its round).
struct Ctrl {
  unsigned int bar_count;   // arrivals at the current grid barrier
  unsigned int bar_gen;     // completed grid barriers
  int cnt[3];               // append counters, rotating by round
};

// out[]: int64 words written by block 0 at the end of the phase
// (device ns from %globaltimer; *ANs: the stage A part of the rounds, the
// rest being stage B and the loop control)
enum {
  kRounds, kActive, kGridRounds, kTailRounds, kGridNs, kTailNs, kGridANs,
  kTailANs, kHist
};

template <typename T>
struct Params {
  const int32_t* cols;
  const T* vals_m;
  const int32_t* nvalid;
  T* prices;
  int32_t* owner;
  int32_t* sigma;
  unsigned long long* keys;
  int32_t* ids[2];          // ping-pong id buffers, [n] each
  int32_t* tgt;             // per-slot targets and bids of a grid round
  T* bid;
  Ctrl* ctrl;
  const int32_t* tiers;
  int32_t ntiers;
  int32_t n, m, K;
  T eps, bigp, neg, half_neg;
  int first, wide;
  int32_t threshold;
  long long rounds, max_iter;
  long long* out;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every block of the cooperative grid waits here for all the others; the
// writes before it are visible to every thread after it.
__device__ __forceinline__ void grid_barrier(Ctrl* ctrl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(&ctrl->bar_gen);
    __threadfence();
    if (atomicAdd(&ctrl->bar_count, 1u) == gridDim.x - 1) {
      atomicExch(&ctrl->bar_count, 0u);
      __threadfence();
      st_release(&ctrl->bar_gen, gen + 1);
    } else {
      const unsigned long long start = globaltimer();
      unsigned spins = 0;
      while (ld_acquire(&ctrl->bar_gen) == gen) {
        if ((++spins & 1023u) == 0 &&
            globaltimer() - start > kBarrierTimeoutNs)
          __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Append v (where has) at dst[counter++], one atomic per warp.  Every lane
// of the warp must call it.
__device__ __forceinline__ void warp_append(bool has, int32_t v,
                                            int32_t* dst, int* counter) {
  const unsigned mask = __ballot_sync(0xffffffffu, has);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (has) dst[base + __popc(mask & ((1u << lane) - 1u))] = v;
}

// The histogram slot of the next round at `active` live rows, or -1 when
// the phase ends: the wide loop (while active > wide_floor), then the
// ladder (while active > threshold), both while rounds < max_iter.  *ti
// is the tier of the last ladder round (0 at the phase start): the active
// count never grows within a phase, so the tier never steps back up and
// the scan resumes there.
__device__ __forceinline__ int next_slot(int active, long long rounds,
                                         long long max_iter, bool* in_wide,
                                         int wide_floor, int threshold,
                                         const int32_t* tiers, int ntiers,
                                         int* ti) {
  if (rounds >= max_iter) return -1;
  if (*in_wide) {
    if (active > wide_floor) return 0;
    *in_wide = false;
  }
  if (active <= threshold) return -1;
  while (*ti + 1 < ntiers && active <= max(tiers[*ti + 1], threshold)) ++*ti;
  return 1 + *ti;
}

template <typename T>
__device__ __forceinline__ int32_t stage_bid(const Params<T>& p, int32_t id,
                                             bool phase_start, T* b) {
  const T* prices = p.prices;
  return sslap::bid_row<T>(
      id, p.cols, p.vals_m, __ldg(p.nvalid + id),
      phase_start ? __ldcg(p.sigma + id) : -1,
      [=](int32_t c) { return __ldcg(prices + c); }, p.m, p.K, p.eps,
      p.bigp, p.neg, p.half_neg, phase_start, p.sigma, p.owner, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ladder_kernel(const Params<T> p) {
  __shared__ int32_t s_ids[2][kThreads];
  __shared__ int32_t s_tiers[kMaxTiers];
  __shared__ long long s_hist[kMaxTiers + 1];
  __shared__ int s_cnt[2];

  const bool lead = blockIdx.x == 0;
  for (int t = threadIdx.x; t < p.ntiers; t += blockDim.x)
    s_tiers[t] = p.tiers[t];
  for (int t = threadIdx.x; t <= p.ntiers; t += blockDim.x) s_hist[t] = 0;
  __syncthreads();
  // block 0's thread 0 times the phase: t0 start, t1 the tail's start,
  // and the stage A part of the grid and tail rounds
  const bool timer = lead && threadIdx.x == 0;
  unsigned long long t0 = 0, t1 = 0, ts = 0, a_ns[2] = {0, 0};
  if (timer) t0 = globaltimer();

  const long long gtid =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int wide_floor = static_cast<int>((2LL * p.n) / 5);
  bool in_wide = p.wide != 0;
  long long rounds = p.rounds, grid_rounds = 0, tail_rounds = 0;
  int slot = 0;             // the phase start counts under index 0
  int active = p.n;         // its slots: rows 0..n-1, implicitly
  bool implicit = true;
  int lr = 0;               // round of this launch
  int ti = 0;               // tier of the last ladder round

  while (true) {
    const int32_t* cur = p.ids[lr & 1];
    int32_t* nxt = p.ids[(lr + 1) & 1];
    int* cnt = &p.ctrl->cnt[(lr + 1) % 3];
    const bool phase_start = implicit && !p.first;
    if (timer) {
      ts = globaltimer();
      *cnt = 0;   // last read after the barrier two rounds back
      s_hist[slot] += 1;
    }
    // Stage A: bid + resolve
    for (long long i = gtid; i < active; i += stride) {
      const int32_t id = implicit ? static_cast<int32_t>(i) : __ldcg(cur + i);
      T b;
      const int32_t t = stage_bid(p, id, phase_start, &b);
      p.tgt[i] = t;
      p.bid[i] = b;
      if (t < p.m) atomicMax(p.keys + t, sslap::bid_key(b, id));
    }
    grid_barrier(p.ctrl);
    if (timer) a_ns[0] += globaltimer() - ts;
    // Stage B: commit + relist (warp-uniform loop for the ballot)
    for (long long i0 = gtid - lane; i0 < active; i0 += stride) {
      const long long i = i0 + lane;
      int32_t relist = -1;
      if (i < active) {
        const int32_t t = __ldcg(p.tgt + i);
        if (t < p.m) {
          const int32_t id =
              implicit ? static_cast<int32_t>(i) : __ldcg(cur + i);
          bool won;
          relist = sslap::commit_bid(id, t, __ldcg(p.bid + i), p.keys,
                                     p.prices, p.owner, p.sigma, 0, p.n,
                                     &won);
        }
      }
      warp_append(relist >= 0, relist, nxt, cnt);
    }
    grid_barrier(p.ctrl);
    active = __ldcg(cnt);
    ++rounds;
    ++grid_rounds;
    ++lr;
    implicit = false;
    slot = next_slot(active, rounds, p.max_iter, &in_wide, wide_floor,
                     p.threshold, s_tiers, p.ntiers, &ti);
    if (slot < 0 || active <= kThreads) break;
  }

  if (slot >= 0) {
    // The tail: block 0 alone, at most kThreads live rows, one per thread.
    if (!lead) return;
    if (timer) t1 = globaltimer();
    const int32_t* src = p.ids[lr & 1];
    if (static_cast<int>(threadIdx.x) < active)
      s_ids[0][threadIdx.x] = __ldcg(src + threadIdx.x);
    int sb = 0;
    __syncthreads();
    while (slot >= 0) {
      const int i = threadIdx.x;
      if (i == 0) {
        ts = globaltimer();
        s_cnt[sb ^ 1] = 0;   // last read two rounds back
        s_hist[slot] += 1;
      }
      int32_t id = 0, t = p.m;
      T b = T(0);
      if (i < active) {
        id = s_ids[sb][i];
        t = stage_bid(p, id, false, &b);
        if (t < p.m) atomicMax(p.keys + t, sslap::bid_key(b, id));
      }
      __syncthreads();
      if (i == 0) a_ns[1] += globaltimer() - ts;
      int32_t relist = -1;
      if (t < p.m) {
        bool won;
        relist = sslap::commit_bid(id, t, b, p.keys, p.prices, p.owner,
                                   p.sigma, 0, p.n, &won);
      }
      warp_append(relist >= 0, relist, s_ids[sb ^ 1], &s_cnt[sb ^ 1]);
      __syncthreads();
      active = s_cnt[sb ^ 1];
      sb ^= 1;
      ++rounds;
      ++tail_rounds;
      slot = next_slot(active, rounds, p.max_iter, &in_wide, wide_floor,
                       p.threshold, s_tiers, p.ntiers, &ti);
    }
  }

  if (timer) {
    const unsigned long long t2 = globaltimer();
    long long* out = p.out;
    out[kRounds] = rounds;
    out[kActive] = active;
    out[kGridRounds] = grid_rounds;
    out[kTailRounds] = tail_rounds;
    out[kGridNs] = static_cast<long long>((t1 ? t1 : t2) - t0);
    out[kTailNs] = t1 ? static_cast<long long>(t2 - t1) : 0;
    out[kGridANs] = static_cast<long long>(a_ns[0]);
    out[kTailANs] = static_cast<long long>(a_ns[1]);
    for (int h = 0; h <= p.ntiers; ++h) out[kHist + h] = s_hist[h];
  }
}

template <typename T>
int grid_blocks(int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ladder_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = per_sm * sms;
  return 0;
}

template <typename T>
int launch_ladder(const int32_t* cols, const T* vals_m,
                  const int32_t* nvalid, T* prices, int32_t* owner,
                  int32_t* sigma, unsigned long long* keys, int32_t* ids0,
                  int32_t* ids1, int32_t* tgt, T* bid, void* ctrl,
                  const int32_t* tiers, int32_t ntiers, int32_t n, int32_t m,
                  int32_t K, T eps, T bigp, T neg, T half_neg, int first,
                  int wide, int32_t threshold, long long rounds,
                  long long max_iter, long long* out, void* stream) {
  if (ntiers < 1 || ntiers > kMaxTiers)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int err = grid_blocks<T>(&blocks);
  if (err != 0) return err;
  Params<T> p{cols, vals_m, nvalid, prices, owner, sigma, keys, {ids0, ids1},
              tgt, bid, static_cast<Ctrl*>(ctrl), tiers, ntiers, n, m, K,
              eps, bigp, neg, half_neg, first, wide, threshold, rounds,
              max_iter, out};
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ladder_kernel<T>), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid on the current device (float32 kernel),
// or minus the CUDA error code.
int sslap_ladder_blocks() {
  int blocks = 0;
  const int err = grid_blocks<float>(&blocks);
  return err != 0 ? -err : blocks;
}

int sslap_ladder_ctrl_bytes() { return static_cast<int>(sizeof(Ctrl)); }

int sslap_ladder_f32(const int32_t* cols, const float* vals_m,
                     const int32_t* nvalid, float* prices, int32_t* owner,
                     int32_t* sigma, unsigned long long* keys, int32_t* ids0,
                     int32_t* ids1, int32_t* tgt, float* bid, void* ctrl,
                     const int32_t* tiers, int32_t ntiers, int32_t n,
                     int32_t m, int32_t K, float eps, float bigp, float neg,
                     float half_neg, int first, int wide, int32_t threshold,
                     long long rounds, long long max_iter, long long* out,
                     void* stream) {
  return launch_ladder<float>(cols, vals_m, nvalid, prices, owner, sigma,
                              keys, ids0, ids1, tgt, bid, ctrl, tiers, ntiers,
                              n, m, K, eps, bigp, neg, half_neg, first, wide,
                              threshold, rounds, max_iter, out, stream);
}

int sslap_ladder_i32(const int32_t* cols, const int32_t* vals_m,
                     const int32_t* nvalid, int32_t* prices, int32_t* owner,
                     int32_t* sigma, unsigned long long* keys, int32_t* ids0,
                     int32_t* ids1, int32_t* tgt, int32_t* bid, void* ctrl,
                     const int32_t* tiers, int32_t ntiers, int32_t n,
                     int32_t m, int32_t K, int32_t eps, int32_t bigp,
                     int32_t neg, int32_t half_neg, int first, int wide,
                     int32_t threshold, long long rounds, long long max_iter,
                     long long* out, void* stream) {
  return launch_ladder<int32_t>(cols, vals_m, nvalid, prices, owner, sigma,
                                keys, ids0, ids1, tgt, bid, ctrl, tiers,
                                ntiers, n, m, K, eps, bigp, neg, half_neg,
                                first, wide, threshold, rounds, max_iter, out,
                                stream);
}

}  // extern "C"
