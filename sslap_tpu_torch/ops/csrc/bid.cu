// K1: bid kernel over a compacted id list (sm_90a).
//
// Replaces sslap_tpu/ops/bid.py::_bid_kernel (the Pallas full-width bid),
// moved onto the compacted round of sslap_tpu/compact.py::compact_round:
// bid stage (compact.py:305-317) plus, with phase_start, the eps-CS
// violator scan (compact.py:319-334).
//
// A warp owns 32 id slots, one a lane.  A dead slot (id >= n) is written
// by its own lane (tgt = m, bid = 0) and loads no row.  The live slots are
// taken 32 / G at a time (G a power of two <= 32, a template parameter the
// wrapper picks from K): a group of G lanes runs round.cuh's bid_lanes on
// one row: lane g takes up to 8 slots a step, the slots k = g mod G (V =
// 1) or 16-byte vectors of 4 slots, vector g mod G (V = 4: K % 4 == 0 and
// 16-byte aligned rows), issues their price gathers itself, all in flight
// together, and the group merges (v1, slot, v2,
// a, col, cur) with __shfl_xor_sync.  The group's first lane runs
// bid_finish (bid, target, violator write): tgt = the row's best column
// for bidders, else m.  The batched entry serves the batched Jacobi solve
// (batch.py): that lane reads eps and bigp of the row's instance.  This
// standalone launch serves the full-width Jacobi round
// (auction.jacobi_round) and the batched solve; the eps-phase ladder
// (ladder.cu) keeps round.cuh's bid_row, one thread a row, in its stage A.
//
// Bound on an H100: each live row reads K cols + K values (contiguous, 8K
// bytes) and gathers K prices at random columns from a table that stays
// in the 50 MB L2; tgt and bid are written once.  The first version ran one
// thread per row, so a warp's load touched 32 rows at once: at K = 52 its
// 13 loads of 16 bytes from each row refetched lines evicted from L1, and
// a row's K gathers came from one thread, 4 in flight.  Here a warp's load
// covers 32 / G whole rows, coalesced, each row is fetched once, and a
// row has up to 8 G gathers in flight; the batched solve's id lists, all
// N rows with most of them dead late in a phase, cost one lane a dead
// slot.  The price gathers remain: each moves a 32-byte L2 sector for 4
// useful bytes.
#include "round.cuh"

namespace {

// Four blocks an SM at most 64 registers a thread: K1 waits on memory,
// so resident warps matter more than registers (it spills none at 64).
template <typename T, int G, int V>
__global__ void __launch_bounds__(sslap::kBlock, 4) bid_kernel(
    const int32_t* __restrict__ ids, int64_t C,
    const int32_t* __restrict__ cols, const T* __restrict__ vals_m,
    const int32_t* __restrict__ nvalid, const T* __restrict__ prices,
    int32_t* sigma, int32_t* owner, int32_t n, int32_t m, int32_t K, T eps,
    T bigp, const T* __restrict__ eps_of, const T* __restrict__ bigp_of,
    int32_t rows_per, T neg, T half_neg, int phase_start,
    int32_t* __restrict__ tgt, T* __restrict__ bid) {
  constexpr int kRows = 32 / G;   // rows a warp bids on at once
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  // the warp owns slots base .. base + 31, one id per lane
  const int64_t base =
      blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x - lane;
  const int32_t my_id = base + lane < C ? __ldg(ids + base + lane) : n;
  if (base + lane < C && my_id >= n) {
    tgt[base + lane] = m;
    bid[base + lane] = T(0);
  }
  // the live slots, kRows at a time: group lane / G takes the (lane /
  // G)-th lowest of them
  unsigned todo = __ballot_sync(sslap::kFullMask, my_id < n);
  while (todo != 0) {
    unsigned rest = todo;
    for (int r = 0; r < lane / G; ++r) rest &= rest - 1;
    const bool live = rest != 0;
    const int src = live ? __ffs(rest) - 1 : 0;
    const int32_t id = __shfl_sync(sslap::kFullMask, my_id, src);
    // loads that only need id, issued before the row's
    const int32_t sig = phase_start && live ? sigma[id] : -1;
    const bool lead = live && g == 0;
    const int32_t nv = lead ? __ldg(nvalid + id) : 0;
    if (lead && eps_of != nullptr) {  // batched: the scalars of id's instance
      eps = eps_of[id / rows_per];
      bigp = bigp_of[id / rows_per];
    }
    // prices are not written during this launch: the read-only path is safe
    const sslap::LaneTop<T> top = sslap::bid_lanes<T, G, V>(
        id, live, g, cols, vals_m, sig,
        [=](int32_t c) { return __ldg(prices + c); }, K, neg, half_neg);
    if (lead)
      tgt[base + src] = sslap::bid_finish<T>(top, id, nv, sig, m, eps, bigp,
                                             phase_start != 0, sigma, owner,
                                             &bid[base + src]);
    for (int r = 0; r < kRows; ++r) todo &= todo - 1;
  }
}

template <typename T, int G, int V>
void launch_group(const int32_t* ids, int64_t C, const int32_t* cols,
                  const T* vals_m, const int32_t* nvalid, const T* prices,
                  int32_t* sigma, int32_t* owner, int32_t n, int32_t m,
                  int32_t K, T eps, T bigp, const T* eps_of, const T* bigp_of,
                  int32_t rows_per, T neg, T half_neg, int phase_start,
                  int32_t* tgt, T* bid, cudaStream_t stream) {
  bid_kernel<T, G, V><<<sslap::grid_for(C), sslap::kBlock, 0, stream>>>(
      ids, C, cols, vals_m, nvalid, prices, sigma, owner, n, m, K, eps, bigp,
      eps_of, bigp_of, rows_per, neg, half_neg, phase_start, tgt, bid);
}

template <typename T, int V>
int launch_lanes(int lanes, const int32_t* ids, int64_t C,
                 const int32_t* cols, const T* vals_m, const int32_t* nvalid,
                 const T* prices, int32_t* sigma, int32_t* owner, int32_t n,
                 int32_t m, int32_t K, T eps, T bigp, const T* eps_of,
                 const T* bigp_of, int32_t rows_per, T neg, T half_neg,
                 int phase_start, int32_t* tgt, T* bid, cudaStream_t s) {
#define SSLAP_BID_GROUP(G)                                                  \
  case G:                                                                   \
    launch_group<T, G, V>(ids, C, cols, vals_m, nvalid, prices, sigma,      \
                          owner, n, m, K, eps, bigp, eps_of, bigp_of,       \
                          rows_per, neg, half_neg, phase_start, tgt, bid,   \
                          s);                                               \
    return 0;
  switch (lanes) {
    SSLAP_BID_GROUP(1)
    SSLAP_BID_GROUP(2)
    SSLAP_BID_GROUP(4)
    SSLAP_BID_GROUP(8)
    SSLAP_BID_GROUP(16)
    SSLAP_BID_GROUP(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSLAP_BID_GROUP
}

template <typename T>
int launch_bid(int lanes, int vec, const int32_t* ids, int64_t C,
               const int32_t* cols, const T* vals_m, const int32_t* nvalid,
               const T* prices, int32_t* sigma, int32_t* owner, int32_t n,
               int32_t m, int32_t K, T eps, T bigp, const T* eps_of,
               const T* bigp_of, int32_t rows_per, T neg, T half_neg,
               int phase_start, int32_t* tgt, T* bid, void* stream) {
  if (vec != 1 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (C > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err =
        vec == 4 ? launch_lanes<T, 4>(lanes, ids, C, cols, vals_m, nvalid,
                                      prices, sigma, owner, n, m, K, eps,
                                      bigp, eps_of, bigp_of, rows_per, neg,
                                      half_neg, phase_start, tgt, bid, s)
                 : launch_lanes<T, 1>(lanes, ids, C, cols, vals_m, nvalid,
                                      prices, sigma, owner, n, m, K, eps,
                                      bigp, eps_of, bigp_of, rows_per, neg,
                                      half_neg, phase_start, tgt, bid, s);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// lanes: G, the lanes of a row group (1, 2, 4, 8, 16 or 32); vec: 4 for
// 16-byte row loads (K % 4 == 0, cols and vals_m 16-byte aligned), else 1.
int sslap_bid_f32(const int32_t* ids, int64_t C, const int32_t* cols,
                  const float* vals_m, const int32_t* nvalid,
                  const float* prices, int32_t* sigma, int32_t* owner,
                  int32_t n, int32_t m, int32_t K, float eps, float bigp,
                  float neg, float half_neg, int phase_start, int lanes,
                  int vec, int32_t* tgt, float* bid, void* stream) {
  return launch_bid<float>(lanes, vec, ids, C, cols, vals_m, nvalid, prices,
                           sigma, owner, n, m, K, eps, bigp, nullptr,
                           nullptr, 1, neg, half_neg, phase_start, tgt, bid,
                           stream);
}

int sslap_bid_i32(const int32_t* ids, int64_t C, const int32_t* cols,
                  const int32_t* vals_m, const int32_t* nvalid,
                  const int32_t* prices, int32_t* sigma, int32_t* owner,
                  int32_t n, int32_t m, int32_t K, int32_t eps, int32_t bigp,
                  int32_t neg, int32_t half_neg, int phase_start, int lanes,
                  int vec, int32_t* tgt, int32_t* bid, void* stream) {
  return launch_bid<int32_t>(lanes, vec, ids, C, cols, vals_m, nvalid,
                             prices, sigma, owner, n, m, K, eps, bigp,
                             nullptr, nullptr, 1, neg, half_neg, phase_start,
                             tgt, bid, stream);
}

// The batched entry: ids, cols and the [n] / [m] tables are a batch's,
// flattened (row b * rows_per + r, column b * m_inst + c), and each row
// reads eps and bigp of its instance, eps_of[id / rows_per] and
// bigp_of[id / rows_per].
int sslap_bid_batched_f32(const int32_t* ids, int64_t C, const int32_t* cols,
                          const float* vals_m, const int32_t* nvalid,
                          const float* prices, int32_t* sigma, int32_t* owner,
                          int32_t n, int32_t m, int32_t K,
                          const float* eps_of, const float* bigp_of,
                          int32_t rows_per, float neg, float half_neg,
                          int phase_start, int lanes, int vec, int32_t* tgt,
                          float* bid, void* stream) {
  return launch_bid<float>(lanes, vec, ids, C, cols, vals_m, nvalid, prices,
                           sigma, owner, n, m, K, 0.0f, 0.0f, eps_of,
                           bigp_of, rows_per, neg, half_neg, phase_start, tgt,
                           bid, stream);
}

int sslap_bid_batched_i32(const int32_t* ids, int64_t C, const int32_t* cols,
                          const int32_t* vals_m, const int32_t* nvalid,
                          const int32_t* prices, int32_t* sigma,
                          int32_t* owner, int32_t n, int32_t m, int32_t K,
                          const int32_t* eps_of, const int32_t* bigp_of,
                          int32_t rows_per, int32_t neg, int32_t half_neg,
                          int phase_start, int lanes, int vec, int32_t* tgt,
                          int32_t* bid, void* stream) {
  return launch_bid<int32_t>(lanes, vec, ids, C, cols, vals_m, nvalid,
                             prices, sigma, owner, n, m, K, 0, 0, eps_of,
                             bigp_of, rows_per, neg, half_neg, phase_start,
                             tgt, bid, stream);
}

}  // extern "C"
