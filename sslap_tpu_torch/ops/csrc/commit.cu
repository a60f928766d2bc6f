// K2: resolve + commit over a compacted round (sm_90a).
//
// Replaces sslap_tpu/ops/commit.py::_commit_kernel (the Pallas sequential
// max-scatter of bids into per-column (best, winner), contract
// sslap_tpu/auction.py::resolve_bids), and also applies the commit of
// sslap_tpu/compact.py::compact_round (compact.py:338-368): price raise,
// owner install, eviction, sigma update.
//
// The TPU kernel walks the bids in order on one core.  Blocks here run in
// no order, so the tie-break is carried by the key instead of the order:
//   key = (order-preserving uint32 of the bid) << 32 | (0xFFFFFFFF - row)
// One 64-bit atomicMax per bidder on keys[tgt] (pass 1) then leaves, per
// column, the highest bid with the LOWEST row among equal bids.  Float
// bids map by flipping all bits of negatives and setting the sign bit of
// non-negatives, after -0.0 is canonicalised to +0.0 (the reference's
// b == best treats them as equal); int32 bids flip the sign bit.
//
// Pass 2: each bidder whose key survived is its column's unique winner.
// It reads the previous owner, writes price = its own bid, owner, sigma,
// clears the evictee's sigma (an evictee is assigned, so never a bidder of
// this round: the writes are disjoint), and resets keys[tgt] to 0.  That
// reset is the O(C) pass: every column that received a bid has exactly
// one winner, so the [m] key table is all zero again after every round
// with no [m] memset.  A loser that reads the cleared key still compares
// unequal, since every real key is > 0.  Outputs: stay (losers, else n),
// evicted (previous owners, else n), counts = (won, evicted, stayed),
// block-reduced in shared memory before one global atomic per block.
//
// Bound on an H100: C random 8-byte atomics and a handful of random 4-byte
// accesses per bidder into [m] tables that stay resident in L2 (keys 8 MB,
// prices/owner 4 MB each at m = 1M); on narrow ladder tiers the two
// launches' latency dominates.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t order_bits(float b) {
  if (b == 0.0f) b = 0.0f;  // -0.0 ties +0.0
  const uint32_t u = __float_as_uint(b);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t order_bits(int32_t b) {
  return static_cast<uint32_t>(b) ^ 0x80000000u;
}

template <typename T>
__device__ __forceinline__ unsigned long long bid_key(T b, int32_t row) {
  return (static_cast<unsigned long long>(order_bits(b)) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu -
                                         static_cast<uint32_t>(row));
}

template <typename T>
__global__ void resolve_kernel(const int32_t* __restrict__ ids,
                               const int32_t* __restrict__ tgt,
                               const T* __restrict__ bid, int64_t C,
                               int32_t m, unsigned long long* keys,
                               int32_t* counts) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i == 0) {
    counts[0] = 0;
    counts[1] = 0;
    counts[2] = 0;
  }
  if (i >= C) return;
  const int32_t j = tgt[i];
  if (j >= m) return;
  atomicMax(&keys[j], bid_key(bid[i], ids[i]));
}

template <typename T>
__global__ void commit_kernel(const int32_t* __restrict__ ids,
                              const int32_t* __restrict__ tgt,
                              const T* __restrict__ bid, int64_t C,
                              int32_t n, int32_t m, unsigned long long* keys,
                              T* prices, int32_t* owner, int32_t* sigma,
                              int32_t* __restrict__ stay,
                              int32_t* __restrict__ evicted,
                              int32_t* counts) {
  __shared__ int block_counts[3];
  if (threadIdx.x < 3) block_counts[threadIdx.x] = 0;
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i < C) {
    const int32_t id = ids[i];
    const int32_t j = tgt[i];
    int32_t s = n, e = n;
    if (j < m) {
      const T b = bid[i];
      const volatile unsigned long long* kj = keys + j;
      if (*kj == bid_key(b, id)) {
        keys[j] = 0ull;
        const int32_t prev = owner[j];
        prices[j] = b;
        owner[j] = id;
        sigma[id] = j;
        atomicAdd(&block_counts[0], 1);
        if (prev >= 0) {
          sigma[prev] = -1;
          e = prev;
          atomicAdd(&block_counts[1], 1);
        }
      } else {
        s = id;
        atomicAdd(&block_counts[2], 1);
      }
    }
    stay[i] = s;
    evicted[i] = e;
  }
  __syncthreads();
  if (threadIdx.x < 3 && block_counts[threadIdx.x] != 0)
    atomicAdd(&counts[threadIdx.x], block_counts[threadIdx.x]);
}

template <typename T>
int launch_commit(const int32_t* ids, const int32_t* tgt, const T* bid,
                  int64_t C, int32_t n, int32_t m, unsigned long long* keys,
                  T* prices, int32_t* owner, int32_t* sigma, int32_t* stay,
                  int32_t* evicted, int32_t* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = C > 0 ? sslap::grid_for(C) : 1;
  resolve_kernel<T><<<grid, sslap::kBlock, 0, s>>>(ids, tgt, bid, C, m,
                                                   keys, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  commit_kernel<T><<<grid, sslap::kBlock, 0, s>>>(
      ids, tgt, bid, C, n, m, keys, prices, owner, sigma, stay, evicted,
      counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sslap_commit_f32(const int32_t* ids, const int32_t* tgt,
                     const float* bid, int64_t C, int32_t n, int32_t m,
                     unsigned long long* keys, float* prices, int32_t* owner,
                     int32_t* sigma, int32_t* stay, int32_t* evicted,
                     int32_t* counts, void* stream) {
  return launch_commit<float>(ids, tgt, bid, C, n, m, keys, prices, owner,
                              sigma, stay, evicted, counts, stream);
}

int sslap_commit_i32(const int32_t* ids, const int32_t* tgt,
                     const int32_t* bid, int64_t C, int32_t n, int32_t m,
                     unsigned long long* keys, int32_t* prices,
                     int32_t* owner, int32_t* sigma, int32_t* stay,
                     int32_t* evicted, int32_t* counts, void* stream) {
  return launch_commit<int32_t>(ids, tgt, bid, C, n, m, keys, prices, owner,
                                sigma, stay, evicted, counts, stream);
}

}  // extern "C"
