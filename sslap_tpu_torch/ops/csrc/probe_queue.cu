// P6-P15: the queue-driven copy loops of the GS kernel, one single-warp
// loop kernel whose template variant selects the probe (sm_90a).
//
// Replaces benchmarks/probe_mosaic_gs.py:
//   P6  while_double_buffer (:194)  rows 2i, two slots, the next copy
//                                   started before the current one is
//                                   waited for (the prefetch pump)
//   P7  while_qtable_dma (:305)     the copy row id read from a queue table
//   P8  while_qtable_dma_store (:359) + pushes at the tail, re-read later
//   P9  sem_2d_dynamic (:426)       rows 2i, start + wait, flipping slot
//   P10 qdma_dual (:470)            P7 + a second (f32) copy, own barrier
//   P11 qdma_alias3 (:529)          P7 + reads of a price and an owner table
//   P12 qdma_alias2 (:592)          P7 + reads of a price table
//   P13 qdma_store_datadep (:649)   a store whose index is copied data
//   P14 qdma_store_bitcast (:713)   a store of f32 -> i32 bitcast values
//   P15 qdma_store_via_dma (:770)   P13's row written back by a bulk copy
// Each iteration copies rows [2 r, 2 r + 2) of a [rows, 128] int32 table
// (1 KB) into shared memory with cp.async.bulk on an mbarrier -- one
// barrier per slot with its own phase parity, the TPU's sem.at[slot] --
// and adds row 0 (P13, P15: row 1) to an int32 accumulator (wrapping).
// Tables are flat int32/f32 in global memory, read and written by lane 0
// with plain scalar accesses; the probes' one-hot lane reads and blend
// stores were Mosaic workarounds (see probe_lane.cu).  P15 builds the row
// in shared memory and writes it back with cp.async.bulk.global.shared::cta
// + commit_group / wait_group; its queue reads bypass L1 (ld.global.cg),
// since a bulk write does not update the SM's L1.
//
// Bound: a chain of global round trips per iteration (queue slot -> copy
// -> barrier), latency not bandwidth: 1 KB an iteration is nothing to
// HBM.  P6's pump takes the copy off the chain by starting iteration
// i + 1's copy before waiting for iteration i's; set against P9 (start +
// wait) at scale, the two give the bare cost of the copy chain.
#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int kLine = 128;
constexpr uint32_t kCopy = 2 * kLine * 4;     // one 2-row copy, bytes
constexpr unsigned kFull = 0xFFFFFFFFu;
enum Variant {
  kPump = 6, kQueue, kPush, kFlip, kDual, kAlias3, kAlias2, kDataDep,
  kBitcast, kViaDma
};

__device__ __forceinline__ uint32_t row_sum(const int32_t* row, int lane) {
  uint32_t s = 0;
  for (int i = lane; i < kLine; i += 32) s += static_cast<uint32_t>(row[i]);
  return __reduce_add_sync(kFull, s);
}

// Lane-strided partial sums, then a butterfly; every lane gets the same
// value.  Exact while the row's values and sums are integers below 2**24.
__device__ __forceinline__ float row_sum_f(const float* row, int lane) {
  float s = 0.0f;
  for (int i = lane; i < kLine; i += 32) s += row[i];
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
  return s;
}

__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t b) {
  const int32_t r = a % b;
  return r < 0 ? r + b : r;
}

template <int V>
__global__ void probe_queue_kernel(const int32_t* __restrict__ hbm,
                                   const float* __restrict__ vbm, int32_t* q,
                                   const float* pt, const int32_t* ot,
                                   int32_t n, int32_t* out) {
  __shared__ __align__(128) int32_t scr[2][2 * kLine];  // two copy slots
  __shared__ __align__(128) float vscr[2 * kLine];      // P10's f32 copy
  __shared__ __align__(128) int32_t wrow[kLine];        // P15's write-back
  __shared__ __align__(8) uint64_t bar[3];    // slot 0, slot 1, the f32 copy
  const int lane = threadIdx.x;
  if (lane == 0)
    for (int b = 0; b < 3; ++b) sslap::mbar_init(&bar[b]);
  __syncwarp();
  uint32_t phases = 0;                        // bit b: bar[b]'s next parity
  auto start = [&](int slot, int32_t r) {     // lane 0 only
    sslap::mbar_expect_tx(&bar[slot], kCopy);
    sslap::bulk_g2s(scr[slot], hbm + static_cast<int64_t>(r) * 2 * kLine,
                    kCopy, &bar[slot]);
  };
  auto wait = [&](int b) {
    sslap::mbar_wait(&bar[b], (phases >> b) & 1u);
    phases ^= 1u << b;
  };
  uint32_t acc = 0;

  if (V == kPump) {
    if (lane == 0 && n > 0) start(0, 0);
    for (int32_t i = 0; i < n; ++i) {
      const int slot = i & 1;
      if (lane == 0 && i + 1 < n) start(1 - slot, i + 1);
      wait(slot);
      acc += row_sum(scr[slot], lane);
      __syncwarp();                 // slot read before it is refilled
    }
  } else {
    int32_t tail = n;
    for (int32_t i = 0; i < (V == kPush ? tail : n); ++i) {
      const int slot = V == kFlip ? (i & 1) : 0;
      int32_t rid = i;
      if (V != kFlip) {
        if (lane == 0) rid = V == kViaDma ? __ldcg(q + i) : q[i];
        rid = __shfl_sync(kFull, rid, 0);
      }
      if (lane == 0) {
        start(slot, rid);
        if (V == kDual) {
          sslap::mbar_expect_tx(&bar[2], kCopy);
          sslap::bulk_g2s(vscr, vbm + static_cast<int64_t>(rid) * 2 * kLine,
                          kCopy, &bar[2]);
        }
      }
      wait(slot);
      if (V == kDual) wait(2);
      const int32_t* rows = scr[slot];
      if (V == kDataDep || V == kViaDma) {
        const int32_t tgt = 64 + floor_mod(rows[0], 32);
        const uint32_t val = acc + 7u;
        if (V == kDataDep) {
          if (lane == 0) q[tgt] = static_cast<int32_t>(val);
        } else {
          const int64_t base = static_cast<int64_t>(tgt / kLine) * kLine;
          for (int k = lane; k < kLine; k += 32)
            wrow[k] = base + k == tgt ? static_cast<int32_t>(val)
                                      : __ldcg(q + base + k);
          sslap::fence_async_smem();
          __syncwarp();
          if (lane == 0) {
            sslap::bulk_s2g(q + base, wrow, kLine * 4);
            sslap::bulk_wait();
          }
          __syncwarp();
        }
        acc += row_sum(rows + kLine, lane);
      } else {
        acc += row_sum(rows, lane);
      }
      if (V == kDual)
        acc += static_cast<uint32_t>(static_cast<int32_t>(
            row_sum_f(vscr, lane)));
      if (V == kAlias3 || V == kAlias2) {
        int32_t extra = 0;
        if (lane == 0) {
          extra = static_cast<int32_t>(pt[rid]);
          if (V == kAlias3) extra = static_cast<int32_t>(
              static_cast<uint32_t>(extra) + static_cast<uint32_t>(ot[rid]));
        }
        acc += static_cast<uint32_t>(__shfl_sync(kFull, extra, 0));
      }
      if (V == kBitcast && lane == 0)
        q[100 + floor_mod(i, 8)] =
            __float_as_int(1.5f * static_cast<float>(i + 1));
      if (V == kPush && i < 4) {
        if (lane == 0) q[tail] = rid + 20;
        ++tail;
      }
      __syncwarp();
    }
  }
  if (lane == 0) out[0] = static_cast<int32_t>(acc);
}

template <int V>
cudaError_t launch(const int32_t* hbm, const float* vbm, int32_t* q,
                   const float* pt, const int32_t* ot, int32_t n,
                   int32_t* out, cudaStream_t stream) {
  probe_queue_kernel<V><<<1, 32, 0, stream>>>(hbm, vbm, q, pt, ot, n, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sslap_probe_queue(int variant, const int32_t* hbm,
                                 const float* vbm, int32_t* q,
                                 const float* pt, const int32_t* ot,
                                 int32_t n, int32_t* out, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (variant) {
    case kPump: err = launch<kPump>(hbm, vbm, q, pt, ot, n, out, st); break;
    case kQueue: err = launch<kQueue>(hbm, vbm, q, pt, ot, n, out, st); break;
    case kPush: err = launch<kPush>(hbm, vbm, q, pt, ot, n, out, st); break;
    case kFlip: err = launch<kFlip>(hbm, vbm, q, pt, ot, n, out, st); break;
    case kDual: err = launch<kDual>(hbm, vbm, q, pt, ot, n, out, st); break;
    case kAlias3:
      err = launch<kAlias3>(hbm, vbm, q, pt, ot, n, out, st);
      break;
    case kAlias2:
      err = launch<kAlias2>(hbm, vbm, q, pt, ot, n, out, st);
      break;
    case kDataDep:
      err = launch<kDataDep>(hbm, vbm, q, pt, ot, n, out, st);
      break;
    case kBitcast:
      err = launch<kBitcast>(hbm, vbm, q, pt, ot, n, out, st);
      break;
    case kViaDma:
      err = launch<kViaDma>(hbm, vbm, q, pt, ot, n, out, st);
      break;
    default: break;
  }
  return static_cast<int>(err);
}
