// P6-P15: the queue-driven copy loops of the GS kernel (sm_90a).  P7-P15
// are one single-warp loop kernel whose template variant selects the
// probe; P6 has a kernel of its own (pump_kernel, below).
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
// Each iteration of P7-P15 copies rows [2 r, 2 r + 2) of a [rows, 128]
// int32 table (1 KB) into shared memory with cp.async.bulk on an mbarrier
// -- one barrier per slot with its own phase parity, the TPU's sem.at[slot]
// -- and adds row 0 (P13, P15: row 1) to an int32 accumulator (wrapping).
// Tables are flat int32/f32 in global memory, read and written by lane 0
// with plain scalar accesses; the probes' one-hot lane reads and blend
// stores were Mosaic workarounds (see probe_lane.cu).  P15 builds the row
// in shared memory and writes it back with cp.async.bulk.global.shared::cta
// + commit_group / wait_group; its queue reads bypass L1 (ld.global.cg),
// since a bulk write does not update the SM's L1.
//
// Bound of P7-P15: a chain of global round trips per iteration (queue slot
// -> copy -> barrier), latency not bandwidth: 1 KB an iteration is nothing
// to HBM.  P9 keeps that chain (start + wait) as the yardstick of a copy's
// round trip.
//
// P6 computes out[0] = sum over i < n of row 2i's 128 entries, modulo
// 2**32: the TPU's pump existed to keep the next copy in flight while one
// is summed.  Its bound on an H100 is bytes, 512 per iteration (only row
// 2i is read), but one copy in flight on one warp makes it a latency
// chain (~320 ns an iteration, 1000x off the byte bound at 500k
// iterations).  Here the iterations are spread over a persistent grid of
// min(SMs, ceil(n / 64)) blocks, each a contiguous range (block b takes [n
// b / B, n (b + 1) / B)).  In a block, one producer thread keeps a ring of
// kPumpSlots copies in flight in shared memory (a full and an empty
// mbarrier per slot): HBM latency (~1-2 us under load) times an SM's share
// of the bandwidth (~25 GB/s) is 25-50 KB, and the 64 KB ring covers it.
// A copy is one 2-D TMA box of kPumpRows rows 2i (a tensor map that views
// rows 2i as an [n, 128] tensor with a 1 KB row stride), so only the rows
// summed are moved, in few copies: with a 512-byte cp.async.bulk per row
// the producer's issue rate bounds the pump whatever the ring's depth
// (H100; PERF.md).  kPumpConsumers warps sum the slots as they land (copy
// k to warp k mod kPumpConsumers, one 16-byte load a lane a row, the
// block's rows only) and release them; the block's partial goes to out by
// atomicAdd on uint32 (the wrapper zeroes out first), or by a plain store
// when one block runs; at the probe's n = 16 that block moves all 16 rows
// in one copy, and the consumer warp that sums it stores out.  Addition
// mod 2**32 commutes, so the result is exact in any order.
// Measured on an H100 (700 W; PERF.md): 0.089 ms at 500k iterations, 86%
// of the byte bound; 3.1 us a call back to back at n = 16, where
// index_select takes 2.4.
#include <cuda.h>
#include <cudaTypedefs.h>

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

  {
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

constexpr int kPumpRows = 16;               // rows 2i per copy (8 KB)
constexpr int kPumpSlots = 8;               // ring depth (64 KB)
constexpr int kPumpConsumers = 4;           // summing warps
constexpr uint32_t kBox = kPumpRows * kLine * 4;   // one copy, bytes

// A 2-D TMA copy of the box at (x, y) of `map` into shared memory.
__device__ __forceinline__ void tensor_g2s(void* dst, const CUtensorMap* map,
                                           int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(sslap::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(sslap::smem_u32(bar))
      : "memory");
}

// `map` views rows 2i, i < n, as an [n, 128] int32 tensor (row stride 1
// KB); a box is kPumpRows of them.
__global__ void __launch_bounds__(32 * (1 + kPumpConsumers))
    pump_kernel(const __grid_constant__ CUtensorMap map, int32_t n, int slots,
                uint32_t* out) {
  extern __shared__ __align__(1024) int32_t ring[];  // [slots][kPumpRows][128]
  __shared__ __align__(8) uint64_t full[kPumpSlots], empty[kPumpSlots];
  __shared__ uint32_t total;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t lo = static_cast<int32_t>(static_cast<int64_t>(n) *
                                          blockIdx.x / gridDim.x);
  const int32_t count = static_cast<int32_t>(
      static_cast<int64_t>(n) * (blockIdx.x + 1) / gridDim.x - lo);
  const int32_t copies = (count + kPumpRows - 1) / kPumpRows;
  // one block, at most one copy: consumer warp 0 alone sums, and stores
  const bool alone = gridDim.x == 1 && copies <= 1;
  if (threadIdx.x < slots) {
    sslap::mbar_init(&full[threadIdx.x]);
    sslap::mbar_init(&empty[threadIdx.x]);
  }
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {                          // the producer
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&map))
                   : "memory");
      for (int32_t k = 0; k < copies; ++k) {
        const int s = k & (slots - 1);
        // the slot's previous copy (k - slots) has been summed
        if (k >= slots) sslap::mbar_wait(&empty[s], ((k / slots) - 1) & 1);
        sslap::mbar_expect_tx(&full[s], kBox);
        tensor_g2s(ring + s * kPumpRows * kLine, &map, 0,
                   lo + k * kPumpRows, &full[s]);
      }
    }
  } else {                                    // the consumers
    uint32_t acc = 0;
    for (int32_t k = warp - 1; k < copies; k += kPumpConsumers) {
      const int s = k & (slots - 1);
      sslap::mbar_wait(&full[s], (k / slots) & 1);
      // the block's rows only: the last box may reach past them
      const int rows = min(kPumpRows, count - k * kPumpRows);
      const int4* box = reinterpret_cast<const int4*>(ring) +
                        s * kPumpRows * (kLine / 4) + lane;
      for (int r = 0; r < rows; ++r) {
        const int4 v = box[r * (kLine / 4)];
        acc += static_cast<uint32_t>(v.x) + static_cast<uint32_t>(v.y) +
               static_cast<uint32_t>(v.z) + static_cast<uint32_t>(v.w);
      }
      __syncwarp();                           // read before it is released
      if (lane == 0) sslap::mbar_arrive(&empty[s]);
    }
    acc = __reduce_add_sync(kFull, acc);
    if (alone) {
      if (warp == 1 && lane == 0) out[0] = acc;
    } else if (lane == 0) {
      atomicAdd(&total, acc);
    }
  }
  if (alone) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (gridDim.x == 1) out[0] = total;
    else atomicAdd(out, total);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
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

// P6: `blocks` blocks (out zeroed by the caller when blocks > 1); a ring
// of kPumpSlots slots, or of the next power of two >= a block's copies when
// that is fewer (less shared memory to set up at small n).
extern "C" int sslap_probe_pump(const int32_t* hbm, int32_t n, int blocks,
                                int32_t* out, void* stream) {
  if (blocks < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map{};
  if (n > 0) {
    const auto encode = tensor_map_encoder();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {kLine, static_cast<cuuint64_t>(n)};
    const cuuint64_t stride[1] = {2 * kLine * 4};        // row 2i -> 2i + 2
    const cuuint32_t box[2] = {kLine, kPumpRows};
    const cuuint32_t step[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2,
               const_cast<int32_t*>(hbm), dims, stride, box, step,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t per = (static_cast<int64_t>(n) + blocks - 1) / blocks;
  const int64_t copies = (per + kPumpRows - 1) / kPumpRows;
  int slots = 1;
  while (slots < kPumpSlots && slots < copies) slots *= 2;
  static bool opted_in = false;               // the 64 KB ring, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        pump_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPumpSlots * kBox);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  pump_kernel<<<blocks, 32 * (1 + kPumpConsumers), slots * kBox,
                static_cast<cudaStream_t>(stream)>>>(
      map, n, slots, reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
