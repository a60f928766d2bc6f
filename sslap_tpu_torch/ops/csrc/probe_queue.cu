// P6-P15: the queue-driven copy loops of the GS kernel (sm_90a).  P7-P14
// are one single-warp loop kernel whose template variant selects the
// probe; P6 (pump_kernel) and P15 (store_pass_kernel) have kernels of their
// own, below.
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
// Each iteration of P7-P14 copies rows [2 r, 2 r + 2) of a [rows, 128]
// int32 table (1 KB) into shared memory with cp.async.bulk on an mbarrier
// -- one barrier per slot with its own phase parity, the TPU's sem.at[slot]
// -- and adds row 0 (P13: row 1) to an int32 accumulator (wrapping).
// Tables are flat int32/f32 in global memory, read and written by lane 0
// with plain scalar accesses; the probes' one-hot lane reads and blend
// stores were Mosaic workarounds (see probe_lane.cu).
//
// Row ids.  P8, P13 and P14 store into the queue, and a later iteration
// reads such a slot as its row id (P13's acc + 7 at [64, 96), P14's float
// bits at [100, 108), P8's pushes), so the wrapper cannot check every id
// before the launch.  Each loop checks the id it reads against `limit`
// (rows / 2, and the price table's size for P11-P12) and, at the first id
// outside [0, limit), stops without touching the tables and reports
// (position, id) in out[1..2] (out[1] = -1 when every id was in range);
// the wrapper reads them back and raises.  P9 reads no queue (row i,
// checked by the wrapper).
//
// Bound of P7-P14: a chain of global round trips per iteration (queue slot
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
//
// P15 is not a loop.  With tgt_i = 64 + (hbm[2 rid_i, 0] mod 32), s_i =
// the sum of row 2 rid_i + 1 and acc_i the exclusive prefix sum of s (all
// wrapping), iteration i stores acc_i + 7 at q[tgt_i]; out = acc_n, and the
// final q[t] is acc_i + 7 of the last i with tgt_i = t.  rid_i = q[i] as the
// earlier iterations left it, so only positions in [64, 96) can read a
// slot the loop wrote.  store_pass_kernel: the positions are cut into
// segments of `seg` (a multiple of 32, >= 128), one one-warp block each.
// A warp takes its segment in passes of up to 32 positions, a lane each:
//   - the lanes read their queue slots (segment 0 from the queue's first
//     128-entry row, held in shared memory with the pass's stores applied;
//     every other slot is never written) and check the ids;
//   - each lane loads the first entry of its row 2 rid (the target), and
//     the warp loads each position's row 2 rid + 1 with one 16-byte load a
//     lane (coalesced), 16 rows in flight, summed by __reduce_add_sync;
//   - the pass ends before the first position whose slot an earlier
//     position of the pass writes (the cut P16 makes at a repeated column),
//     so no position's id depends on its own pass's stores: exact for any
//     n, and outside [64, 96) no cut happens;
//   - a warp scan (__shfl_up_sync) with the carried acc gives acc_i; the
//     highest lane of each __match_any_sync group on tgt is the pass's last
//     writer of that slot.
// The targets all lie in the queue's first row.  With one segment the warp
// builds that row in shared memory and writes it back once with
// cp.async.bulk shared -> global + wait_group.read (the probe's store by
// bulk copy, once a call instead of once an iteration): at the reference
// shape queue read -> row loads -> scan -> one bulk store, three dependent
// round trips, the last not waited for beyond its read of the row.  With more, each warp writes a record (its sum, its first bad id,
// and per target its last position and the acc there relative to the
// segment), and the last block to arrive (a counter the wrapper zeroes)
// scans the segment sums, takes per target the last segment that wrote it,
// rebuilds the row from the queue and writes it back the same way.  Bound
// on an H100: bytes, 4 + 32 + 512 a position (the slot, the sector of row
// 2 rid's first entry, row 2 rid + 1) plus the row, over 3.35 TB/s; a
// segment of 512 gives ~16 resident warps an SM at n = 2**20, each with
// 8 KB of row loads in flight.
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
  kBitcast
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
                                   int32_t n, int32_t limit, int32_t* out) {
  __shared__ __align__(128) int32_t scr[2][2 * kLine];  // two copy slots
  __shared__ __align__(128) float vscr[2 * kLine];      // P10's f32 copy
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
  int32_t bad = -1, bad_id = 0;               // the first id out of range

  {
    int32_t tail = n;
    for (int32_t i = 0; i < (V == kPush ? tail : n); ++i) {
      const int slot = V == kFlip ? (i & 1) : 0;
      int32_t rid = i;
      if (lane == 0) {                        // lane 0 checks, then copies
        if (V != kFlip) rid = q[i];
        if (V == kFlip || (rid >= 0 && rid < limit)) {
          start(slot, rid);
          if (V == kDual) {
            sslap::mbar_expect_tx(&bar[2], kCopy);
            sslap::bulk_g2s(vscr,
                            vbm + static_cast<int64_t>(rid) * 2 * kLine,
                            kCopy, &bar[2]);
          }
        }
      }
      if (V != kFlip) {
        rid = __shfl_sync(kFull, rid, 0);
        if (rid < 0 || rid >= limit) {        // warp-uniform: no copy
          bad = i;
          bad_id = rid;
          break;
        }
      }
      wait(slot);
      if (V == kDual) wait(2);
      const int32_t* rows = scr[slot];
      if (V == kDataDep) {
        if (lane == 0) q[64 + floor_mod(rows[0], 32)] =
            static_cast<int32_t>(acc + 7u);
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
  if (lane == 0) {
    out[0] = static_cast<int32_t>(acc);
    out[1] = bad;
    out[2] = bad_id;
  }
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
                   int32_t limit, int32_t* out, cudaStream_t stream) {
  probe_queue_kernel<V><<<1, 32, 0, stream>>>(hbm, vbm, q, pt, ot, n, limit,
                                              out);
  return cudaGetLastError();
}

// P15's segment record in the scratch table (int32): its sum, its first
// bad position (-1: none) and that id, the exclusive prefix of the segment
// sums (the merge writes it), then per target t (slot 64 + t) the last
// position of the segment that wrote it (-1: none) and the acc there,
// relative to the segment's start.
constexpr int kRecSum = 0, kRecBad = 1, kRecBadId = 2, kRecPrefix = 3;
constexpr int kRecPos = 4, kRecAcc = 36, kRec = 68;

// Inclusive warp scan of x (wrapping).
__device__ __forceinline__ uint32_t warp_scan(uint32_t x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The queue's first row, shared -> global by one bulk copy (lane 0 issues
// it and waits until the copy has read the row: the kernel's end orders
// the global write before later work on the stream, and nothing here reads
// the row in global memory after it).
__device__ __forceinline__ void write_back(int32_t* q, const int32_t* row,
                                           int lane) {
  sslap::fence_async_smem();
  __syncwarp();
  if (lane == 0) {
    sslap::bulk_s2g(q, row, kLine * 4);
    sslap::bulk_wait_read();
  }
  __syncwarp();
}

// P15, one warp a block, block b the positions [b seg, (b + 1) seg) (see
// the header).  out: acc_n, the first bad position (-1: none), its id.
__global__ void __launch_bounds__(32)
    store_pass_kernel(const int32_t* __restrict__ hbm, int32_t* q, int32_t n,
                      int32_t limit, int32_t seg, int32_t* scratch,
                      unsigned* arrived, int32_t* out) {
  __shared__ __align__(128) int32_t row[kLine];   // the queue's first row
  __shared__ int32_t lpos[32], lacc[32];          // per target: last writer
  const int lane = threadIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * seg;
  const int64_t hi = min(static_cast<int64_t>(n), lo + seg);
  const bool head = blockIdx.x == 0;
  if (head)
    reinterpret_cast<int4*>(row)[lane] =
        __ldcg(reinterpret_cast<const int4*>(q) + lane);
  lpos[lane] = -1;
  lacc[lane] = 0;
  __syncwarp();
  uint32_t acc = 0;
  int32_t bad = -1, bad_id = 0;
  for (int64_t t = lo; t < hi;) {
    const int act = static_cast<int>(min(static_cast<int64_t>(32), hi - t));
    const int64_t p = t + lane;
    int32_t rid = 0;
    if (lane < act) rid = head && p < kLine ? row[p] : __ldcg(q + p);
    const bool valid = lane < act && rid >= 0 && rid < limit;
    const unsigned ok = __ballot_sync(kFull, valid);
    // the target, from the first entry of row 2 rid (floor mod 32 = & 31)
    int32_t tgt = 0;
    if (valid) tgt = 64 + (__ldg(hbm + static_cast<int64_t>(rid) * 2 * kLine)
                           & 31);
    // s of each position: the warp on its row 2 rid + 1, a 16-byte load a
    // lane, 16 rows in flight; lane l keeps position t + l's sum
    uint32_t s = 0;
    for (int b = 0; b < act; b += 16) {
      uint32_t part[16];
#pragma unroll
      for (int l = 0; l < 16; ++l) {
        const int32_t r = __shfl_sync(kFull, rid, b + l);
        int4 v = make_int4(0, 0, 0, 0);
        if ((ok >> (b + l)) & 1u)
          v = __ldg(reinterpret_cast<const int4*>(
                        hbm + (static_cast<int64_t>(r) * 2 + 1) * kLine) +
                    lane);
        part[l] = static_cast<uint32_t>(v.x) + static_cast<uint32_t>(v.y) +
                  static_cast<uint32_t>(v.z) + static_cast<uint32_t>(v.w);
      }
#pragma unroll
      for (int l = 0; l < 16; ++l) {
        const uint32_t tot = __reduce_add_sync(kFull, part[l]);
        if (lane == b + l) s = tot;
      }
    }
    // the pass ends before the first position whose slot an earlier
    // position of it writes (only slots 64..95 are written)
    const int64_t d = tgt - t;
    const unsigned marks = __reduce_or_sync(
        kFull, valid && d > lane && d < 32 ? 1u << static_cast<int>(d) : 0u);
    int k = marks ? __ffs(marks) - 1 : 32;
    const unsigned out_of_range = __ballot_sync(kFull, lane < act && !valid);
    if (out_of_range && __ffs(out_of_range) - 1 < k) {
      const int l = __ffs(out_of_range) - 1;  // its id was read from the
      bad = static_cast<int32_t>(t + l);      // state the loop leaves there
      bad_id = __shfl_sync(kFull, rid, l);
      break;
    }
    k = min(k, act);
    const bool in = lane < k;
    const uint32_t incl = warp_scan(in ? s : 0u, lane);
    const uint32_t mine = acc + incl - (in ? s : 0u);   // acc_i
    acc += __shfl_sync(kFull, incl, 31);
    // the pass's last writer of each slot (the highest lane on it)
    const unsigned same = __match_any_sync(kFull, in ? tgt : -1 - lane);
    __syncwarp();                 // every lane's slot read before the stores
    if (in && (same >> lane) == 1u) {
      if (head) row[tgt] = static_cast<int32_t>(mine + 7u);
      lpos[tgt - 64] = static_cast<int32_t>(p);
      lacc[tgt - 64] = static_cast<int32_t>(mine);
    }
    __syncwarp();
    t += k;
  }
  if (gridDim.x == 1) {
    if (lane == 0) {
      out[0] = static_cast<int32_t>(acc);
      out[1] = bad;
      out[2] = bad_id;
    }
    if (bad < 0) write_back(q, row, lane);
    return;
  }
  int32_t* rec = scratch + static_cast<int64_t>(blockIdx.x) * kRec;
  if (lane == 0) {
    rec[kRecSum] = static_cast<int32_t>(acc);
    rec[kRecBad] = bad;
    rec[kRecBadId] = bad_id;
  }
  rec[kRecPos + lane] = lpos[lane];
  rec[kRecAcc + lane] = lacc[lane];
  __threadfence();                // the record before the arrival
  __syncwarp();
  unsigned last = 0;
  if (lane == 0) last = atomicAdd(arrived, 1u) == gridDim.x - 1;
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();                // every record before the reads below
  // the last block merges: lane l scans segments [g0, g1)
  const int G = gridDim.x, per = (G + 31) / 32;
  const int g0 = min(G, lane * per), g1 = min(G, g0 + per);
  uint32_t sum = 0;
  int first_bad = G;
  for (int g = g0; g < g1; ++g) {
    const int32_t* r = scratch + static_cast<int64_t>(g) * kRec;
    sum += static_cast<uint32_t>(__ldcg(r + kRecSum));
    if (first_bad == G && __ldcg(r + kRecBad) >= 0) first_bad = g;
  }
  const uint32_t incl = warp_scan(sum, lane);
  const uint32_t total = __shfl_sync(kFull, incl, 31);
  first_bad = __reduce_min_sync(kFull, first_bad);
  if (first_bad < G) {            // the first bad id in position order
    if (lane == 0) {
      const int32_t* r = scratch + static_cast<int64_t>(first_bad) * kRec;
      out[0] = static_cast<int32_t>(total);
      out[1] = __ldcg(r + kRecBad);
      out[2] = __ldcg(r + kRecBadId);
    }
    return;
  }
  uint32_t base = incl - sum;
  for (int g = g0; g < g1; ++g) {
    int32_t* r = scratch + static_cast<int64_t>(g) * kRec;
    __stcg(r + kRecPrefix, static_cast<int32_t>(base));
    base += static_cast<uint32_t>(__ldcg(r + kRecSum));
  }
  __threadfence_block();
  __syncwarp();
  // lane t: the last segment that wrote slot 64 + t
  int g = G - 1;
  while (g >= 0 &&
         __ldcg(scratch + static_cast<int64_t>(g) * kRec + kRecPos + lane) < 0)
    --g;
  reinterpret_cast<int4*>(row)[lane] =
      __ldcg(reinterpret_cast<const int4*>(q) + lane);
  __syncwarp();
  if (g >= 0) {
    const int32_t* r = scratch + static_cast<int64_t>(g) * kRec;
    row[64 + lane] = static_cast<int32_t>(
        static_cast<uint32_t>(__ldcg(r + kRecPrefix)) +
        static_cast<uint32_t>(__ldcg(r + kRecAcc + lane)) + 7u);
  }
  if (lane == 0) {
    out[0] = static_cast<int32_t>(total);
    out[1] = -1;
    out[2] = 0;
  }
  write_back(q, row, lane);
}

}  // namespace

extern "C" int sslap_probe_queue(int variant, const int32_t* hbm,
                                 const float* vbm, int32_t* q,
                                 const float* pt, const int32_t* ot,
                                 int32_t n, int32_t limit, int32_t* out,
                                 void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define SSLAP_QUEUE(V) launch<V>(hbm, vbm, q, pt, ot, n, limit, out, st)
  cudaError_t err = cudaErrorInvalidValue;
  switch (variant) {
    case kQueue: err = SSLAP_QUEUE(kQueue); break;
    case kPush: err = SSLAP_QUEUE(kPush); break;
    case kFlip: err = SSLAP_QUEUE(kFlip); break;
    case kDual: err = SSLAP_QUEUE(kDual); break;
    case kAlias3: err = SSLAP_QUEUE(kAlias3); break;
    case kAlias2: err = SSLAP_QUEUE(kAlias2); break;
    case kDataDep: err = SSLAP_QUEUE(kDataDep); break;
    case kBitcast: err = SSLAP_QUEUE(kBitcast); break;
    default: break;
  }
#undef SSLAP_QUEUE
  return static_cast<int>(err);
}

// P15: `blocks` = ceil(n / seg) one-warp blocks (at least one); scratch
// holds kRec int32 a block and `arrived` is zero when blocks > 1 (else
// both are unused).
extern "C" int sslap_probe_store(const int32_t* hbm, int32_t* q, int32_t n,
                                 int32_t limit, int32_t seg, int blocks,
                                 int32_t* scratch, unsigned* arrived,
                                 int32_t* out, void* stream) {
  if (n < 0 || seg < 128 || seg % 32 != 0 || blocks < 1 ||
      static_cast<int64_t>(blocks) * seg < n ||
      static_cast<int64_t>(blocks - 1) * seg >= (n > 0 ? n : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  store_pass_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      hbm, q, n, limit, seg, scratch, arrived, out);
  return static_cast<int>(cudaGetLastError());
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
