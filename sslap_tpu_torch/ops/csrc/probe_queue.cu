// P6-P15: the queue-driven copy loops of the GS kernel (sm_90a), as three
// kernels: pump_kernel (P6 and P9), queue_pass_kernel (P7, P8, P10-P12 and
// P14, a template variant each) and store_pass_kernel (P13 and P15).
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
// Each TPU loop copies rows [2 r, 2 r + 2) of a [rows, 128] int32 table an
// iteration and adds row 2 r (P13, P15: row 2 r + 1) to an int32
// accumulator (wrapping).  What they compute needs no loop:
//   P6, P9    out = the sum over i < n of row 2i: one function, so P9
//             runs P6's pump_kernel;
//   P7        out = the sum over positions p of row 2 rid_p, rid_p = q[p];
//   P10       P7 + int32(the f32 sum of row 2 rid_p of vbm);
//   P11, P12  P7 + int32(pt[rid_p]) (P11: + ot[rid_p]);
//   P8        P7 over n + 4 positions (n > 0): iteration i < 4 pushes
//             q[n + i] = rid_i + 20, which position n + i reads;
//   P14       P7, and iteration i stores the bits of 1.5 (i + 1) at
//             q[100 + i mod 8];
//   P13, P15  a scan whose stores land where later positions read (below;
//             one function, so P13 runs P15's store_pass_kernel).
// Tables are flat int32/f32 in global memory.  Row ids: a loop checks each
// id it reads against `limit` (rows / 2, and the price table's size for
// P11-P12) and stops at the first one outside [0, limit) in position
// order, reading no row of that position or a later one of its segment;
// the kernel reports (position, id) and the wrapper raises.  P6 and P9
// read no queue (rows 2i, checked by the wrapper).
//
// queue_pass_kernel.  The ids the loops write are known without the loop:
// position n + i of P8 reads rid_i + 20, so rid_p = q[p mod n] + 20 (p / n)
// for p >= n (a chain when n < 4), and position p in [100, 108) of P14 reads
// what iteration p - 4 stored, the bits of 1.5 (p - 3); no other position
// reads a written slot.  So each position's id is read from a slot no
// position writes, or computed, and the positions are independent but for
// the stop at a bad id.  They are cut into segments of `seg` (a multiple of
// 32), one one-warp block each, and a warp takes its segment in passes of
// 32 positions, a lane each:
//   - the lanes read their ids together (one 128-byte line a pass) or
//     compute them; a ballot finds the first out of range, and the pass
//     keeps the positions before it;
//   - P11-P12's lanes gather pt[rid] and ot[rid];
//   - the warp loads each kept position's row 2 rid with one 16-byte load
//     a lane (coalesced), 16 rows in flight (P10: 8, and their vbm rows),
//     and each lane adds its share into its own wrapped partial (the order
//     of additions mod 2**32 does not matter).  P10's f32 row sum has one
//     fixed order: a lane's 4 entries left to right, then a butterfly over
//     the lanes, xor 16, 8, 4, 2, 1 (exact while the values and partial
//     sums are integers below 2**24, which the plain version's sum needs
//     too);
//   - at a bad id the warp records (position, id) and stops.
// A warp reduces its partials once (__reduce_add_sync).  One block stores
// out and the error word; more add into out by a uint32 atomicAdd (the
// wrapper zeroes it) and keep the lowest (position << 32 | id) by a 64-bit
// atomicMin, so the report is the first bad id in position order (the
// segments after it run on, on their own in-range ids).  Block 0 applies
// the loop's stores to the queue at its end (P8's four pushes, P14's eight
// slots): no position reads them.  Bound on an H100: bytes, per position 4
// (the id) + 512 (row 2 rid; P10 + 512 of vbm; P11 + a 32-byte sector each
// of the price and the owner, P12 of the price) over 3.35 TB/s; at the
// reference shape (n = 12, one pass) it is latency: two dependent global
// round trips (the ids, then the rows) between the launch and the store.
//
// P6 (and P9) computes out[0] = sum over i < n of row 2i's 128 entries,
// modulo 2**32: the TPU's pump existed to keep the next copy in flight
// while one is summed.  Its bound on an H100 is bytes, 512 per iteration
// (only row 2i is read), but one copy in flight on one warp makes it a
// latency chain (~320 ns an iteration, 1000x off the byte bound at 500k
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
// P15 (and P13) is not a loop.  With tgt_i = 64 + (hbm[2 rid_i, 0] mod
// 32), s_i = the sum of row 2 rid_i + 1 and acc_i the exclusive prefix sum
// of s (all wrapping), iteration i stores acc_i + 7 at q[tgt_i]; out =
// acc_n, and the final q[t] is acc_i + 7 of the last i with tgt_i = t.
// rid_i = q[i] as the earlier iterations left it, so only positions in
// [64, 96) can read a slot the loop wrote.  store_pass_kernel: the
// positions are cut into segments of `seg` (a multiple of 32, >= 128), one
// one-warp block each.  A warp takes its segment in passes of up to 32
// positions, a lane each:
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
// round trips, the last not waited for beyond its read of the row.  With
// more, each warp writes a record (its sum, its first bad id, and per
// target its last position and the acc there relative to the
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
constexpr unsigned kFull = 0xFFFFFFFFu;
enum Variant {
  kQueue = 7, kPush = 8, kDual = 10, kAlias3 = 11, kAlias2 = 12,
  kBitcast = 14
};
constexpr long long kNoBad = 0x7FFFFFFFFFFFFFFFll;   // the error word: none

// The positions variant V's loop runs: P8 pushes four more when n > 0.
__host__ __device__ inline int64_t queue_total(int v, int32_t n) {
  return v == kPush && n > 0 ? static_cast<int64_t>(n) + 4 : n;
}

// The row id position p reads, as the loop leaves the queue there (see
// the header): P8's pushed slots and P14's written slots forwarded, every
// other slot read as the call found it (no position writes it).
template <int V>
__device__ __forceinline__ int32_t queue_id(const int32_t* q, int32_t n,
                                            int64_t p) {
  if (V == kPush && p >= n)                   // rid_(p - n) + 20, chained
    return static_cast<int32_t>(
        static_cast<uint32_t>(__ldcg(q + p % n)) +
        20u * static_cast<uint32_t>(p / n));
  if (V == kBitcast && p >= 100 && p < 108)   // stored by iteration p - 4
    return __float_as_int(1.5f * static_cast<float>(p - 3));
  return __ldcg(q + p);
}

// P7, P8, P10-P12, P14, one warp a block, block b the positions [b seg,
// (b + 1) seg) (see the header).  out[0]: the sum in its low 32 bits;
// out[1]: (first bad position << 32 | its id), or kNoBad.
template <int V>
__global__ void __launch_bounds__(32)
    queue_pass_kernel(const int32_t* __restrict__ hbm,
                      const float* __restrict__ vbm, int32_t* q,
                      const float* __restrict__ pt,
                      const int32_t* __restrict__ ot, int32_t n,
                      int32_t limit, int32_t seg, long long* out) {
  constexpr int G = V == kDual ? 8 : 16;     // rows in flight a lane
  const int lane = threadIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * seg;
  const int64_t hi = min(queue_total(V, n), lo + seg);
  uint32_t acc = 0;                           // this lane's partial
  int64_t bad = -1;
  int32_t bad_id = 0, first = 0;              // first: position lane's id
  for (int64_t t = lo; t < hi; t += 32) {
    const int act = static_cast<int>(min(static_cast<int64_t>(32), hi - t));
    int32_t rid = 0;
    if (lane < act) rid = queue_id<V>(q, n, t + lane);
    if (t == 0) first = rid;
    const unsigned out_of_range =
        __ballot_sync(kFull, lane < act && (rid < 0 || rid >= limit));
    // the pass keeps the positions before the first id out of range
    const int k = out_of_range ? __ffs(out_of_range) - 1 : act;
    float pk = 0.0f;
    int32_t ow = 0;
    if ((V == kAlias3 || V == kAlias2) && lane < k) {
      pk = __ldg(pt + rid);
      if (V == kAlias3) ow = __ldg(ot + rid);
    }
    // row 2 rid of each kept position: the warp on it, a 16-byte load a
    // lane, G rows in flight
    for (int b = 0; b < k; b += G) {
      int4 v[G];
      float4 w[G];
#pragma unroll
      for (int l = 0; l < G; ++l) {
        const int32_t r = __shfl_sync(kFull, rid, (b + l) & 31);
        v[l] = make_int4(0, 0, 0, 0);
        w[l] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (b + l < k) {
          const int64_t row = static_cast<int64_t>(r) * 2 * kLine;
          v[l] = __ldg(reinterpret_cast<const int4*>(hbm + row) + lane);
          if (V == kDual)
            w[l] = __ldg(reinterpret_cast<const float4*>(vbm + row) + lane);
        }
      }
#pragma unroll
      for (int l = 0; l < G; ++l)
        acc += static_cast<uint32_t>(v[l].x) + static_cast<uint32_t>(v[l].y) +
               static_cast<uint32_t>(v[l].z) + static_cast<uint32_t>(v[l].w);
      if (V == kDual) {       // the f32 sums' fixed order (a row not kept
        float f[G];           // is zeros: it adds 0), the G interleaved
#pragma unroll
        for (int l = 0; l < G; ++l)
          f[l] = ((w[l].x + w[l].y) + w[l].z) + w[l].w;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
#pragma unroll
          for (int l = 0; l < G; ++l) f[l] += __shfl_xor_sync(kFull, f[l], d);
        if (lane == 0)
#pragma unroll
          for (int l = 0; l < G; ++l)
            acc += static_cast<uint32_t>(static_cast<int32_t>(f[l]));
      }
    }
    if (V == kAlias3 || V == kAlias2)
      acc += static_cast<uint32_t>(static_cast<int32_t>(pk)) +
             static_cast<uint32_t>(ow);
    if (out_of_range) {
      bad = t + k;
      bad_id = __shfl_sync(kFull, rid, k);
      break;
    }
  }
  const uint32_t sum = __reduce_add_sync(kFull, acc);
  // the loop's stores into the queue (no position reads these slots)
  if (blockIdx.x == 0 && bad < 0) {
    if (V == kPush && n > 0 && lane < 4) q[n + lane] = first + 20;
    const int64_t total = queue_total(V, n);
    if (V == kBitcast && lane < 8 && lane < total) {
      const int64_t i = lane + 8 * ((total - 1 - lane) / 8);  // the last
      q[100 + lane] = __float_as_int(1.5f * static_cast<float>(i + 1));
    }
  }
  if (lane != 0) return;
  const long long key =
      bad < 0 ? kNoBad
              : (bad << 32) | static_cast<long long>(
                                  static_cast<uint32_t>(bad_id));
  if (gridDim.x == 1) {
    out[0] = static_cast<long long>(sum);
    out[1] = key;
  } else {
    atomicAdd(reinterpret_cast<unsigned*>(out), sum);
    if (bad >= 0) atomicMin(out + 1, key);
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

// P7, P8, P10-P12, P14: `blocks` = ceil(total / seg) one-warp blocks (at
// least one), total = the variant's positions; out (int64 [2]) holds (0,
// kNoBad) when blocks > 1.
extern "C" int sslap_probe_queue(int variant, const int32_t* hbm,
                                 const float* vbm, int32_t* q,
                                 const float* pt, const int32_t* ot,
                                 int32_t n, int32_t limit, int32_t seg,
                                 int blocks, long long* out, void* stream) {
  const int64_t total = queue_total(variant, n);
  if (n < 0 || seg < 32 || seg % 32 != 0 || blocks < 1 ||
      static_cast<int64_t>(blocks) * seg < total ||
      static_cast<int64_t>(blocks - 1) * seg >= (total > 0 ? total : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define SSLAP_QUEUE(V)                                                   \
  queue_pass_kernel<V><<<blocks, 32, 0, st>>>(hbm, vbm, q, pt, ot, n, \
                                              limit, seg, out)
  switch (variant) {
    case kQueue: SSLAP_QUEUE(kQueue); break;
    case kPush: SSLAP_QUEUE(kPush); break;
    case kDual: SSLAP_QUEUE(kDual); break;
    case kAlias3: SSLAP_QUEUE(kAlias3); break;
    case kAlias2: SSLAP_QUEUE(kAlias2); break;
    case kBitcast: SSLAP_QUEUE(kBitcast); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSLAP_QUEUE
  return static_cast<int>(cudaGetLastError());
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
