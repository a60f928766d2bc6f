// P4-P5: a scalar read then a scalar write at dynamic indices of an int32
// table (sm_90a).
//
// Replaces benchmarks/probe_mosaic_gs.py::lane_read_write (:122, a rank-1
// [512] table) and ::lane_read_write_2d (:159, a [4, 128] table): val =
// t[idx]; t[widx] = 7 * val; out[0] = val, on the flat index.  The table
// stays in global memory and is read and written with plain scalar
// accesses.  The probes' one-hot lane read (a dynamic row load + masked
// lane reduce) and blend store (row load, masked select, row store) worked
// around Mosaic's missing dynamic scalar VMEM access; a GPU thread
// addresses any word, so they have no job here, as ROADMAP records for the
// other TPU workarounds.  Both layouts are one flat table to this kernel.
//
// Bound: two dependent global round trips (the write depends on the read)
// in one thread.  Nothing to overlap; the design is the shortest chain.
#include "common.cuh"

namespace {

__global__ void probe_lane_kernel(int32_t* table, int64_t idx, int64_t widx,
                                  int32_t* out) {
  const int32_t val = table[idx];
  table[widx] = static_cast<int32_t>(7u * static_cast<uint32_t>(val));
  out[0] = val;
}

}  // namespace

extern "C" int sslap_probe_lane(int32_t* table, int64_t idx, int64_t widx,
                                int32_t* out, void* stream) {
  probe_lane_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      table, idx, widx, out);
  return static_cast<int>(cudaGetLastError());
}
