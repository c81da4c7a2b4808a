// K7 take_along (f32): out[m, l] = tbl[idx[m, l], l], numpy's
// take_along_axis along axis 0, the lookup of the launch-cost calibration.
//
// Replaces the Pallas probe scripts/microbench_calib.py:ta (:84, kernel
// :81-82), which asked whether an in-VMEM take_along_axis lowers on the TPU
// and what one lookup costs against a fitted fixed overhead.  On Hopper the
// lookup is a plain indexed load.
//
// Bound: device-memory bandwidth.  At the probe's shapes (tbl (192, 128),
// idx (4608, 128)) a call reads 2.36 MB of indices and the 98 KB table and
// writes 2.36 MB: ~4.8 MB, ~1.4 us at 3.35 TB/s, far below the cost of
// launching it; what it times is the launch floor.
// Design: one thread per output element, flat index i = m * L + l, so the
// index read and the output write are coalesced; the table read tbl[r * L
// + l] keeps l contiguous across a warp and hits L1/L2, where the whole
// table stays resident.  Indices must lie in [0, S): a row outside it
// writes NaN instead of reading out of bounds.
#include "common.cuh"

#include <math_constants.h>

namespace {

__global__ void __launch_bounds__(rdc::kThreads) take_along_kernel(
    const float* __restrict__ tbl, const int* __restrict__ idx,
    float* __restrict__ out, int S, int L, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int l = static_cast<int>(i % L);
  const int r = idx[i];
  out[i] = (r >= 0 && r < S) ? __ldg(tbl + static_cast<size_t>(r) * L + l)
                             : CUDART_NAN_F;
}

}  // namespace

extern "C" int rdc_take_along_f32(const float* tbl, const int* idx,
                                  float* out, int S, int M, int L,
                                  void* stream) {
  const size_t total = static_cast<size_t>(M) * L;
  if (total == 0) return cudaSuccess;
  const size_t grid = (total + rdc::kThreads - 1) / rdc::kThreads;
  if (grid > 0x7fffffffULL) return cudaErrorInvalidValue;
  take_along_kernel<<<static_cast<unsigned>(grid), rdc::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(tbl, idx, out, S,
                                                           L, total);
  return cudaGetLastError();
}
