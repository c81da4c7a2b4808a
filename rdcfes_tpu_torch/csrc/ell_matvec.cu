// K5 ell_matvec (f32 and f64): the block-ELL sparse matrix-vector product
// of the solid Newton solve's Krylov loop.
//
// Replaces rdcfes_tpu/fem/bcsr.py:ell_matvec_fast (:60), whose x-gather ran
// through the Beneš permutation kernels of fem/pallas_perm.py
// (gather_corners :244, gather_corners_f64 :274) because XLA gathers were
// slow on the TPU.  Hopper has indexed loads, so x is gathered directly
// through the column table and nothing of the routing survives.
//
//   y[v, n] = sum_{l = 0..L-1} sum_{w = 0..W-1}
//             values[v, w, l, n] * x[w, cols[l, n]]
//
// Layouts are channel-first with the node axis minor: values (V, W, L, N),
// cols (L, N) int32, x (W, N), y (V, N).  Pad slots carry a zero value
// block (and a valid column), so every slot is summed alike.
//
// Bound: device-memory bandwidth.  Each value is read once, coalesced
// along n; at the solid bench (V = W = 3, L = 27, N = 117,649) the values
// are 114.4 MB in f32 and 228.7 MB in f64, the column table 12.7 MB, x and
// y 1.4 (2.8) MB each: ~130 MB (f32) / ~247 MB (f64) per call, 39 / 74 us
// at 3.35 TB/s.  Two flops per value, so ~0.06 flop/byte: far below the
// card's ridge point in either precision.
// Design: one thread per (node, output row v), v on blockIdx.y, so a
// launch has V*N threads in flight (3 x 117k) for memory-level
// parallelism.  The column table and x are re-read by the V rows of a
// node; both stay in L2 (12.7 MB + 2.8 MB of its 50 MB).  The sum runs over
// l, then w, in that fixed order, in registers: no atomics, deterministic.
#include "common.cuh"

namespace {

template <typename T, int W>
__global__ void __launch_bounds__(rdc::kThreads) ell_matvec_kernel(
    const T* __restrict__ values, const int* __restrict__ cols,
    const T* __restrict__ x, T* __restrict__ y, int L, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int v = blockIdx.y;
  const size_t plane = static_cast<size_t>(L) * N;  // one (v, w) block
  const T* val = values + static_cast<size_t>(v) * W * plane + n;
  T acc = T(0);
  for (int l = 0; l < L; ++l) {
    const int c = __ldg(cols + static_cast<size_t>(l) * N + n);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      acc += __ldg(val + w * plane + static_cast<size_t>(l) * N) *
             __ldg(x + static_cast<size_t>(w) * N + c);
    }
  }
  y[static_cast<size_t>(v) * N + n] = acc;
}

template <typename T, int W>
int launch_w(const T* values, const int* cols, const T* x, T* y, int V,
             int L, int N, cudaStream_t stream) {
  const dim3 grid(rdc::blocks_for(N), static_cast<unsigned>(V));
  ell_matvec_kernel<T, W><<<grid, rdc::kThreads, 0, stream>>>(
      values, cols, x, y, L, N);
  return cudaGetLastError();
}

template <typename T>
int launch_ell_matvec(const T* values, const int* cols, const T* x, T* y,
                      int V, int W, int L, int N, void* stream) {
  if (V < 1 || V > 65535 || W < 1 || W > rdc::kMaxV || L < 1)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch_w<T, 1>(values, cols, x, y, V, L, N, s);
    case 2: return launch_w<T, 2>(values, cols, x, y, V, L, N, s);
    case 3: return launch_w<T, 3>(values, cols, x, y, V, L, N, s);
    case 4: return launch_w<T, 4>(values, cols, x, y, V, L, N, s);
    case 5: return launch_w<T, 5>(values, cols, x, y, V, L, N, s);
    case 6: return launch_w<T, 6>(values, cols, x, y, V, L, N, s);
    case 7: return launch_w<T, 7>(values, cols, x, y, V, L, N, s);
    default: return launch_w<T, 8>(values, cols, x, y, V, L, N, s);
  }
}

}  // namespace

extern "C" int rdc_ell_matvec_f32(const float* values, const int* cols,
                                  const float* x, float* y, int V, int W,
                                  int L, int N, void* stream) {
  return launch_ell_matvec<float>(values, cols, x, y, V, W, L, N, stream);
}

extern "C" int rdc_ell_matvec_f64(const double* values, const int* cols,
                                  const double* x, double* y, int V, int W,
                                  int L, int N, void* stream) {
  return launch_ell_matvec<double>(values, cols, x, y, V, W, L, N, stream);
}
