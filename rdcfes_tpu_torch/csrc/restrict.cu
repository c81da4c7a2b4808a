// K4 restrict (f32 and f64): element corners -> nodes, as a node-parallel
// gather-sum through the padded inverse incidence table.
//
// Replaces rdcfes_tpu/fem/pallas_perm.py:grid_permute_reduce (:203, body
// _perm_reduce_kernel :189; the f32 inner matvec), grid_permute (:184; the
// right-hand side) and grid_permute_f64 (:298; the f64 outer matvec).  On
// the TPU the restriction was a Beneš permutation into (incidence, node)
// order followed by a sum over incidences; Hopper gathers directly.
//
//   y[w, n] = sum_{c = 0..C-1, node_gather[c, n] != K*E}
//             flat[w, node_gather[c, n]]
//
// The sum runs over c in order and skips the pad index K*E, so the result
// equals the plain version bit for bit.  No atomics: deterministic.
//
// Bound: device-memory bandwidth and the latency of the indexed loads.
// Bytes per call at bench shapes (C=24, N=24,389, K*E=526,848): node_gather
// 2.3 MB, flat W*K*E*sizeof(T) (f32 matvec W=5: 10.5 MB; f64 rhs W=5:
// 21.1 MB; f64 block-Jacobi diagonal W=25: 105 MB), y W*N*sizeof(T).
// Each flat value is read once, but as a scattered 4- or 8-byte load.
// Design: one thread per (node, channel); node_gather reads are coalesced
// along n and shared by the W channels through L1/L2; nodes of neighbouring
// ids touch neighbouring elements in the structured orderings the meshes
// carry, which keeps most scattered loads within a few cache lines.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rdc::kThreads) restrict_kernel(
    const T* __restrict__ flat, const int* __restrict__ node_gather,
    T* __restrict__ y, int C, int N, int KE) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const T* f = flat + static_cast<size_t>(blockIdx.y) * KE;
  T acc = T(0);
  for (int c = 0; c < C; ++c) {
    const int i = node_gather[static_cast<size_t>(c) * N + n];
    if (static_cast<unsigned>(i) < static_cast<unsigned>(KE)) acc += f[i];
  }
  y[static_cast<size_t>(blockIdx.y) * N + n] = acc;
}

template <typename T>
int launch_restrict(const T* flat, const int* node_gather, T* y, int W,
                    int C, int N, int KE, void* stream) {
  if (W < 1 || W > 65535) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const dim3 grid(rdc::blocks_for(N), static_cast<unsigned>(W));
  restrict_kernel<T><<<grid, rdc::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      flat, node_gather, y, C, N, KE);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rdc_restrict_f32(const float* flat, const int* node_gather,
                                float* y, int W, int C, int N, int KE,
                                void* stream) {
  return launch_restrict<float>(flat, node_gather, y, W, C, N, KE, stream);
}

extern "C" int rdc_restrict_f64(const double* flat, const int* node_gather,
                                double* y, int W, int C, int N, int KE,
                                void* stream) {
  return launch_restrict<double>(flat, node_gather, y, W, C, N, KE, stream);
}
