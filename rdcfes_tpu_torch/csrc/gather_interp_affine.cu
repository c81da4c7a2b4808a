// K1 gather_interp_affine (f64 and f32): corner gather + affine
// interpolation.
//
// Replaces rdcfes_tpu/fem/pallas_df64.py:interp_affine_df64 (:334, body
// _interp_affine_kernel :109-145) together with the corner gathers that fed
// the coefficient build, pallas_perm.py:gather_corners_f64 (:274) and
// gather_corners_f64_pair (:285).  On the TPU the gather was a Beneš
// permutation and f64 was emulated as hi/lo f32 pairs; Hopper loads
// u[v, conn[e, k]] directly and computes in native f64.  The f32 instances
// serve the transient systems' dtype=float32 mode, whose corner gather the
// reference ran through gather_corners (pallas_perm.py:244) and whose
// interpolation it left to XLA in f32: they read and write f32 and
// accumulate in f32, phi cast to f32 where it is read.  One template
// serves both precisions; the f64 instances are the code they were before
// the template (the cast of a double to double is the identity, and phi
// is read from the parameters as before).
//
// Per element e and species v:
//   u_qp[v, q, e] = sum_k phi[q, k]       u[v, conn_T[k, e]]
//   gx[v, d, e]   = sum_k dphi0[k, d, e]  u[v, conn_T[k, e]]
//
// One instance per affine element type, <K, Q> = TET4 (4, 5) and TRI3
// (3, 4); a TRI3 gradient's z is zero and is computed like the others.
//
// Bound: device-memory bandwidth (~0.2 flop per byte).  Bytes per call at
// bench shapes (V=5, K=4, Q=5, E=131,712, N=24,389): conn_T 2.1 MB and
// dphi0 12.6 MB read, u_qp 26.3 MB and gx 15.8 MB written, u 1.0 MB read
// through L2 (it stays resident): ~58 MB, ~17 us at 3.35 TB/s; f32 moves
// half the float bytes, ~30 MB, ~9 us.
// Design: one thread per element.  The element's node ids and gradient
// table are loaded once into registers and reused for every species;
// consecutive threads touch consecutive e, so every plane access is
// coalesced and only the u gather is indexed; phi rides in the parameters.
#include "common.cuh"

namespace {

template <typename T, int K, int Q>
__global__ void __launch_bounds__(rdc::kThreads) gather_interp_affine_kernel(
    const T* __restrict__ u, const int* __restrict__ conn_T,
    const T* __restrict__ dphi0, T* __restrict__ u_qp, T* __restrict__ gx,
    rdc::PhiTable phi, int V, int N, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);
  int node[K];
  T g[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    node[k] = conn_T[k * sE + e];
#pragma unroll
    for (int d = 0; d < 3; ++d) g[k][d] = dphi0[(k * 3 + d) * sE + e];
  }
  for (int v = 0; v < V; ++v) {
    const T* uv = u + static_cast<size_t>(v) * N;
    T ue[K];
#pragma unroll
    for (int k = 0; k < K; ++k) ue[k] = __ldg(uv + node[k]);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      T acc = static_cast<T>(phi.v[q * K]) * ue[0];
#pragma unroll
      for (int k = 1; k < K; ++k)
        acc += static_cast<T>(phi.v[q * K + k]) * ue[k];
      u_qp[(static_cast<size_t>(v) * Q + q) * sE + e] = acc;
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      T acc = g[0][d] * ue[0];
#pragma unroll
      for (int k = 1; k < K; ++k) acc += g[k][d] * ue[k];
      gx[(static_cast<size_t>(v) * 3 + d) * sE + e] = acc;
    }
  }
}

template <typename T>
int launch(const T* u, const int* conn_T, const double* phi_host,
           const T* dphi0, T* u_qp, T* gx, int V, int N, int K, int Q, int E,
           void* stream) {
  if (!rdc::affine_kq(K, Q) || V < 1) return cudaErrorInvalidValue;
  if (E == 0) return cudaSuccess;
  const rdc::PhiTable phi = rdc::phi_table(phi_host, K, Q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 4)
    gather_interp_affine_kernel<T, 4, 5>
        <<<rdc::blocks_for(E), rdc::kThreads, 0, st>>>(u, conn_T, dphi0,
                                                       u_qp, gx, phi, V, N,
                                                       E);
  else
    gather_interp_affine_kernel<T, 3, 4>
        <<<rdc::blocks_for(E), rdc::kThreads, 0, st>>>(u, conn_T, dphi0,
                                                       u_qp, gx, phi, V, N,
                                                       E);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rdc_gather_interp_affine_f64(
    const double* u, const int* conn_T, const double* phi_host,
    const double* dphi0, double* u_qp, double* gx, int V, int N, int K,
    int Q, int E, void* stream) {
  return launch<double>(u, conn_T, phi_host, dphi0, u_qp, gx, V, N, K, Q, E,
                        stream);
}

extern "C" int rdc_gather_interp_affine_f32(
    const float* u, const int* conn_T, const double* phi_host,
    const float* dphi0, float* u_qp, float* gx, int V, int N, int K, int Q,
    int E, void* stream) {
  return launch<float>(u, conn_T, phi_host, dphi0, u_qp, gx, V, N, K, Q, E,
                       stream);
}
