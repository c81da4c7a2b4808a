// K2 rhs_affine (f64 and f32): element right-hand side of an affine
// element.
//
// Replaces rdcfes_tpu/fem/pallas_df64.py:rhs_affine_df64 (:240, body
// _rhs_affine_kernel :167-237), which computed the same sums in paired f32
// because the TPU has no f64 units; here they run in native f64.  It is the
// counterpart of fem/weakform.block_rhs_affine.  The f32 instances build the
// right-hand side of the transient systems' dtype=float32 mode, which the
// reference leaves to XLA in f32 (df64 serves f64 only,
// rdcfes_tpu/systems/transient.py:782-784): f32 in and out, f32 sums, phi
// cast to f32 where it is read.  One template serves both precisions; the
// f64 instances are the code they were before it (a double cast to double
// is the identity).
//
//   Fe[v, k, e] = sum_q (JxW[q, e] phi[q, k]) A[v][q, e]
//               + sum_d dphi0[k, d, e] (sum_q JxW[q, e] B[v][q, d, e])
//
// A (nA, Q, E) and B (nB, Q, 3, E) stack the live blocks; slot tables map a
// species to its plane (-1 = structurally absent, contributes nothing; a
// species with neither block gets zeros).
//
// One instance per affine element type, <K, Q> = TET4 (4, 5) and TRI3
// (3, 4); TRI3's negative centroid weight (-27/96) enters JxW like any
// other, so nothing here assumes JxW > 0.
//
// Bound: device-memory bandwidth (~0.3 flop per byte).  Bytes per call at
// bench shapes (PIHNA deck: nA=5, nB=1, E=131,712): A 26.3 MB, B 15.8 MB,
// JxW 5.3 MB, dphi0 12.6 MB read, Fe 21.1 MB written: ~81 MB, ~24 us at
// 3.35 TB/s; f32 half of it, ~41 MB, ~12 us.
// Design: one thread per element; JxW and the gradient table are loaded
// once into registers and shared by all species, every plane access is
// coalesced along e, and absent blocks cost neither bytes nor flops.
#include "common.cuh"

namespace {

struct RhsSlots {
  int a[rdc::kMaxV];
  int b[rdc::kMaxV];
};

template <typename T, int K, int Q>
__global__ void __launch_bounds__(rdc::kThreads) rhs_affine_kernel(
    const T* __restrict__ A, const T* __restrict__ B,
    const T* __restrict__ JxW, const T* __restrict__ dphi0,
    T* __restrict__ Fe, RhsSlots s, rdc::PhiTable phi, int V, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);
  T jxw[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) jxw[q] = JxW[q * sE + e];
  T g[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int d = 0; d < 3; ++d) g[k][d] = dphi0[(k * 3 + d) * sE + e];

  for (int v = 0; v < V; ++v) {
    const int sa = s.a[v];
    const int sb = s.b[v];
    T a[Q];
    T bsum[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int q = 0; q < Q; ++q)
      a[q] = sa >= 0 ? A[(static_cast<size_t>(sa) * Q + q) * sE + e] : T(0);
    if (sb >= 0) {
      const T* Bp = B + static_cast<size_t>(sb) * Q * 3 * sE + e;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T acc = jxw[0] * Bp[d * sE];
#pragma unroll
        for (int q = 1; q < Q; ++q) acc += jxw[q] * Bp[(q * 3 + d) * sE];
        bsum[d] = acc;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < Q; ++q)
        acc += (jxw[q] * static_cast<T>(phi.v[q * K + k])) * a[q];
#pragma unroll
      for (int d = 0; d < 3; ++d) acc += g[k][d] * bsum[d];
      Fe[(static_cast<size_t>(v) * K + k) * sE + e] = acc;
    }
  }
}

template <typename T>
int launch(const T* A, const T* B, const int* slots_host, const T* JxW,
           const double* phi_host, const T* dphi0, T* Fe, int V, int K, int Q,
           int E, void* stream) {
  if (!rdc::affine_kq(K, Q) || V < 1 || V > rdc::kMaxV)
    return cudaErrorInvalidValue;
  if (E == 0) return cudaSuccess;
  RhsSlots s;
  for (int i = 0; i < rdc::kMaxV; ++i) {
    s.a[i] = slots_host[i];
    s.b[i] = slots_host[rdc::kMaxV + i];
  }
  const rdc::PhiTable phi = rdc::phi_table(phi_host, K, Q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 4)
    rhs_affine_kernel<T, 4, 5><<<rdc::blocks_for(E), rdc::kThreads, 0, st>>>(
        A, B, JxW, dphi0, Fe, s, phi, V, E);
  else
    rhs_affine_kernel<T, 3, 4><<<rdc::blocks_for(E), rdc::kThreads, 0, st>>>(
        A, B, JxW, dphi0, Fe, s, phi, V, E);
  return cudaGetLastError();
}

}  // namespace

// slots_host: int32[2 * kMaxV] on the host, rows a then b.
extern "C" int rdc_rhs_affine_f64(
    const double* A, const double* B, const int* slots_host,
    const double* JxW, const double* phi_host, const double* dphi0,
    double* Fe, int V, int K, int Q, int E, void* stream) {
  return launch<double>(A, B, slots_host, JxW, phi_host, dphi0, Fe, V, K, Q,
                        E, stream);
}

extern "C" int rdc_rhs_affine_f32(
    const float* A, const float* B, const int* slots_host, const float* JxW,
    const double* phi_host, const float* dphi0, float* Fe, int V, int K,
    int Q, int E, void* stream) {
  return launch<float>(A, B, slots_host, JxW, phi_host, dphi0, Fe, V, K, Q,
                       E, stream);
}
