// K8 gather_interp_generic (f64 and f32): corner gather + interpolation with
// per-q shape gradients, K1's counterpart for non-affine elements: one
// instance per element type, (K, Q) = HEX8 (8, 8), PRISM6 (6, 8),
// PYRAMID5 (5, 8), TET10 (10, 14), QUAD4 (4, 4), QUAD8 (8, 9), QUAD9
// (9, 9), HEX20 (20, 27) and HEX27 (27, 27).
//
// Replaces the corner gather in front of the generic coefficient build,
// rdcfes_tpu/fem/pallas_perm.py:gather_corners_f64 (:274) as
// systems/transient.py:805-811 (gather_ue_fast) uses it, together with the
// interpolate_ue (fem/assembly.py:303) that follows it there.  On the TPU
// the gather was a Beneš permutation of hi/lo f32 planes and the
// interpolation was left to XLA; Hopper loads u[v, conn_T[k, e]] directly
// and interpolates in the same pass, in native f64.  The f32 instances
// serve the transient systems' dtype=float32 mode, whose gather the
// reference ran through gather_corners (pallas_perm.py:244) with the
// interpolation in XLA f32: f32 in and out, f32 sums, phi cast to f32 (in
// the parameters, or a device copy in f32).  One template serves both
// precisions; the f64 instances are the code they were before it.
//
// Per element e, species v and quadrature point q:
//   u_qp[v, q, e]  = sum_k phi[q, k]         u[v, conn_T[k, e]]
//   gx[v, q, d, e] = sum_k dphi[q, k, d, e]  u[v, conn_T[k, e]]
//
// Bound: device-memory bandwidth.  On 110,592 HEX8 with 5 species a call
// reads dphi 169.9 MB and conn_T 3.5 MB, writes u_qp 35.4 MB and gx
// 106.2 MB, and reads u 4.7 MB through L2: ~320 MB, ~95 us at 3.35 TB/s.
// On 131,712 TET10 (K 10, Q 14) the same terms are 442.6 + 5.3 + 73.8 +
// 221.3 + 7.4 MB, ~750 MB.  f32 moves half the float bytes.
// Design: one thread per element, <K, Q> template parameters.  The q loop
// is outermost and stays rolled: one iteration holds dphi[q] (3 K values)
// in registers and serves every species from it, so dphi is read exactly
// once; the element's node ids stay in registers and the corner values
// are re-read per q through L1/L2 (u is small and stays resident).  Every
// plane access is coalesced along e; phi rides in the kernel parameters.
// Above K = 10 (HEX20, HEX27) the 3 K gradient values of a q would take
// 120-162 f64 registers, and the few elements of a mesh (13,824 HEX27 at
// 24^3: 108 blocks of one thread an element, under one an SM) would
// leave the card idle; so there a thread takes one (element, q), q the
// grid's y index (27 times the threads), and walks k in a rolled loop:
// each gradient row is read once into three registers and added into
// every species' four sums (kMaxV of each, in registers), in the same
// order over k, the corner's node id read through L1; phi (540 or 729
// entries, past the parameters' room) is read from a device copy, with
// warp-uniform loads.
#include "common.cuh"

namespace {

using rdc::kMaxQK;
using rdc::kRegRows;

// phi in T: in the kernel parameters while K * Q <= kMaxQK, else a device
// copy (in T) the caller keeps
template <typename T, int K, int Q, bool InParams = (Q * K <= kMaxQK)>
struct PhiKQ {
  T v[Q * K];
  __device__ __forceinline__ T at(int i) const { return v[i]; }
  void set(const double* host, const T*) {
    for (int i = 0; i < Q * K; ++i) v[i] = static_cast<T>(host[i]);
  }
};

template <typename T, int K, int Q>
struct PhiKQ<T, K, Q, false> {
  const T* v;
  __device__ __forceinline__ T at(int i) const { return __ldg(v + i); }
  void set(const double*, const T* dev) { v = dev; }
};

template <typename T, int K, int Q>
__global__ void __launch_bounds__(rdc::kThreads) gather_interp_generic_kernel(
    const T* __restrict__ u, const int* __restrict__ conn_T,
    const T* __restrict__ dphi, T* __restrict__ u_qp, T* __restrict__ gx,
    PhiKQ<T, K, Q> phi, int V, int N, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);

  if constexpr (K > kRegRows) {
    // one thread per (element, q): q is the grid's y index
    constexpr int M = rdc::kMaxV;
    const int q = blockIdx.y;
    T ax[M], a0[M], a1[M], a2[M];
#pragma unroll
    for (int v = 0; v < M; ++v) ax[v] = a0[v] = a1[v] = a2[v] = T(0);
    const T* gq = dphi + static_cast<size_t>(q) * K * 3 * sE + e;
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const T g0 = gq[3 * k * sE], g1 = gq[(3 * k + 1) * sE],
              g2 = gq[(3 * k + 2) * sE];
      const T p = phi.at(q * K + k);
      const int n = __ldg(conn_T + k * sE + e);
#pragma unroll
      for (int v = 0; v < M; ++v) {
        if (v < V) {
          const T c = __ldg(u + static_cast<size_t>(v) * N + n);
          ax[v] += p * c;
          a0[v] += g0 * c;
          a1[v] += g1 * c;
          a2[v] += g2 * c;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < M; ++v) {
      if (v < V) {
        const size_t vq = static_cast<size_t>(v) * Q + q;
        u_qp[vq * sE + e] = ax[v];
        gx[(vq * 3 + 0) * sE + e] = a0[v];
        gx[(vq * 3 + 1) * sE + e] = a1[v];
        gx[(vq * 3 + 2) * sE + e] = a2[v];
      }
    }
    return;
  }

  int node[K];
#pragma unroll
  for (int k = 0; k < K; ++k) node[k] = conn_T[k * sE + e];

#pragma unroll 1
  for (int q = 0; q < Q; ++q) {
    T g[K][3];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        g[k][d] = dphi[((static_cast<size_t>(q) * K + k) * 3 + d) * sE + e];
#pragma unroll 1
    for (int v = 0; v < V; ++v) {
      const T* uv = u + static_cast<size_t>(v) * N;
      T c = __ldg(uv + node[0]);
      T ax = phi.at(q * K) * c;
      T a0 = g[0][0] * c, a1 = g[0][1] * c, a2 = g[0][2] * c;
#pragma unroll
      for (int k = 1; k < K; ++k) {
        c = __ldg(uv + node[k]);
        ax += phi.at(q * K + k) * c;
        a0 += g[k][0] * c;
        a1 += g[k][1] * c;
        a2 += g[k][2] * c;
      }
      const size_t vq = static_cast<size_t>(v) * Q + q;
      u_qp[vq * sE + e] = ax;
      gx[(vq * 3 + 0) * sE + e] = a0;
      gx[(vq * 3 + 1) * sE + e] = a1;
      gx[(vq * 3 + 2) * sE + e] = a2;
    }
  }
}

template <typename T, int K, int Q>
cudaError_t launch_kq(const T* u, const int* conn_T, const double* phi_host,
                      const T* phi_dev, const T* dphi, T* u_qp, T* gx, int V,
                      int N, int E, cudaStream_t st) {
  if ((Q * K > kMaxQK && phi_dev == nullptr) ||
      (K > kRegRows && V > rdc::kMaxV))
    return cudaErrorInvalidValue;
  PhiKQ<T, K, Q> ph;
  ph.set(phi_host, phi_dev);
  // above kRegRows a thread takes one (element, q): Q blocks along y
  const dim3 grid(rdc::blocks_for(E), K > kRegRows ? Q : 1);
  gather_interp_generic_kernel<T, K, Q>
      <<<grid, rdc::kThreads, 0, st>>>(u, conn_T, dphi, u_qp, gx, ph, V, N,
                                       E);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* u, const int* conn_T, const double* phi_host,
           const T* phi_dev, const T* dphi, T* u_qp, T* gx, int V, int N,
           int K, int Q, int E, void* stream) {
  if (V < 1) return cudaErrorInvalidValue;
  if (E == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one line per element type, as csrc/apply_generic.cu
#define RDC_GATHER_KQ(KK, QQ)                                                 \
  if (K == KK && Q == QQ)                                                     \
    return launch_kq<T, KK, QQ>(u, conn_T, phi_host, phi_dev, dphi, u_qp, gx, \
                                V, N, E, st);
  RDC_GATHER_KQ(8, 8)
  RDC_GATHER_KQ(6, 8)
  RDC_GATHER_KQ(5, 8)
  RDC_GATHER_KQ(10, 14)
  RDC_GATHER_KQ(4, 4)
  RDC_GATHER_KQ(8, 9)
  RDC_GATHER_KQ(9, 9)
  RDC_GATHER_KQ(20, 27)
  RDC_GATHER_KQ(27, 27)
#undef RDC_GATHER_KQ
  return cudaErrorInvalidValue;
}

}  // namespace

// phi_host: double[Q * K] on the host, row-major; phi_dev: the same
// table on the device in the kernel's type, read by the instances whose
// K * Q exceeds kMaxQK.
extern "C" int rdc_gather_interp_generic_f64(
    const double* u, const int* conn_T, const double* phi_host,
    const double* phi_dev, const double* dphi, double* u_qp, double* gx,
    int V, int N, int K, int Q, int E, void* stream) {
  return launch<double>(u, conn_T, phi_host, phi_dev, dphi, u_qp, gx, V, N,
                        K, Q, E, stream);
}

extern "C" int rdc_gather_interp_generic_f32(
    const float* u, const int* conn_T, const double* phi_host,
    const float* phi_dev, const float* dphi, float* u_qp, float* gx, int V,
    int N, int K, int Q, int E, void* stream) {
  return launch<float>(u, conn_T, phi_host, phi_dev, dphi, u_qp, gx, V, N, K,
                       Q, E, stream);
}
