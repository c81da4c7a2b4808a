// K6 apply_generic (f32 and f64): the matrix-free element apply of the
// Krylov matvec for elements whose shape gradients differ per quadrature
// point (HEX8), with the corner gather fused into its prologue.
//
// Replaces rdcfes_tpu/fem/pallas_apply.py:qp_apply_fused (:263, body
// _apply_kernel :209-260) and the Beneš corner gathers in front of it
// (pallas_perm.py:gather_corners :244, gather_corners_f64 :274).  One
// template serves the f32 inner and the f64 outer matvec.  It is the
// counterpart of interpolate_ue(x[:, conn_T]) + qp_apply.
//
// Per element e (live blocks only), with n_k = conn_T[k, e]:
//   x_qp[w, q]  = sum_k phi[q, k] x[w, n_k]
//   gx[w, q, d] = sum_k dphi[q, k, d, e] x[w, n_k]
//   a[v, q]     = sum_w C[v,w][q, e] x_qp[w, q]
//   b[v, q, d]  = sum_w D[v,w][q, d, e] x_qp[w, q]
//               + sum_w E[v,w][q, e] gx[w, q, d]
//   Ye[v, k, e] = sum_q JxW[q, e] (phi[q, k] a[v, q]
//                                  + sum_d dphi[q, k, d, e] b[v, q, d])
//
// Bound: device-memory bandwidth (under 1 flop per byte).  dphi is
// Q*K*3*E values and is read once; each C or E plane is Q*E, each D plane
// 3*Q*E.  On 110,592 HEX8 with the PIHNA deck's 20 C, 4 D and 1 E plane an
// f32 call streams dphi 84.9 MB + C 70.8 MB + D 42.5 MB + E 3.5 MB + JxW
// 3.5 MB + conn_T 3.5 MB and writes Ye 17.7 MB: ~226 MB, ~68 us at
// 3.35 TB/s; f64 moves twice the float bytes.
// Design: one thread per element, <T, V, K, Q> template parameters.  The
// q loop is outermost and stays rolled: one iteration holds dphi[q] (3 K
// values), x_qp[., q] and gx[., q, .] (4 V) in registers and accumulates
// into Ye[V][K], so nothing of size V*Q*3 is ever live.  The gathered
// corner values ue[V][K] live in shared memory, one column per thread
// (stride blockDim.x, conflict-free), which leaves the registers to the
// accumulators; every coefficient plane is read exactly once, coalesced
// along e; the (v, w) -> plane slot tables and the phi table ride in the
// kernel parameters (warp-uniform branches), so absent blocks cost
// nothing; x (V, N) is read through L2.
#include "common.cuh"

namespace {

struct GenericSlots {
  int c[rdc::kMaxV * rdc::kMaxV];
  int d[rdc::kMaxV * rdc::kMaxV];
  int e[rdc::kMaxV * rdc::kMaxV];
};

// phi[q][k] in the kernel's own type, sized by the element's K and Q
// (rdc::PhiTable is TET4's).
template <typename T, int K, int Q>
struct PhiKQ {
  T v[Q * K];
};

template <typename T, int V, int K, int Q>
__global__ void __launch_bounds__(rdc::kThreads) apply_generic_kernel(
    const T* __restrict__ x, const int* __restrict__ conn_T,
    const T* __restrict__ JxW, const T* __restrict__ dphi,
    const T* __restrict__ C, const T* __restrict__ D,
    const T* __restrict__ Es, T* __restrict__ Ye, GenericSlots s,
    PhiKQ<T, K, Q> phi, int N, int E) {
  constexpr int M = rdc::kMaxV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ue = reinterpret_cast<T*>(smem_raw);  // [V * K][blockDim.x]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int e = blockIdx.x * nt + tid;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);

  // prologue: corner gather of every species
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int node = conn_T[k * sE + e];
#pragma unroll
    for (int w = 0; w < V; ++w)
      ue[(w * K + k) * nt + tid] =
          __ldg(x + static_cast<size_t>(w) * N + node);
  }

  T acc[V][K];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[v][k] = T(0);

#pragma unroll 1
  for (int q = 0; q < Q; ++q) {
    const T jw = JxW[q * sE + e];
    T g[K][3];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        g[k][d] = dphi[((static_cast<size_t>(q) * K + k) * 3 + d) * sE + e];
    T ph[K];
#pragma unroll
    for (int k = 0; k < K; ++k) ph[k] = phi.v[q * K + k];

    // interpolation of every species at this q
    T xq[V];
    T gx[V][3];
#pragma unroll
    for (int w = 0; w < V; ++w) {
      T u = ue[(w * K) * nt + tid];
      T ax = ph[0] * u;
      T a0 = g[0][0] * u, a1 = g[0][1] * u, a2 = g[0][2] * u;
#pragma unroll
      for (int k = 1; k < K; ++k) {
        u = ue[(w * K + k) * nt + tid];
        ax += ph[k] * u;
        a0 += g[k][0] * u;
        a1 += g[k][1] * u;
        a2 += g[k][2] * u;
      }
      xq[w] = ax;
      gx[w][0] = a0;
      gx[w][1] = a1;
      gx[w][2] = a2;
    }

    // responses of every species, projected back at once
#pragma unroll
    for (int v = 0; v < V; ++v) {
      T a = T(0);
      T b[3] = {T(0), T(0), T(0)};
      bool live = false;
#pragma unroll
      for (int w = 0; w < V; ++w) {
        const int sc = s.c[v * M + w];
        if (sc >= 0) {
          a += C[(static_cast<size_t>(sc) * Q + q) * sE + e] * xq[w];
          live = true;
        }
        const int sd = s.d[v * M + w];
        if (sd >= 0) {
          const T* Dp = D + (static_cast<size_t>(sd) * Q + q) * 3 * sE + e;
#pragma unroll
          for (int d = 0; d < 3; ++d) b[d] += Dp[d * sE] * xq[w];
          live = true;
        }
        const int se = s.e[v * M + w];
        if (se >= 0) {
          const T ev = Es[(static_cast<size_t>(se) * Q + q) * sE + e];
#pragma unroll
          for (int d = 0; d < 3; ++d) b[d] += ev * gx[w][d];
          live = true;
        }
      }
      if (live) {
        a *= jw;
#pragma unroll
        for (int d = 0; d < 3; ++d) b[d] *= jw;
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc[v][k] +=
              ph[k] * a + (g[k][0] * b[0] + g[k][1] * b[1] + g[k][2] * b[2]);
      }
    }
  }

#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int k = 0; k < K; ++k)
      Ye[(static_cast<size_t>(v) * K + k) * sE + e] = acc[v][k];
}

template <typename T, int V, int K, int Q>
cudaError_t launch_vkq(const T* x, const int* conn_T, const double* phi_host,
                       const T* JxW, const T* dphi, const T* C, const T* D,
                       const T* Es, const GenericSlots& s, T* Ye, int N,
                       int E, cudaStream_t st) {
  PhiKQ<T, K, Q> ph;
  for (int i = 0; i < Q * K; ++i) ph.v[i] = static_cast<T>(phi_host[i]);
  auto kern = apply_generic_kernel<T, V, K, Q>;
  const size_t smem = sizeof(T) * V * K * rdc::kThreads;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  kern<<<rdc::blocks_for(E), rdc::kThreads, smem, st>>>(
      x, conn_T, JxW, dphi, C, D, Es, Ye, s, ph, N, E);
  return cudaGetLastError();
}

template <typename T, int K, int Q>
cudaError_t launch_kq(const T* x, const int* conn_T, const double* phi_host,
                      const T* JxW, const T* dphi, const T* C, const T* D,
                      const T* Es, const GenericSlots& s, T* Ye, int V,
                      int N, int E, cudaStream_t st) {
#define RDC_GENERIC_CASE(NV)                                              \
  case NV:                                                                \
    return launch_vkq<T, NV, K, Q>(x, conn_T, phi_host, JxW, dphi, C, D,  \
                                   Es, s, Ye, N, E, st);
  switch (V) {
    RDC_GENERIC_CASE(1)
    RDC_GENERIC_CASE(2)
    RDC_GENERIC_CASE(3)
    RDC_GENERIC_CASE(4)
    RDC_GENERIC_CASE(5)
    RDC_GENERIC_CASE(6)
    RDC_GENERIC_CASE(7)
    RDC_GENERIC_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RDC_GENERIC_CASE
}

template <typename T>
int launch_generic(const T* x, const int* conn_T, const double* phi_host,
                   const T* JxW, const T* dphi, const T* C, const T* D,
                   const T* Es, const int* slots_host, T* Ye, int V, int N,
                   int K, int Q, int E, void* stream) {
  if (E == 0) return cudaSuccess;
  constexpr int MM = rdc::kMaxV * rdc::kMaxV;
  GenericSlots s;
  for (int i = 0; i < MM; ++i) {
    s.c[i] = slots_host[i];
    s.d[i] = slots_host[MM + i];
    s.e[i] = slots_host[2 * MM + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one line per element type: (K, Q) = HEX8 (8, 8); PRISM6 (6, 8),
  // PYRAMID5 (5, 8) and TET10 (10, 14) go here with their element tables
  if (K == 8 && Q == 8)
    return launch_kq<T, 8, 8>(x, conn_T, phi_host, JxW, dphi, C, D, Es, s,
                              Ye, V, N, E, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// slots_host: int32[3 * kMaxV * kMaxV] on the host, the C, D and E tables
// in turn, each row-major (v, w) -> plane index or -1.  phi_host: double
// [Q * K] on the host, row-major.
extern "C" int rdc_apply_generic_f32(
    const float* x, const int* conn_T, const double* phi_host,
    const float* JxW, const float* dphi, const float* C, const float* D,
    const float* Es, const int* slots_host, float* Ye, int V, int N, int K,
    int Q, int E, void* stream) {
  return launch_generic<float>(x, conn_T, phi_host, JxW, dphi, C, D, Es,
                               slots_host, Ye, V, N, K, Q, E, stream);
}

extern "C" int rdc_apply_generic_f64(
    const double* x, const int* conn_T, const double* phi_host,
    const double* JxW, const double* dphi, const double* C, const double* D,
    const double* Es, const int* slots_host, double* Ye, int V, int N,
    int K, int Q, int E, void* stream) {
  return launch_generic<double>(x, conn_T, phi_host, JxW, dphi, C, D, Es,
                                slots_host, Ye, V, N, K, Q, E, stream);
}
