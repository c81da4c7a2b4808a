// K3 apply_affine (f32 and f64): the matrix-free element apply of the
// Krylov matvec on affine elements, with the corner gather fused into its
// prologue.  One instance per affine type, <K, Q> = TET4 (4, 5) and TRI3
// (3, 4); TRI3's gradients have a zero z and its centroid weight is
// negative, neither of which the arithmetic distinguishes.
//
// Replaces rdcfes_tpu/fem/pallas_apply.py:qp_apply_affine_fused (:150, body
// _apply_affine_kernel :105-147) and the Beneš corner gathers in front of
// it, pallas_perm.py:gather_corners (:244) for the f32 inner matvec and
// gather_corners_f64 (:274) for the f64 outer matvec (whose apply ran in
// XLA on the TPU).  One template serves both precisions.  It is the
// counterpart of interpolate_ue_affine(x[:, conn_T]) + qp_apply_affine.
//
// Per element e and species v (live blocks only):
//   x_qp[w, q] = sum_k phi[q, k] x[w, conn_T[k, e]]
//   gx[w, d]   = sum_k dphi0[k, d, e] x[w, conn_T[k, e]]
//   a[q]       = sum_w C[v,w][q] x_qp[w, q]
//   f[d]       = sum_w sum_q JxW[q] D[v,w][q, d] x_qp[w, q]
//              + sum_w Epre[v,w] gx[w, d]
//   Ye[v, k]   = sum_q (JxW[q] phi[q, k]) a[q] + sum_d dphi0[k, d] f[d]
//
// Bound: device-memory bandwidth (~0.5 flop per byte).  The live
// coefficient planes dominate: each C plane is Q*E*sizeof(T) bytes, each D
// plane 3*Q*E*sizeof(T).  At bench shapes (PIHNA deck: 20 C, 4 D, 1 Epre
// plane, E=131,712) one f32 call streams C 52.7 MB + D 31.6 MB + JxW
// 2.6 MB + dphi0 6.3 MB + conn_T 2.1 MB + Epre 0.5 MB and writes Ye
// 10.5 MB: ~106 MB, ~32 us at 3.35 TB/s; f64 moves twice the float bytes,
// ~210 MB, ~63 us.
// Design: one thread per element, V a template parameter so x_qp and gx
// stay in registers; each coefficient plane is read exactly once, coalesced
// along e; the (v, w) -> plane slot tables ride in the kernel parameters
// (warp-uniform branches), so absent blocks cost nothing; x (V, N) is read
// through L2, where it stays resident.  The launch comes from a plan
// (common.cuh) written once per set of stacks.
#include "common.cuh"

namespace {

struct ApplySlots {
  int c[rdc::kMaxV * rdc::kMaxV];
  int d[rdc::kMaxV * rdc::kMaxV];
  int e[rdc::kMaxV * rdc::kMaxV];
};

template <typename T, int V, int K, int Q>
__global__ void __launch_bounds__(rdc::kThreads) apply_affine_kernel(
    const T* __restrict__ x, const int* __restrict__ conn_T,
    const T* __restrict__ JxW, const T* __restrict__ dphi0,
    const T* __restrict__ C, const T* __restrict__ D,
    const T* __restrict__ Ep, T* __restrict__ Ye, ApplySlots s,
    rdc::PhiTable phi, int N, int E) {
  constexpr int M = rdc::kMaxV;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);

  T ph[Q][K];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int k = 0; k < K; ++k) ph[q][k] = static_cast<T>(phi.v[q * K + k]);
  T jxw[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) jxw[q] = JxW[q * sE + e];
  T g[K][3];
  int node[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    node[k] = conn_T[k * sE + e];
#pragma unroll
    for (int d = 0; d < 3; ++d) g[k][d] = dphi0[(k * 3 + d) * sE + e];
  }

  // prologue: corner gather + interpolation of every species
  T xq[V][Q];
  T gw[V][3];
#pragma unroll
  for (int w = 0; w < V; ++w) {
    T ue[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      ue[k] = __ldg(x + static_cast<size_t>(w) * N + node[k]);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      T acc = ph[q][0] * ue[0];
#pragma unroll
      for (int k = 1; k < K; ++k) acc += ph[q][k] * ue[k];
      xq[w][q] = acc;
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      T acc = g[0][d] * ue[0];
#pragma unroll
      for (int k = 1; k < K; ++k) acc += g[k][d] * ue[k];
      gw[w][d] = acc;
    }
  }

#pragma unroll
  for (int v = 0; v < V; ++v) {
    T a[Q];
    T f[3];
#pragma unroll
    for (int q = 0; q < Q; ++q) a[q] = T(0);
#pragma unroll
    for (int d = 0; d < 3; ++d) f[d] = T(0);
#pragma unroll
    for (int w = 0; w < V; ++w) {
      const int sc = s.c[v * M + w];
      if (sc >= 0) {
        const T* Cp = C + static_cast<size_t>(sc) * Q * sE + e;
#pragma unroll
        for (int q = 0; q < Q; ++q) a[q] += Cp[q * sE] * xq[w][q];
      }
      const int sd = s.d[v * M + w];
      if (sd >= 0) {
        const T* Dp = D + static_cast<size_t>(sd) * Q * 3 * sE + e;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          T acc = (jxw[0] * Dp[d * sE]) * xq[w][0];
#pragma unroll
          for (int q = 1; q < Q; ++q)
            acc += (jxw[q] * Dp[(q * 3 + d) * sE]) * xq[w][q];
          f[d] += acc;
        }
      }
      const int se = s.e[v * M + w];
      if (se >= 0) {
        const T ep = Ep[static_cast<size_t>(se) * sE + e];
#pragma unroll
        for (int d = 0; d < 3; ++d) f[d] += ep * gw[w][d];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < Q; ++q) acc += (jxw[q] * ph[q][k]) * a[q];
#pragma unroll
      for (int d = 0; d < 3; ++d) acc += g[k][d] * f[d];
      Ye[(static_cast<size_t>(v) * K + k) * sE + e] = acc;
    }
  }
}

struct AffinePlan {
  const int* conn_T;
  const void* JxW;
  const void* dphi0;
  const void* C;
  const void* D;
  const void* Ep;
  ApplySlots slots;
  rdc::PhiTable phi;
  int V, N, K, Q, E, elem_bytes, device;
};

template <typename T, int K, int Q>
int launch_kq(const AffinePlan& p, const T* x, T* Ye, cudaStream_t st) {
  const T* JxW = static_cast<const T*>(p.JxW);
  const T* dphi0 = static_cast<const T*>(p.dphi0);
  const T* C = static_cast<const T*>(p.C);
  const T* D = static_cast<const T*>(p.D);
  const T* Ep = static_cast<const T*>(p.Ep);
  const unsigned grid = rdc::blocks_for(p.E);
#define RDC_APPLY_CASE(NV)                                               \
  case NV:                                                               \
    apply_affine_kernel<T, NV, K, Q><<<grid, rdc::kThreads, 0, st>>>(    \
        x, p.conn_T, JxW, dphi0, C, D, Ep, Ye, p.slots, p.phi, p.N, p.E); \
    break;
  switch (p.V) {
    RDC_APPLY_CASE(1)
    RDC_APPLY_CASE(2)
    RDC_APPLY_CASE(3)
    RDC_APPLY_CASE(4)
    RDC_APPLY_CASE(5)
    RDC_APPLY_CASE(6)
    RDC_APPLY_CASE(7)
    RDC_APPLY_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RDC_APPLY_CASE
  return cudaGetLastError();
}

template <typename T>
int launch_apply(const void* plan, const T* x, T* Ye, void* stream) {
  const AffinePlan& p = *static_cast<const AffinePlan*>(plan);
  if (p.elem_bytes != static_cast<int>(sizeof(T))) return cudaErrorInvalidValue;
  if (p.E == 0) return cudaSuccess;
  const rdc::DeviceGuard guard(p.device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.K == 4 && p.Q == 5) return launch_kq<T, 4, 5>(p, x, Ye, st);
  if (p.K == 3 && p.Q == 4) return launch_kq<T, 3, 4>(p, x, Ye, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The launch plan of one set of stacks (C (nC, Q, E), D (nD, Q, 3, E), Ep
// (nE, E)) with the element tables conn_T (K, E), JxW (Q, E) and dphi0
// (K, 3, E) on `device`, for x (V, N), in elements of elem_bytes (4 or 8).
// slots_host: int32[3 * kMaxV * kMaxV] on the host, the C, D and E tables
// in turn, each row-major (v, w) -> plane index or -1.  phi_host: double
// [Q * K] on the host, row-major.
extern "C" int rdc_apply_affine_plan(
    void* plan, int plan_bytes, const int* conn_T, const void* JxW,
    const void* dphi0, const void* C, const void* D, const void* Ep,
    const int* slots_host, const double* phi_host, int V, int N, int K,
    int Q, int E, int elem_bytes, int device) {
  AffinePlan* p = rdc::plan_cast<AffinePlan>(plan, plan_bytes);
  if (p == nullptr || !rdc::affine_kq(K, Q) || V < 1 ||
      V > rdc::kMaxV || N < 0 || E < 0 || (elem_bytes != 4 && elem_bytes != 8))
    return cudaErrorInvalidValue;
  constexpr int MM = rdc::kMaxV * rdc::kMaxV;
  *p = AffinePlan{};
  for (int i = 0; i < MM; ++i) {
    p->slots.c[i] = slots_host[i];
    p->slots.d[i] = slots_host[MM + i];
    p->slots.e[i] = slots_host[2 * MM + i];
  }
  p->phi = rdc::phi_table(phi_host, K, Q);
  p->conn_T = conn_T;
  p->JxW = JxW;
  p->dphi0 = dphi0;
  p->C = C;
  p->D = D;
  p->Ep = Ep;
  p->V = V;
  p->N = N;
  p->K = K;
  p->Q = Q;
  p->E = E;
  p->elem_bytes = elem_bytes;
  p->device = device;
  return cudaSuccess;
}

// x (V, N) -> Ye (V, K, E) with the plan's tables and stacks.
extern "C" int rdc_apply_affine_f32(const void* plan, const float* x,
                                    float* Ye, void* stream) {
  return launch_apply<float>(plan, x, Ye, stream);
}

extern "C" int rdc_apply_affine_f64(const void* plan, const double* x,
                                    double* Ye, void* stream) {
  return launch_apply<double>(plan, x, Ye, stream);
}
