// K6 apply_generic (f32 and f64): the matrix-free element apply of the
// Krylov matvec for elements whose shape gradients differ per quadrature
// point, with the corner gather fused into its prologue.  One instance
// per element type, (K, Q) = HEX8 (8, 8), PRISM6 (6, 8), PYRAMID5 (5, 8),
// TET10 (10, 14), QUAD4 (4, 4), QUAD8 (8, 9), QUAD9 (9, 9), HEX20
// (20, 27) and HEX27 (27, 27).  A 2D element's gradients have a zero z,
// which the arithmetic does not distinguish.
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
// 3.35 TB/s; f64 moves twice the float bytes.  The other types move
// the same planes at their own K and Q: TET10's dphi is 30 rows a
// q-slice and 14 slices, 2.2x HEX8's per element.
//
// Design.  A block takes a tile of TE elements (32, or 16 when the planes
// are many) with one thread per (species v, element): thread (v, e)
// gathers species v at the corners of e, interpolates species v at each q,
// and owns the K accumulators of Ye[v, :, e], so no thread holds anything
// of size V*K.  The q loop is outermost.  Every row a q-slice of the tile
// needs (dphi's K*3 rows, JxW, the live C, D and E rows: all contiguous
// along e) is staged into shared memory with cp.async, 2 or 3 q-slices
// deep, so the bytes in flight do not depend on how many warps the
// registers allow; 16-byte copies where every row is 16-byte aligned, one
// element per copy otherwise (E odd in f32), zero-filled past E; a block
// first writes each row's source and q-stride into shared memory, so a
// copy costs a few instructions.  Per q: wait for the slice, start the
// copy of slice q + stages - 1, interpolate species v into a small
// exchange buffer, barrier, then the responses of v from every species'
// interpolated values and the projection back into the accumulators.
// Warps share v when TE >= 32, so the (v, w) slot branches are warp-
// uniform; the slot and phi tables ride in the kernel parameters (at
// TET10's (10, 14) the f64 phi table is 1,120 B, the whole parameter
// struct under 2 KB of the 4 KB limit).  The staged rows of a q-slice
// grow with K only (3 K of them for dphi), so Q changes the loop count
// and not the shared memory: TET10 with PIHNA's live planes takes 55 KB
// in f64 at TE = 32 and 3 stages, above the 48 KB default, which the
// plan raises with cudaFuncSetAttribute.
//
// The quadratic hexes.  HEX27's staging is 81 dphi rows a slice (3 K),
// with PIHNA's planes 115 rows, 95 KB in f64 at TE = 32 and 3 stages:
// still two blocks an SM, since a slice and not an element is staged.
// What does not fit is what a thread holds: at K = 20 and 27 the f64
// registers of g[K][3], ue[K], acc[K] and the phi row exceed 255, so
// above K = 10 (kRegRows) a thread keeps only ue and acc and reads each
// gradient row from the staged slice where it uses it (the barrier
// between the interpolation and the projection makes that a second
// shared-memory read, not a register), and phi, 729 entries, past the
// kernel parameters' room (kMaxQK), is copied from the plan's device copy
// into shared memory once a block (5.8 KB in f64): a read-only global
// load could be kept in registers across the barrier, a shared one is
// read again.
//
// The kernel template and its launcher live in this header; each (K, Q)
// is instantiated in one source of its own group (apply_generic_first.cu:
// HEX8, PRISM6, PYRAMID5, TET10; apply_generic_quad.cu: QUAD4, QUAD8,
// QUAD9; apply_generic_hex20.cu; apply_generic_hex27.cu), so that nvcc
// builds the groups in parallel; apply_generic.cu holds the plan and the
// C entry points and dispatches to them.
#pragma once

#include "common.cuh"

namespace rdc_generic {


constexpr int M = rdc::kMaxV;
using rdc::kMaxQK;
using rdc::kRegRows;
constexpr int kSmemTwoBlocks = 113 * 1024;  // leaves room for 2 blocks/SM
constexpr int kSmemMax = 227 * 1024;
constexpr int kRowBytes = 16;  // shared memory of a row's source and stride

struct GenericSlots {
  int c[M * M];
  int d[M * M];
  int e[M * M];
};

struct GenericPlan {
  const int* conn_T;
  const void* JxW;
  const void* dphi;
  const void* C;
  const void* D;
  const void* Es;
  GenericSlots slots;
  double phi[kMaxQK];  // K * Q <= kMaxQK
  const void* phi_dev;  // (Q, K) in the plan's type, on the device
  int V, N, K, Q, E, nC, nD, nE;
  int elem_bytes, device;
  int te, stages, vec, smem;
};

// phi[q][k] in the kernel's own type: in the parameters where K * Q <=
// kMaxQK, else a pointer to the plan's device copy
template <typename T, int K, int Q, bool InParams = (Q * K <= kMaxQK)>
struct PhiKQ {
  T v[Q * K];
  __device__ __forceinline__ T at(int i) const { return v[i]; }
  void set(const double* host, const void*) {
    for (int i = 0; i < Q * K; ++i) v[i] = static_cast<T>(host[i]);
  }
};

template <typename T, int K, int Q>
struct PhiKQ<T, K, Q, false> {
  const T* v;
  __device__ __forceinline__ T at(int i) const { return __ldg(v + i); }
  void set(const double*, const void* dev) { v = static_cast<const T*>(dev); }
};

template <typename T, int K, int Q>
struct GenericArgs {
  const T* x;
  const int* conn_T;
  const T* JxW;
  const T* dphi;
  const T* C;
  const T* D;
  const T* Es;
  T* Ye;
  GenericSlots s;
  PhiKQ<T, K, Q> phi;
  int N, E, nC, nD, nE, te, stages, vec;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, of which src_bytes are read and the rest zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <int B>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(B), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row r of q-slice q: dphi (k, d) at r = 3k + d, then JxW, the C planes,
// the D planes (s, d) at 3s + d and the E planes; each is E values long.
template <typename T, int K, int Q>
__device__ __forceinline__ const T* row_src(const GenericArgs<T, K, Q>& a,
                                            int r, int q) {
  const size_t sE = static_cast<size_t>(a.E);
  if (r < 3 * K) return a.dphi + (static_cast<size_t>(q) * 3 * K + r) * sE;
  r -= 3 * K;
  if (r == 0) return a.JxW + q * sE;
  r -= 1;
  if (r < a.nC) return a.C + (static_cast<size_t>(r) * Q + q) * sE;
  r -= a.nC;
  if (r < 3 * a.nD) {
    const int s = r / 3;
    return a.D + ((static_cast<size_t>(s) * Q + q) * 3 + (r - 3 * s)) * sE;
  }
  r -= 3 * a.nD;
  return a.Es + (static_cast<size_t>(r) * Q + q) * sE;
}

// Start the copy of q-slice q of the tile at e0 into stage[R][te]; row r
// of slice q starts at rows[r] + q * qstride[r].
template <typename T, int K, int Q>
__device__ __forceinline__ void stage_copy(const GenericArgs<T, K, Q>& a,
                                           T* stage, const T* const* rows,
                                           const long long* qstride, int R,
                                           int q, int e0) {
  const int te = a.te;
  if (a.vec) {
    constexpr int epc = 16 / sizeof(T);  // elements per 16-byte copy
    const int lg = 31 - __clz(te / epc);  // chunks per row, a power of 2
    for (int i = threadIdx.x; i < (R << lg); i += blockDim.x) {
      const int r = i >> lg;
      const int e = e0 + (i - (r << lg)) * epc;
      const int valid = min(max(a.E - e, 0), epc);
      const T* row = rows[r] + q * qstride[r];
      cp_async_16(stage + r * te + (e - e0), valid > 0 ? row + e : row,
                  valid * static_cast<int>(sizeof(T)));
    }
  } else {
    const int lg = 31 - __clz(te);
    for (int i = threadIdx.x; i < (R << lg); i += blockDim.x) {
      const int r = i >> lg;
      const int e = e0 + (i - (r << lg));
      const T* row = rows[r] + q * qstride[r];
      const bool in = e < a.E;
      cp_async_elem<sizeof(T)>(stage + i, in ? row + e : row,
                               in ? static_cast<int>(sizeof(T)) : 0);
    }
  }
}

template <typename T, int V, int K, int Q>
__global__ void __launch_bounds__(32 * M) apply_generic_kernel(
    const __grid_constant__ GenericArgs<T, K, Q> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int te = a.te;
  const int S = a.stages;
  const int R = 3 * K + 1 + a.nC + 3 * a.nD + a.nE;
  // [R] row sources and q-strides, [S][R][te] stages, [V][4][te] exchange,
  // and above kRegRows [Q][K] phi
  const T** rows = reinterpret_cast<const T**>(smem_raw);
  long long* qstride = reinterpret_cast<long long*>(rows + R);
  T* stages = reinterpret_cast<T*>(qstride + R);
  T* xqb = stages + S * R * te;
  T* sphi = xqb + V * 4 * te;
  const int v = threadIdx.x / te;
  const int el = threadIdx.x - v * te;
  const int e0 = blockIdx.x * te;
  const int e = e0 + el;
  const size_t sE = static_cast<size_t>(a.E);

  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    rows[r] = row_src(a, r, 0);
    qstride[r] = row_src(a, r, 1) - rows[r];
  }
  if constexpr (K > kRegRows)
    for (int i = threadIdx.x; i < Q * K; i += blockDim.x)
      sphi[i] = a.phi.at(i);
  __syncthreads();
  for (int s = 0; s + 1 < S; ++s) {
    if (s < Q) stage_copy(a, stages + s * R * te, rows, qstride, R, s, e0);
    cp_async_commit();
  }

  // corner gather of species v, while the first slices are in flight
  T ue[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ue[k] = T(0);
  if (e < a.E) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      ue[k] = __ldg(a.x + static_cast<size_t>(v) * a.N +
                    __ldg(a.conn_T + k * sE + e));
  }
  bool live = false;
#pragma unroll
  for (int w = 0; w < V; ++w)
    live = live || a.s.c[v * M + w] >= 0 || a.s.d[v * M + w] >= 0 ||
           a.s.e[v * M + w] >= 0;
  const int rJ = 3 * K, rC = rJ + 1, rD = rC + a.nC, rE = rD + 3 * a.nD;

  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);

#pragma unroll 1
  for (int q = 0; q < Q; ++q) {
    // slice q has landed (the S - 2 later ones may still fly) and every
    // thread is done with slice q - 1 and with the exchange buffer
    if (S == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int qn = q + S - 1;
    if (qn < Q)
      stage_copy(a, stages + (qn % S) * R * te, rows, qstride, R, qn, e0);
    cp_async_commit();

    const T* sg = stages + (q % S) * R * te + el;  // row r at sg[r * te]
    constexpr int KR = K <= kRegRows ? K : 1;  // rows held in registers
    T g[KR][3];
    T ph[KR];
    T xv, g0, g1, g2;
    if constexpr (K <= kRegRows) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int d = 0; d < 3; ++d) g[k][d] = sg[(3 * k + d) * te];
#pragma unroll
      for (int k = 0; k < K; ++k) ph[k] = a.phi.at(q * K + k);

      // interpolation of species v at q, for every thread of the element
      xv = ph[0] * ue[0];
      g0 = g[0][0] * ue[0], g1 = g[0][1] * ue[0], g2 = g[0][2] * ue[0];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        xv += ph[k] * ue[k];
        g0 += g[k][0] * ue[k];
        g1 += g[k][1] * ue[k];
        g2 += g[k][2] * ue[k];
      }
    } else {
      // the same sums, each gradient row read from the staged slice
      xv = sphi[q * K] * ue[0];
      g0 = sg[0] * ue[0], g1 = sg[te] * ue[0], g2 = sg[2 * te] * ue[0];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        const T* gk = sg + 3 * k * te;
        xv += sphi[q * K + k] * ue[k];
        g0 += gk[0] * ue[k];
        g1 += gk[te] * ue[k];
        g2 += gk[2 * te] * ue[k];
      }
    }
    T* xo = xqb + v * 4 * te + el;
    xo[0] = xv;
    xo[te] = g0;
    xo[2 * te] = g1;
    xo[3 * te] = g2;
    __syncthreads();

    // the response of species v, projected back
    if (live) {
      T av = T(0);
      T b0 = T(0), b1 = T(0), b2 = T(0);
#pragma unroll
      for (int w = 0; w < V; ++w) {
        const T* xw = xqb + w * 4 * te + el;
        const int sc = a.s.c[v * M + w];
        if (sc >= 0) av += sg[(rC + sc) * te] * xw[0];
        const int sd = a.s.d[v * M + w];
        if (sd >= 0) {
          const T* Dp = sg + (rD + 3 * sd) * te;
          const T xq = xw[0];
          b0 += Dp[0] * xq;
          b1 += Dp[te] * xq;
          b2 += Dp[2 * te] * xq;
        }
        const int se = a.s.e[v * M + w];
        if (se >= 0) {
          const T ev = sg[(rE + se) * te];
          b0 += ev * xw[te];
          b1 += ev * xw[2 * te];
          b2 += ev * xw[3 * te];
        }
      }
      const T jw = sg[rJ * te];
      av *= jw;
      b0 *= jw;
      b1 *= jw;
      b2 *= jw;
      if constexpr (K <= kRegRows) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc[k] += ph[k] * av + (g[k][0] * b0 + g[k][1] * b1 + g[k][2] * b2);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const T* gk = sg + 3 * k * te;
          acc[k] += sphi[q * K + k] * av +
                    (gk[0] * b0 + gk[te] * b1 + gk[2 * te] * b2);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (e < a.E) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      a.Ye[(static_cast<size_t>(v) * K + k) * sE + e] = acc[k];
  }
}

template <typename T, int K, int Q>
using GenericKernel = void (*)(const GenericArgs<T, K, Q>);

template <typename T, int K, int Q>
GenericKernel<T, K, Q> kernel_for(int V) {
  switch (V) {
    case 1: return apply_generic_kernel<T, 1, K, Q>;
    case 2: return apply_generic_kernel<T, 2, K, Q>;
    case 3: return apply_generic_kernel<T, 3, K, Q>;
    case 4: return apply_generic_kernel<T, 4, K, Q>;
    case 5: return apply_generic_kernel<T, 5, K, Q>;
    case 6: return apply_generic_kernel<T, 6, K, Q>;
    case 7: return apply_generic_kernel<T, 7, K, Q>;
    case 8: return apply_generic_kernel<T, 8, K, Q>;
    default: return nullptr;
  }
}

// one line per element type: (K, Q) = HEX8 (8, 8), PRISM6 (6, 8),
// PYRAMID5 (5, 8), TET10 (10, 14), QUAD4 (4, 4), QUAD8 (8, 9), QUAD9
// (9, 9), HEX20 (20, 27), HEX27 (27, 27)
#define RDC_GENERIC_KQ(X) \
  X(8, 8) X(6, 8) X(5, 8) X(10, 14) X(4, 4) X(8, 9) X(9, 9) X(20, 27) X(27, 27)

template <typename T, int K, int Q>
int launch_kq(const GenericPlan& p, const T* x, T* Ye, cudaStream_t st) {
  GenericArgs<T, K, Q> a;
  a.x = x;
  a.conn_T = p.conn_T;
  a.JxW = static_cast<const T*>(p.JxW);
  a.dphi = static_cast<const T*>(p.dphi);
  a.C = static_cast<const T*>(p.C);
  a.D = static_cast<const T*>(p.D);
  a.Es = static_cast<const T*>(p.Es);
  a.Ye = Ye;
  a.s = p.slots;
  a.phi.set(p.phi, p.phi_dev);
  a.N = p.N;
  a.E = p.E;
  a.nC = p.nC;
  a.nD = p.nD;
  a.nE = p.nE;
  a.te = p.te;
  a.stages = p.stages;
  a.vec = p.vec;
  const unsigned grid = static_cast<unsigned>((p.E + p.te - 1) / p.te);
  kernel_for<T, K, Q>(p.V)<<<grid, p.te * p.V, p.smem, st>>>(a);
  return cudaGetLastError();
}


// the instances of (KK, QQ) in both types: declared for the dispatching
// source, defined by the instantiating one
#define RDC_GENERIC_INSTANCE(PREFIX, KK, QQ)                               \
  PREFIX template GenericKernel<float, KK, QQ> kernel_for<float, KK, QQ>(  \
      int);                                                                \
  PREFIX template GenericKernel<double, KK, QQ> kernel_for<double, KK, QQ>( \
      int);                                                                \
  PREFIX template int launch_kq<float, KK, QQ>(const GenericPlan&,         \
                                               const float*, float*,       \
                                               cudaStream_t);              \
  PREFIX template int launch_kq<double, KK, QQ>(const GenericPlan&,        \
                                                const double*, double*,    \
                                                cudaStream_t);
#define RDC_GENERIC_EXTERN(KK, QQ) RDC_GENERIC_INSTANCE(extern, KK, QQ)
#define RDC_GENERIC_DEFINE(KK, QQ) RDC_GENERIC_INSTANCE(, KK, QQ)

}  // namespace rdc_generic
