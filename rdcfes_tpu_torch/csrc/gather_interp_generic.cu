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
//
// K <= kRegRows (HEX8, PRISM6, PYRAMID5, TET10, QUAD4/8/9): one thread
// per element, <K, Q> template parameters.  The q loop is outermost and
// stays rolled: one iteration holds dphi[q] (3 K values) in registers and
// serves every species from it, so dphi is read exactly once; the
// element's node ids stay in registers and the corner values are re-read
// per q through L1/L2 (u is small and stays resident).  Every plane
// access is coalesced along e; phi rides in the kernel parameters.
//
// K > kRegRows (HEX20 (20, 27), HEX27 (27, 27)): the 3 K gradient values of
// a q would take 120-162 f64 registers, and a mesh has few elements (13,824
// at 24^3).  Bound: on 13,824 HEX27 with 5 species a call reads dphi 241.9
// MB, conn_T 1.5 MB and u 4.7 MB and writes u_qp 14.9 MB and gx 44.8 MB:
// 307.8 MB, 0.0919 ms at 3.35 TB/s (HEX20: 242.4 MB, 0.0724 ms; f32 0.0462
// and 0.0363 ms).  dphi, four fifths of it, is read once.
//
// What held the design before this one back (a thread an (element, q), q the
// grid's y index, k in a rolled loop: three dphi loads, a node id, V corner
// loads waiting on it; 43-53% of the bound): (1) every element's corners
// were gathered Q = 27 times, by 27 blocks on different SMs (3,645 scattered
// loads an element at HEX27 where 135 are needed, ~403 MB of L2 requests in
// f64, more than the call moves from HBM), its node ids read 27 times; (2) a
// dependent chain (node id, corner, FMA) in every iteration of a rolled loop
// left a thread ~24 bytes of dphi in flight; (3) the dphi stream, the call's
// main traffic, paid both.
//
// This design: a block owns a tile of kTileE = 32 consecutive elements (a
// warp's lanes) and all Q points, in kSlots = 3 warps (warp s takes q = s, s
// + 3, ...).  (1) It loads the tile's K x 32 node ids once, coalesced, and
// gathers the V x K x 32 corner values once into shared memory, laid out
// [v][k][lane] so that a warp's lanes read consecutive words; phi (Q x K,
// past the parameters' room) is copied from the caller's device copy into
// shared memory and read warp-uniformly.  (2) No load waits on another: each
// thread streams its gradient rows, coalesced along e, through a register
// ring of P rows (ahead()) that it refills as it drains and carries into its
// next q, the first P rows issued before the gather.  The registers are
// capped at 168 (kTileBlocks = 4 blocks of 96 threads an SM), so the 432
// tiles of a 24^3 mesh run in one wave on the 132 SMs: without the cap
// (184-255 registers) 3 fit an SM and the last 36 tiles ran alone, slower
// than the design before.  (3) dphi, conn_T and u are each read once from
// HBM.  The k sums keep the reference's order (k = 0 ... K-1 for each q,
// every species from one gradient row); stores stay coalesced along e,
// masked on the ragged last tile, whose lanes past E read element E - 1's
// rows.  Shared memory is (V K 32 + Q K) values: 40.4 KB at HEX27 f64 with 5
// species, past 48 KB from 7 species, where the launch opts in
// (cudaFuncSetAttribute) and returns the error if refused.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, 13,824 elements, 5 species
// (chip_smoke.py phases 19a and 20a; scripts/k8_stream_probe.py times the
// alternatives): f64 HEX20 0.0926 ms, 78% of its bound, HEX27 0.1144-0.1149
// ms, 80%; f32 HEX20 0.0578 ms, 63%, HEX27 0.0752-0.0763 ms, 61%; the design
// before took 0.1372-0.1376, 0.1905-0.1906, 0.0757-0.0759 and 0.1060-0.1064
// ms in the same call.  168 registers, no spills in f64, 8-36 bytes in f32.
// On a few tiles a thread's 9 q x K / P refills run back to back: 75
// elements take 0.023-0.031 ms.
#include "common.cuh"

namespace {

using rdc::kMaxQK;
using rdc::kRegRows;

// phi of the K <= kRegRows instances, in the kernel parameters
template <typename T, int K, int Q>
struct PhiKQ {
  static_assert(Q * K <= kMaxQK, "phi past the parameters' room");
  T v[Q * K];
  __device__ __forceinline__ T at(int i) const { return v[i]; }
  void set(const double* host) {
    for (int i = 0; i < Q * K; ++i) v[i] = static_cast<T>(host[i]);
  }
};

template <typename T, int K, int Q>
__global__ void __launch_bounds__(rdc::kThreads) gather_interp_generic_kernel(
    const T* __restrict__ u, const int* __restrict__ conn_T,
    const T* __restrict__ dphi, T* __restrict__ u_qp, T* __restrict__ gx,
    PhiKQ<T, K, Q> phi, int V, int N, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);

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

// Above kRegRows: a block owns kTileE consecutive elements (a warp's
// lanes) and all Q points, kSlots warps; warp s takes q = s, s + kSlots, ...
constexpr int kTileE = 32;
constexpr int kSlots = 3;
constexpr int kTileThreads = kTileE * kSlots;
// blocks an SM must hold (a register cap of 65,536 / (4 * 96) = 168): the
// 432 tiles of a 24^3 mesh then run in one wave on 132 SMs
constexpr int kTileBlocks = 4;

// P, the gradient rows (k: 3 values each) a thread keeps in flight, a
// divisor of K so that the ring's slots line up again at every q: in f64
// the smallest from 3 up (3 at HEX27, 4 at HEX20: 72-96 bytes a thread,
// 23-30 KB an SM), in f32 all K (240-324 bytes).  Deeper f64 rings and
// shallower f32 ones ran slower on the H100 (scripts/k8_stream_probe.py).
template <typename T, int K>
__host__ __device__ constexpr int ahead() {
  if (sizeof(T) == 4) return K;
  int p = 3;
  while (K % p) ++p;
  return p;
}

// corners (V, K, kTileE) then phi (Q, K), in T
template <typename T, int K, int Q>
constexpr size_t tile_smem(int V) {
  return (static_cast<size_t>(V) * K * kTileE + Q * K) * sizeof(T);
}

// P, the ring's depth, is a parameter so that scripts/k8_stream_probe.cu
// can time other depths; the launch takes ahead<T, K>()
template <typename T, int K, int Q, int P>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    gather_interp_generic_tile_kernel(
        const T* __restrict__ u, const int* __restrict__ conn_T,
        const T* __restrict__ phi, const T* __restrict__ dphi,
        T* __restrict__ u_qp, T* __restrict__ gx, int V, int N, int E) {
  static_assert(K % P == 0, "the ring's depth divides K");
  constexpr int M = rdc::kMaxV;
  constexpr int kRows = K * kTileE;  // (k, lane) entries of a species
  constexpr int kGather = (kRows + kTileThreads - 1) / kTileThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // cs[(v K + k) kTileE + lane]
  T* ph = cs + V * kRows;                  // ph[q K + k]
  const size_t sE = static_cast<size_t>(E);
  const size_t sQ = static_cast<size_t>(K) * 3 * sE;  // one q of dphi
  const int t = threadIdx.x;
  const int lane = t % kTileE, slot = t / kTileE;
  const int e0 = blockIdx.x * kTileE;
  const int e = e0 + lane;
  // past E (the ragged last tile) a lane reads element E - 1 and stores
  // nothing
  const int el = min(e, E - 1);

  // the first P rows of this warp's first q, in flight across the gather
  const T* gq = dphi + slot * sQ + el;
  T g[P][3];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int d = 0; d < 3; ++d) g[j][d] = gq[(3 * j + d) * sE];

  // the tile's node ids, once, coalesced along e; its corners, once
  int node[kGather];
#pragma unroll
  for (int j = 0; j < kGather; ++j) {
    const int i = t + j * kTileThreads;
    node[j] = i < kRows ? __ldg(conn_T + (i / kTileE) * sE +
                                min(e0 + i % kTileE, E - 1))
                        : 0;
  }
#pragma unroll
  for (int v = 0; v < M; ++v) {
    if (v < V) {
      const T* uv = u + static_cast<size_t>(v) * N;
#pragma unroll
      for (int j = 0; j < kGather; ++j) {
        const int i = t + j * kTileThreads;
        if (i < kRows) cs[v * kRows + i] = __ldg(uv + node[j]);
      }
    }
  }
  for (int i = t; i < Q * K; i += kTileThreads) ph[i] = __ldg(phi + i);
  __syncthreads();

  const T* ck = cs + lane;
#pragma unroll 1
  for (int q = slot; q < Q; q += kSlots) {
    const bool more = q + kSlots < Q;
    const T* gn = gq + (more ? kSlots * sQ : 0);
    const T* pq = ph + q * K;
    T ax[M], a0[M], a1[M], a2[M];
#pragma unroll
    for (int v = 0; v < M; ++v) ax[v] = a0[v] = a1[v] = a2[v] = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T g0 = g[k % P][0], g1 = g[k % P][1], g2 = g[k % P][2];
      // refill the slot: row k + P of this q, or the next q's first rows
      if (k + P < K) {
#pragma unroll
        for (int d = 0; d < 3; ++d)
          g[k % P][d] = gq[(3 * (k + P) + d) * sE];
      } else if (more) {
#pragma unroll
        for (int d = 0; d < 3; ++d)
          g[k % P][d] = gn[(3 * (k + P - K) + d) * sE];
      }
      const T p = pq[k];
#pragma unroll
      for (int v = 0; v < M; ++v) {
        if (v < V) {
          const T c = ck[(v * K + k) * kTileE];
          ax[v] += p * c;
          a0[v] += g0 * c;
          a1[v] += g1 * c;
          a2[v] += g2 * c;
        }
      }
    }
    if (e < E) {
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
    }
    gq = gn;
  }
}

template <typename T, int K, int Q>
cudaError_t launch_kq(const T* u, const int* conn_T, const double* phi_host,
                      const T* phi_dev, const T* dphi, T* u_qp, T* gx, int V,
                      int N, int E, cudaStream_t st) {
  if constexpr (K > kRegRows) {
    if (phi_dev == nullptr || V > rdc::kMaxV) return cudaErrorInvalidValue;
    const auto kern =
        gather_interp_generic_tile_kernel<T, K, Q, ahead<T, K>()>;
    const size_t smem = tile_smem<T, K, Q>(V);
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (rc != cudaSuccess) return rc;
    }
    const unsigned tiles = static_cast<unsigned>((E + kTileE - 1) / kTileE);
    kern<<<tiles, kTileThreads, smem, st>>>(u, conn_T, phi_dev, dphi, u_qp,
                                            gx, V, N, E);
  } else {
    PhiKQ<T, K, Q> ph;
    ph.set(phi_host);
    gather_interp_generic_kernel<T, K, Q>
        <<<rdc::blocks_for(E), rdc::kThreads, 0, st>>>(u, conn_T, dphi, u_qp,
                                                       gx, ph, V, N, E);
  }
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
