// Other ways to stream dphi through K8's HEX20 / HEX27 path, for
// scripts/k8_stream_probe.py to time beside the package's kernel
// (csrc/gather_interp_generic.cu, included here for its tile kernel and
// helpers).  Each computes the same function on the same tile of 32
// elements with its corners gathered once into shared memory:
//   0 "ring":   dphi staged one q at a time (its K x 3 rows of the tile)
//               through a two-stage shared-memory ring by cp.async, one
//               warp per species, each thread 4 accumulators, every
//               gradient value read from shared memory V times;
//   1-3 "tile P=...": the package's tile kernel at ring depths P = 3 / 9 /
//               27 rows (K = 27) or 4 / 10 / 20 (K = 20);
//   4 "thread ring": the package's thread mapping (3 warps, a thread all
//               species of its (element, q)), its gradient rows through a
//               per-thread shared-memory ring of R stages of RS rows each,
//               filled by cp.async, so that the rows in flight take no
//               registers; phi read warp-uniformly through L1.
// Built on its own (nvcc -shared -I rdcfes_tpu_torch/csrc) by the probe.
#include "gather_interp_generic.cu"

namespace {

constexpr int kStages = 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(B)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- 0: a shared-memory ring of whole q-slices, a warp a species ----
template <typename T, int K, int Q>
constexpr size_t ring_smem(int V) {
  return (static_cast<size_t>(kStages) * K * 3 * kTileE +
          static_cast<size_t>(V) * K * kTileE + Q * K) *
         sizeof(T);
}

template <typename T, int K, int Q>
__global__ void __launch_bounds__(kTileE * rdc::kMaxV) k8_ring_kernel(
    const T* __restrict__ u, const int* __restrict__ conn_T,
    const T* __restrict__ phi, const T* __restrict__ dphi,
    T* __restrict__ u_qp, T* __restrict__ gx, int V, int N, int E) {
  constexpr int kRows = K * kTileE;
  constexpr int kStage = 3 * kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [stage][3 k + d][lane]
  T* cs = ring + kStages * kStage;            // [v][k][lane]
  T* ph = cs + V * kRows;                     // [q][k]
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t % kTileE, v = t / kTileE;
  const int e0 = blockIdx.x * kTileE, e = e0 + lane;
  const size_t sE = static_cast<size_t>(E);

  auto issue = [&](int q) {
    T* st = ring + (q % kStages) * kStage;
    for (int i = t; i < kStage; i += nt) {
      const T* src = dphi + (static_cast<size_t>(q) * kStage / kTileE +
                             i / kTileE) * sE +
                     min(e0 + i % kTileE, E - 1);
      cp_async<sizeof(T)>(st + i, src);
    }
    cp_async_commit();
  };
  issue(0);
  for (int i = t; i < kRows; i += nt) {
    const int n =
        __ldg(conn_T + (i / kTileE) * sE + min(e0 + i % kTileE, E - 1));
    for (int w = 0; w < V; ++w)
      cs[w * kRows + i] = __ldg(u + static_cast<size_t>(w) * N + n);
  }
  for (int i = t; i < Q * K; i += nt) ph[i] = __ldg(phi + i);

#pragma unroll 1
  for (int q = 0; q < Q; ++q) {
    if (q + 1 < Q)
      issue(q + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* st = ring + (q % kStages) * kStage + lane;
    const T* ck = cs + v * kRows + lane;
    T ax = T(0), a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T c = ck[k * kTileE];
      ax += ph[q * K + k] * c;
      a0 += st[(3 * k + 0) * kTileE] * c;
      a1 += st[(3 * k + 1) * kTileE] * c;
      a2 += st[(3 * k + 2) * kTileE] * c;
    }
    if (e < E) {
      const size_t vq = static_cast<size_t>(v) * Q + q;
      u_qp[vq * sE + e] = ax;
      gx[(vq * 3 + 0) * sE + e] = a0;
      gx[(vq * 3 + 1) * sE + e] = a1;
      gx[(vq * 3 + 2) * sE + e] = a2;
    }
    __syncthreads();
  }
}

// ---- 4: the tile kernel's mapping, a per-thread shared-memory ring ----
template <typename T, int K>
__host__ __device__ constexpr int ring_rows() {  // RS, a divisor of K
  return K % 3 == 0 ? 3 : 4;
}

template <typename T>
__host__ __device__ constexpr int ring_stages() {  // R
  return sizeof(T) == 8 ? 3 : 4;
}

template <typename T, int K, int Q>
constexpr size_t thread_ring_smem(int V) {
  return (static_cast<size_t>(ring_stages<T>()) * ring_rows<T, K>() * 3 *
              kTileThreads +
          static_cast<size_t>(V) * K * kTileE) *
         sizeof(T);
}

template <typename T, int K, int Q>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    k8_thread_ring_kernel(const T* __restrict__ u,
                          const int* __restrict__ conn_T,
                          const T* __restrict__ phi,
                          const T* __restrict__ dphi, T* __restrict__ u_qp,
                          T* __restrict__ gx, int V, int N, int E) {
  constexpr int M = rdc::kMaxV;
  constexpr int RS = ring_rows<T, K>(), R = ring_stages<T>();
  constexpr int NS = K / RS;                       // stages a q
  constexpr int kSlot = RS * 3 * kTileThreads;     // one stage, all threads
  constexpr int kRows = K * kTileE;
  constexpr int kGather = (kRows + kTileThreads - 1) / kTileThreads;
  static_assert(K % RS == 0, "stages tile a q");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [stage][3 kk + d][thread]
  T* cs = ring + R * kSlot;                  // [v][k][lane]
  const size_t sE = static_cast<size_t>(E);
  const int t = threadIdx.x;
  const int lane = t % kTileE, slot = t / kTileE;
  const int e0 = blockIdx.x * kTileE;
  const int e = e0 + lane;
  const int el = min(e, E - 1);
  const int nst = (Q - slot + kSlots - 1) / kSlots * NS;
  T* mine = ring + t;

  auto issue = [&](int g) {
    if (g < nst) {
      const int q = slot + (g / NS) * kSlots, k0 = (g % NS) * RS;
      const T* src = dphi + (static_cast<size_t>(q) * K + k0) * 3 * sE + el;
      T* dst = mine + (g % R) * kSlot;
#pragma unroll
      for (int j = 0; j < RS * 3; ++j)
        cp_async<sizeof(T)>(dst + j * kTileThreads, src + j * sE);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < R - 1; ++g) issue(g);

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
  __syncthreads();

  const T* ck = cs + lane;
  int g = 0;
#pragma unroll 1
  for (int q = slot; q < Q; q += kSlots) {
    const T* pq = phi + q * K;
    T ax[M], a0[M], a1[M], a2[M];
#pragma unroll
    for (int v = 0; v < M; ++v) ax[v] = a0[v] = a1[v] = a2[v] = T(0);
#pragma unroll
    for (int s = 0; s < NS; ++s, ++g) {
      cp_async_wait<R - 2>();
      const T* st = mine + (g % R) * kSlot;
#pragma unroll
      for (int kk = 0; kk < RS; ++kk) {
        const int k = s * RS + kk;
        const T g0 = st[(3 * kk + 0) * kTileThreads];
        const T g1 = st[(3 * kk + 1) * kTileThreads];
        const T g2 = st[(3 * kk + 2) * kTileThreads];
        const T p = __ldg(pq + k);
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
      issue(g + R - 1);
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
  }
}

template <typename T, int K, int Q>
int launch_variant(int variant, const T* u, const int* conn_T,
                   const T* phi, const T* dphi, T* u_qp, T* gx, int V,
                   int N, int E, cudaStream_t st) {
  constexpr int Ps[3] = {K % 3 == 0 ? 3 : 4, K % 3 == 0 ? 9 : 10, K};
  const unsigned tiles = static_cast<unsigned>((E + kTileE - 1) / kTileE);
  void (*kern)(const T*, const int*, const T*, const T*, T*, T*, int, int,
               int) = nullptr;
  size_t smem = 0;
  unsigned threads = kTileThreads;
  switch (variant) {
    case 0:
      kern = k8_ring_kernel<T, K, Q>;
      smem = ring_smem<T, K, Q>(V);
      threads = kTileE * V;
      break;
    case 1:
      kern = gather_interp_generic_tile_kernel<T, K, Q, Ps[0]>;
      smem = tile_smem<T, K, Q>(V);
      break;
    case 2:
      kern = gather_interp_generic_tile_kernel<T, K, Q, Ps[1]>;
      smem = tile_smem<T, K, Q>(V);
      break;
    case 3:
      kern = gather_interp_generic_tile_kernel<T, K, Q, Ps[2]>;
      smem = tile_smem<T, K, Q>(V);
      break;
    case 4:
      kern = k8_thread_ring_kernel<T, K, Q>;
      smem = thread_ring_smem<T, K, Q>(V);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  kern<<<tiles, threads, smem, st>>>(u, conn_T, phi, dphi, u_qp, gx, V, N,
                                     E);
  return cudaGetLastError();
}

template <typename T>
int probe_launch(int variant, const T* u, const int* conn_T, const T* phi,
                 const T* dphi, T* u_qp, T* gx, int V, int N, int K, int Q,
                 int E, void* stream) {
  if (V < 1 || V > rdc::kMaxV) return cudaErrorInvalidValue;
  if (E == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 20 && Q == 27)
    return launch_variant<T, 20, 27>(variant, u, conn_T, phi, dphi, u_qp, gx,
                                     V, N, E, st);
  if (K == 27 && Q == 27)
    return launch_variant<T, 27, 27>(variant, u, conn_T, phi, dphi, u_qp, gx,
                                     V, N, E, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// variant: 0-4 as above; phi: the (Q, K) table on the device in the
// kernel's type.
extern "C" int probe_k8_f64(int variant, const double* u, const int* conn_T,
                            const double* phi, const double* dphi,
                            double* u_qp, double* gx, int V, int N, int K,
                            int Q, int E, void* stream) {
  return probe_launch<double>(variant, u, conn_T, phi, dphi, u_qp, gx, V, N,
                              K, Q, E, stream);
}

extern "C" int probe_k8_f32(int variant, const float* u, const int* conn_T,
                            const float* phi, const float* dphi, float* u_qp,
                            float* gx, int V, int N, int K, int Q, int E,
                            void* stream) {
  return probe_launch<float>(variant, u, conn_T, phi, dphi, u_qp, gx, V, N,
                             K, Q, E, stream);
}
