// K4 restrict (f32 and f64): element corners -> nodes, as a node-parallel
// gather-sum through the padded inverse incidence table.
//
// Replaces rdcfes_tpu/fem/pallas_perm.py:grid_permute_reduce (:203, body
// _perm_reduce_kernel :189; the f32 inner matvec), grid_permute (:184; the
// right-hand side) and grid_permute_f64 (:298; the f64 outer matvec).  On
// the TPU the restriction was a Beneš permutation into (incidence, node)
// order followed by a sum over incidences; Hopper gathers directly.
//
//   y[w, n] = sum_{c = 0..C-1} flat[w, node_gather[c, n]]
//
// where an index outside [0, K*E) (the pad K*E) adds zero.  The sum runs
// over c in order, as the plain version's, so the result equals it bit for
// bit.  No atomics: deterministic.
//
// Bound: device-memory bandwidth and the latency of the indexed loads.
// Bytes per call at bench shapes (C=24, N=24,389, K*E=526,848): node_gather
// 2.3 MB, flat W*K*E*sizeof(T) (f32 matvec W=5: 10.5 MB; f64 rhs W=5:
// 21.1 MB; f64 block-Jacobi diagonal W=25: 105 MB), y W*N*sizeof(T).
// Each flat value is read once, but as a scattered 4- or 8-byte load.
// The solid path's assembly is the same function: element matrices
// (W=9, K*K*E = 7,077,888 at the solid bench) gathered through slot_gather
// (C=8, N=nnz=3,048,625): 462 MB (f32) / 827 MB (f64) per call, whose
// gathers scatter over the 64 (i, j) planes of the flat buffer; and the
// residual (W=3, K*E) through node_gather.
// Design: a thread sums one node's channels w0 .. w0 + WB - 1 (WB a
// template parameter) in chunks of CH incidences: a chunk's indices are in
// registers before its CH * WB value loads are issued, and the next
// chunk's indices are loaded before the chunk is summed, so the latency of
// a node's sum is a few round trips to memory, not C.  Up to 9 channels
// (every W but the block-Jacobi diagonal's) go to one thread, CH = 8 (4
// for f64 beyond 5 channels), so each index is read once for all of them;
// wider W takes one channel a thread over blockIdx.y, with the whole
// column in one chunk where it is long (TET4's C = 24).  The choice was
// measured at the TET4 and HEX8 tables' shapes: groups of 3 or 5 channels,
// or longer chunks at W <= 9, were no faster.  Index rows are coalesced
// along n; nodes of neighbouring ids touch neighbouring elements in the
// structured orderings the meshes carry, which keeps most scattered loads
// within a few cache lines.
#include "common.cuh"

namespace {

constexpr int kMaxWB = 9;  // channels one thread carries

struct RestrictPlan {
  const int* node_gather;  // (C, N) int32
  int C, N, device;
};

template <typename T, int WB, int CH>
__global__ void __launch_bounds__(rdc::kThreads) restrict_kernel(
    const T* __restrict__ flat, const int* __restrict__ node_gather,
    T* __restrict__ y, int W, int C, int N, int KE) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int w0 = blockIdx.y * WB;
  const int nw = min(WB, W - w0);
  const size_t sN = static_cast<size_t>(N);
  const size_t sKE = static_cast<size_t>(KE);
  const unsigned ke = static_cast<unsigned>(KE);
  const T* f = flat + w0 * sKE;

  T acc[WB];
#pragma unroll
  for (int w = 0; w < WB; ++w) acc[w] = T(0);
  int idx[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j)
    idx[j] = j < C ? __ldg(node_gather + j * sN + n) : KE;

  for (int c0 = 0; c0 < C; c0 += CH) {
    T val[CH][WB];
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int w = 0; w < WB; ++w)
        val[j][w] = (w < nw && static_cast<unsigned>(idx[j]) < ke)
                        ? __ldg(f + w * sKE + idx[j])
                        : T(0);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = c0 + CH + j;
      idx[j] = c < C ? __ldg(node_gather + c * sN + n) : KE;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int w = 0; w < WB; ++w) acc[w] += val[j][w];
  }
#pragma unroll
  for (int w = 0; w < WB; ++w)
    if (w < nw) y[(w0 + w) * sN + n] = acc[w];
}

template <typename T, int WB, int CH>
cudaError_t launch_wb(const RestrictPlan& p, const T* flat, T* y, int W,
                      int KE, cudaStream_t st) {
  const dim3 grid(rdc::blocks_for(p.N),
                  static_cast<unsigned>((W + WB - 1) / WB));
  restrict_kernel<T, WB, CH><<<grid, rdc::kThreads, 0, st>>>(
      flat, p.node_gather, y, W, p.C, p.N, KE);
  return cudaGetLastError();
}

// up to 9 channels a thread, 8 incidences a chunk (4 for f64 beyond 5
// channels, which would spend the registers)
template <typename T, int WB>
cudaError_t launch_w(const RestrictPlan& p, const T* flat, T* y, int KE,
                     cudaStream_t st) {
  constexpr int CH = (sizeof(T) == 8 && WB > 5) ? 4 : 8;
  return launch_wb<T, WB, CH>(p, flat, y, WB, KE, st);
}

template <typename T>
int launch_restrict(const void* plan, const T* flat, T* y, int W, int KE,
                    void* stream) {
  const RestrictPlan& p = *static_cast<const RestrictPlan*>(plan);
  if (W < 1 || W > 65535 || KE < 0) return cudaErrorInvalidValue;
  if (p.N == 0) return cudaSuccess;
  const rdc::DeviceGuard guard(p.device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // wider W (the block-Jacobi diagonal): one channel a thread, a whole
  // column of up to 24 incidences (TET4) at once, else chunks of 8
  if (W > kMaxWB)
    return p.C > 8 ? launch_wb<T, 1, 24>(p, flat, y, W, KE, st)
                   : launch_wb<T, 1, 8>(p, flat, y, W, KE, st);
#define RDC_RESTRICT_CASE(NW) \
  case NW:                    \
    return launch_w<T, NW>(p, flat, y, KE, st);
  switch (W) {
    RDC_RESTRICT_CASE(1)
    RDC_RESTRICT_CASE(2)
    RDC_RESTRICT_CASE(3)
    RDC_RESTRICT_CASE(4)
    RDC_RESTRICT_CASE(5)
    RDC_RESTRICT_CASE(6)
    RDC_RESTRICT_CASE(7)
    RDC_RESTRICT_CASE(8)
    RDC_RESTRICT_CASE(9)
    default:
      return cudaErrorInvalidValue;
  }
#undef RDC_RESTRICT_CASE
}

}  // namespace

// The launch plan of one node_gather table (C, N) on `device`, written into
// the caller's buffer of plan_bytes.
extern "C" int rdc_restrict_plan(void* plan, int plan_bytes,
                                 const int* node_gather, int C, int N,
                                 int device) {
  RestrictPlan* p = rdc::plan_cast<RestrictPlan>(plan, plan_bytes);
  if (p == nullptr || C < 0 || N < 0) return cudaErrorInvalidValue;
  *p = RestrictPlan{node_gather, C, N, device};
  return cudaSuccess;
}

// flat (W, KE) -> y (W, N) through the plan's table; pad index KE.
extern "C" int rdc_restrict_f32(const void* plan, const float* flat, float* y,
                                int W, int KE, void* stream) {
  return launch_restrict<float>(plan, flat, y, W, KE, stream);
}

extern "C" int rdc_restrict_f64(const void* plan, const double* flat,
                                double* y, int W, int KE, void* stream) {
  return launch_restrict<double>(plan, flat, y, W, KE, stream);
}
