// K5 ell_matvec (f32 and f64): the block-ELL sparse matrix-vector product
// of the solid Newton solve's Krylov loop.
//
// Replaces rdcfes_tpu/fem/bcsr.py:ell_matvec_fast (:60), whose x-gather ran
// through the Beneš permutation kernels of fem/pallas_perm.py
// (gather_corners :244, gather_corners_f64 :274) because XLA gathers were
// slow on the TPU.  Hopper has indexed loads, so x is gathered directly
// through the column table and nothing of the routing survives.
//
//   y[v, n] = sum_{l = 0..L-1} sum_{w = 0..W-1}
//             values[v, w, l, n] * x[w, cols[l, n]]
//
// Layouts are channel-first with the node axis minor: values (V, W, L, N),
// cols (L, N) int32, x (W, N), y (V, N).  Pad slots carry a zero value
// block (and a valid column), so every slot is summed alike.
//
// Bound: device-memory bandwidth, in both precisions.  Each value is read
// once; two flops per value (~0.06 flop a byte), far below the card's
// ridge point, so tensor cores have nothing to do here.  Per call:
//   HEX8 solid bench (V = W = 3, L = 27, N = 117,649): values 114.4 MB f32
//   / 228.7 MB f64, cols 12.7 MB, x and y 1.4 (2.8) MB each: ~130 / ~247 MB,
//   39 / 74 us at 3.35 TB/s;
//   TET4 solid of the HCC driver (L = 15, N = 24,389): values 13.2 MB f32,
//   cols 1.5 MB: ~15 MB, 4.5 us.  It fits the 50 MB L2, so inside the
//   Krylov loop the tangent is read from L2 after the first iteration.  A
//   call that finds it in HBM also pays the launch itself, which by a CUDA
//   event timer is as long as the transfer (chip_smoke.py phase 14b prints
//   both).
//
// Design: what limits a gather-SpMV at this intensity is the bytes in
// flight; the values stream is the only term that must come from HBM, and
// a node's x gathers wait on its column loads.
// - One thread carries kRows = 3 output rows of a node (every row of the
//   solid's 3 x 3 blocks; wider V takes more row groups on blockIdx.y), so
//   a slot's column and its W x values are loaded once for all rows, with
//   the rows' sums in registers.
// - A node's slot range is split over kGroups = 4 warps of its block
//   (kNodes = 64 nodes a block), so even the 24k rows of the TET4 tangent
//   put ~740 threads on each of the 132 SMs, each with a chunk's column
//   and value loads in flight at once.  A warp reads whole 32-node spans of a
//   plane (128 or 256 bytes).  The groups' partial sums are added in
//   shared memory in group order after one barrier: no atomics, a fixed
//   order, so two launches on the same inputs are bit-equal.
// - L is read at run time, and every width runs the same code: a group
//   walks its slots in passes of kPass = 4, each unrolled into chunks of
//   CH slots (4 in f32, 2 in f64) whose loads are predicated on the
//   group's slot count.  A chunk issues its column loads, then its
//   CH x kRows x W value loads, then its x gathers, and only then its
//   sums.  At W = 3 a pass fits in ~80 registers, so three blocks (24
//   warps) share an SM; the pass loop is not unrolled, and it re-reads
//   the node stride through an empty asm each pass, since ptxas would
//   otherwise hoist every load offset of a pass out of the loop and fill
//   the register file with them.
// - Values load through the read-only path with an L2 cache policy
//   (createpolicy) that the host picks per call: evict-first where the
//   values are larger than the device's L2 (its size read once), so the
//   column table and x keep their lines from one Krylov iteration to the
//   next; evict-normal where they fit, so they stay for the next call.
//   The policy is a register operand of one load instruction, so both
//   cases run the same code.
// - No TMA: a tensor map needs 16-byte strides, and a plane's stride
//   L N sizeof(T) is not one when N is odd, as both meshes' are (24,389
//   and 117,649 nodes); the layout is fixed by the callers.  cp.async
//   staging through shared memory is not tried: chip_smoke.py phase 6
//   prints the kernel after an L2 flush beside torch's values.sum(), one
//   streaming read of the values alone, the yardstick for what more
//   bytes in flight could gain.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRows = 3;   // output rows one thread carries
constexpr int kGroups = 4; // slot groups (warps) a node
constexpr int kNodes = 64; // nodes a block: kGroups * kNodes threads
constexpr int kBlock = kGroups * kNodes;
constexpr int kPass = 4;   // slots a group unrolls per pass

// A value load through the read-only path with the L2 policy `pol`
// (createpolicy): one instruction whatever the policy.
__device__ __forceinline__ float ld_value(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ double ld_value(const double* p, uint64_t pol) {
  double v;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
      : "=d"(v) : "l"(p), "l"(pol));
  return v;
}

// Group g (warp-uniform) of a block sums the slots [g per, (g + 1) per)
// of its node, per = ceil(L / kGroups), in passes of kPass slots;
// stream: the values load evict-first in L2.
template <typename T, int W>
__global__ void __launch_bounds__(kBlock) ell_matvec_kernel(
    const T* __restrict__ values, const int* __restrict__ cols,
    const T* __restrict__ x, T* __restrict__ y, int V, int L, int N,
    bool stream) {
  constexpr int CH = sizeof(T) == 4 ? 4 : 2;  // slots a chunk
  const int g = threadIdx.x / kNodes;
  const int i = threadIdx.x - g * kNodes;
  const int n = blockIdx.x * kNodes + i;
  const int v0 = blockIdx.y * kRows;
  const int nv = min(kRows, V - v0);
  const int per = (L + kGroups - 1) / kGroups;
  const int l0 = g * per;
  const int nl = min(per, L - l0);  // this group's slots (may be <= 0)
  const size_t sN = static_cast<size_t>(N);
  uint64_t pol;
  if (stream)
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  else
    asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(pol));

  T acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = T(0);

  if (n < N) {
    const T* val = values + static_cast<size_t>(v0) * W * L * sN +
                   static_cast<size_t>(l0) * sN + n;
    const int* col = cols + static_cast<size_t>(l0) * sN + n;
    size_t s = sN;  // the node stride, re-read each pass (below)
    // one chunk: its columns, then its values, then its x gathers, then
    // the sums (slot by slot, w inner)
    auto chunk = [&](int j0) {
      int c[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j)
        c[j] = j0 + j < nl ? __ldg(col + (j0 + j) * s) : 0;
      T a[CH][kRows][W];
#pragma unroll
      for (int j = 0; j < CH; ++j)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int w = 0; w < W; ++w)
            a[j][r][w] = j0 + j < nl && r < nv
                             ? ld_value(val + (r * W + w) * (L * s) +
                                            (j0 + j) * s, pol)
                             : T(0);
      T xv[CH][W];
#pragma unroll
      for (int j = 0; j < CH; ++j)
#pragma unroll
        for (int w = 0; w < W; ++w)
          xv[j][w] = j0 + j < nl ? __ldg(x + w * sN + c[j]) : T(0);
#pragma unroll
      for (int j = 0; j < CH; ++j)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int w = 0; w < W; ++w) acc[r] += a[j][r][w] * xv[j][w];
    };
#pragma unroll 1
    for (int p = 0; p < nl; p += kPass) {
      // the stride made opaque, so that no load offset is loop invariant
      // (see the note above)
      asm volatile("" : "+l"(s));
#pragma unroll
      for (int j0 = 0; j0 < kPass; j0 += CH) chunk(p + j0);
    }
  }

  // the groups' partial sums, added in group order
  __shared__ T part[kGroups - 1][kRows][kNodes];
  if (g > 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[g - 1][r][i] = acc[r];
  }
  __syncthreads();
  if (g == 0 && n < N) {
#pragma unroll
    for (int h = 0; h < kGroups - 1; ++h)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += part[h][r][i];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nv) y[(v0 + r) * sN + n] = acc[r];
  }
}

template <typename T, int W>
cudaError_t launch_w(const T* values, const int* cols, const T* x, T* y,
                     int V, int L, int N, bool stream, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((N + kNodes - 1) / kNodes),
                  static_cast<unsigned>((V + kRows - 1) / kRows));
  ell_matvec_kernel<T, W><<<grid, kBlock, 0, s>>>(values, cols, x, y, V,
                                                  L, N, stream);
  return cudaGetLastError();
}

template <typename T>
int launch_ell_matvec(const T* values, const int* cols, const T* x, T* y,
                      int V, int W, int L, int N, void* stream) {
  if (V < 1 || (V + kRows - 1) / kRows > 65535 || W < 1 ||
      W > rdc::kMaxV || L < 1)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  // values larger than the device's L2 load evict-first, so the column
  // table and x keep their lines from one Krylov iteration to the next;
  // smaller ones stay cached themselves, for the next call
  static const size_t l2 = [] {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, dev);
    return static_cast<size_t>(bytes);
  }();
  const bool big = static_cast<size_t>(V) * W * L * N * sizeof(T) > l2;
  switch (W) {
    case 1: return launch_w<T, 1>(values, cols, x, y, V, L, N, big, s);
    case 2: return launch_w<T, 2>(values, cols, x, y, V, L, N, big, s);
    case 3: return launch_w<T, 3>(values, cols, x, y, V, L, N, big, s);
    case 4: return launch_w<T, 4>(values, cols, x, y, V, L, N, big, s);
    case 5: return launch_w<T, 5>(values, cols, x, y, V, L, N, big, s);
    case 6: return launch_w<T, 6>(values, cols, x, y, V, L, N, big, s);
    case 7: return launch_w<T, 7>(values, cols, x, y, V, L, N, big, s);
    default: return launch_w<T, 8>(values, cols, x, y, V, L, N, big, s);
  }
}

}  // namespace

extern "C" int rdc_ell_matvec_f32(const float* values, const int* cols,
                                  const float* x, float* y, int V, int W,
                                  int L, int N, void* stream) {
  return launch_ell_matvec<float>(values, cols, x, y, V, W, L, N, stream);
}

extern "C" int rdc_ell_matvec_f64(const double* values, const int* cols,
                                  const double* x, double* y, int V, int W,
                                  int L, int N, void* stream) {
  return launch_ell_matvec<double>(values, cols, x, y, V, W, L, N, stream);
}
