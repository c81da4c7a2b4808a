// Shared definitions of the kernels of csrc/ (sm_90a): the transient
// qp-path kernels (the affine ones for TET4 and TRI3, the generic ones for
// HEX8, PRISM6, PYRAMID5, TET10, QUAD4, QUAD8, QUAD9, HEX20 and HEX27),
// the solid path's block-ELL SpMV and the calibration lookup.  K1-K3 take
// the element's corner count K and quadrature count Q as template
// parameters, one instance per affine type (AFFINE_KQ in fem/kernels.py:
// TET4 (4, 5), TRI3 (3, 4)), with PhiTable sized for the largest;
// apply_generic.cu and gather_interp_generic.cu carry their own tables.
//
// Every kernel here is built by fem/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
// into one shared library with a plain C interface, bound with ctypes in
// fem/kernels.py.  Each C entry point launches on the caller's stream,
// does not synchronise and returns cudaGetLastError().
//
// K3, K4 and K6 launch from a plan: what stays fixed for a step or for a
// system's life (device pointers of the tables and stacks, shapes, the slot
// and phi tables, the launch configuration), written once by their *_plan
// entry point into a buffer the caller owns and keeps, so that a launch
// takes only the plan, the tensors that change per call and the stream.
#pragma once

#include <cuda_runtime.h>

namespace rdc {

constexpr int kMaxV = 8;      // species one launch can carry
constexpr int kMaxAffineQK = 5 * 4;  // phi entries of the largest affine
                                     // type built, TET4
constexpr int kThreads = 128; // threads per block (one element or node each)
// K6 and K8 (apply_generic.cuh, gather_interp_generic.cu): the largest
// phi table (K * Q entries) that rides in the kernel parameters, larger
// ones are read from a device copy; and the largest K whose gradient rows
// a thread keeps in registers (fem/kernels.py REG_ROWS mirrors it)
constexpr int kMaxQK = 14 * 10;
constexpr int kRegRows = 10;
constexpr int kPlanBytes = 2048;  // fem/kernels.py PLAN_BYTES: any plan fits

// The plan struct P in a caller's buffer of `bytes`, or nullptr if it does
// not fit.
template <typename P>
P* plan_cast(void* buf, int bytes) {
  static_assert(sizeof(P) <= kPlanBytes, "plan larger than kPlanBytes");
  return (buf != nullptr && bytes >= static_cast<int>(sizeof(P)))
             ? static_cast<P*>(buf)
             : nullptr;
}

// Makes a plan's device current for its scope when it is not already, and
// gives the caller's back after.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    if (cudaGetDevice(&prev_) == cudaSuccess && prev_ != device)
      cudaSetDevice(device);
    else
      prev_ = -1;
  }
  ~DeviceGuard() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

 private:
  int prev_ = -1;
};

// phi[q][k] (row-major) of an affine element, K * Q <= kMaxAffineQK
// entries, small enough to ride in the kernel parameters (constant bank)
// instead of device memory.
struct PhiTable {
  double v[kMaxAffineQK];
};

inline PhiTable phi_table(const double* host_phi, int K, int Q) {
  PhiTable t = {};
  for (int i = 0; i < Q * K; ++i) t.v[i] = host_phi[i];
  return t;
}

// The affine (K, Q) instances K1-K3 are built for: TET4, TRI3.
inline bool affine_kq(int K, int Q) {
  return (K == 4 && Q == 5) || (K == 3 && Q == 4);
}

inline unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace rdc
