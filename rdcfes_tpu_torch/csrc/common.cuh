// Shared definitions of the kernels of csrc/ (sm_90a): the transient
// qp-path kernels (TET4 affine, and the generic ones for HEX8, PRISM6,
// PYRAMID5 and TET10), the solid path's block-ELL SpMV and the
// calibration lookup.  kK, kQ and PhiTable
// are TET4's and serve K1-K3 only; apply_generic.cu carries its own K, Q
// and phi table as template parameters.
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
constexpr int kK = 4;         // TET4 corners
constexpr int kQ = 5;         // Keast degree-3 quadrature points
constexpr int kThreads = 128; // threads per block (one element or node each)
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

// phi[q][k] (row-major), small enough to ride in the kernel parameters
// (constant bank) instead of device memory.
struct PhiTable {
  double v[kQ * kK];
};

inline PhiTable phi_table(const double* host_phi) {
  PhiTable t;
  for (int i = 0; i < kQ * kK; ++i) t.v[i] = host_phi[i];
  return t;
}

inline unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace rdc
