// Shared definitions of the kernels of csrc/ (sm_90a): the transient
// qp-path kernels (TET4 affine, and the generic apply for HEX8), the solid
// path's block-ELL SpMV and the calibration lookup.  kK, kQ and PhiTable
// are TET4's and serve K1-K3 only; apply_generic.cu carries its own K, Q
// and phi table as template parameters.
//
// Every kernel here is built by fem/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into one shared library with a plain C interface, bound with ctypes in
// fem/kernels.py.  Each C entry point launches on the caller's stream,
// does not synchronise and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

namespace rdc {

constexpr int kMaxV = 8;      // species one launch can carry
constexpr int kK = 4;         // TET4 corners
constexpr int kQ = 5;         // Keast degree-3 quadrature points
constexpr int kThreads = 128; // threads per block (one element or node each)

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
