// K6 apply_generic: the launch plan and the C entry points (the kernel
// and its design: apply_generic.cuh; its instances: apply_generic_*.cu).
#include "apply_generic.cuh"

namespace rdc_generic {

RDC_GENERIC_KQ(RDC_GENERIC_EXTERN)

namespace {

template <typename T>
const void* kernel_ptr(int V, int K, int Q) {
#define RDC_KERNEL_PTR(KK, QQ) \
  if (K == KK && Q == QQ)      \
    return reinterpret_cast<const void*>(kernel_for<T, KK, QQ>(V));
  RDC_GENERIC_KQ(RDC_KERNEL_PTR)
#undef RDC_KERNEL_PTR
  return nullptr;
}

template <typename T>
int launch_generic(const void* plan, const T* x, T* Ye, void* stream) {
  const GenericPlan& p = *static_cast<const GenericPlan*>(plan);
  if (p.elem_bytes != static_cast<int>(sizeof(T))) return cudaErrorInvalidValue;
  if (p.E == 0) return cudaSuccess;
  const rdc::DeviceGuard guard(p.device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RDC_LAUNCH_KQ(KK, QQ) \
  if (p.K == KK && p.Q == QQ) return launch_kq<T, KK, QQ>(p, x, Ye, st);
  RDC_GENERIC_KQ(RDC_LAUNCH_KQ)
#undef RDC_LAUNCH_KQ
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<size_t>(ptr) % 16 == 0;
}

}  // namespace
}  // namespace rdc_generic

using namespace rdc_generic;

// The launch plan of one set of stacks (C (nC, Q, E), D (nD, Q, 3, E), Es
// (nE, Q, E)) with the element tables conn_T (K, E), JxW (Q, E) and dphi
// (Q, K, 3, E) on `device`, for x (V, N), in elements of elem_bytes (4 or
// 8).  slots_host: int32[3 * kMaxV * kMaxV] on the host, the C, D and E
// tables in turn, each row-major (v, w) -> plane index or -1.  phi_host:
// double[Q * K] on the host, row-major; phi_dev: the same table in the
// plan's type on `device` (read by the instances whose K * Q exceeds
// kMaxQK; it must outlive the plan).  Chooses the tile and the stage
// depth, and raises the kernel's shared-memory limit where it needs to.
extern "C" int rdc_apply_generic_plan(
    void* plan, int plan_bytes, const int* conn_T, const void* JxW,
    const void* dphi, const void* C, const void* D, const void* Es,
    const int* slots_host, const double* phi_host, const void* phi_dev,
    int V, int N, int K, int Q, int E, int nC, int nD, int nE,
    int elem_bytes, int device) {
  GenericPlan* p = rdc::plan_cast<GenericPlan>(plan, plan_bytes);
  if (p == nullptr || V < 1 || V > M || N < 0 || E < 0 || nC < 0 ||
      nD < 0 || nE < 0 || (elem_bytes != 4 && elem_bytes != 8) ||
      (K * Q > kMaxQK && phi_dev == nullptr))
    return cudaErrorInvalidValue;
  const void* kern = elem_bytes == 4 ? kernel_ptr<float>(V, K, Q)
                                     : kernel_ptr<double>(V, K, Q);
  if (kern == nullptr) return cudaErrorInvalidValue;
  *p = GenericPlan{};
  p->conn_T = conn_T;
  p->JxW = JxW;
  p->dphi = dphi;
  p->C = C;
  p->D = D;
  p->Es = Es;
  constexpr int MM = M * M;
  for (int i = 0; i < MM; ++i) {
    p->slots.c[i] = slots_host[i];
    p->slots.d[i] = slots_host[MM + i];
    p->slots.e[i] = slots_host[2 * MM + i];
  }
  if (K * Q <= kMaxQK)
    for (int i = 0; i < Q * K; ++i) p->phi[i] = phi_host[i];
  p->phi_dev = phi_dev;
  p->V = V;
  p->N = N;
  p->K = K;
  p->Q = Q;
  p->E = E;
  p->nC = nC;
  p->nD = nD;
  p->nE = nE;
  p->elem_bytes = elem_bytes;
  p->device = device;
  // the deepest staging of the widest tile that leaves room for two
  // blocks an SM, else for one
  const int R = 3 * K + 1 + nC + 3 * nD + nE;
  const long long phi_bytes =
      K > kRegRows ? static_cast<long long>(Q) * K * elem_bytes : 0;
  const int configs[4][2] = {{32, 3}, {32, 2}, {16, 3}, {16, 2}};
  const int limits[2] = {kSmemTwoBlocks, kSmemMax};
  p->te = 0;
  for (int limit : limits) {
    for (const auto& c : configs) {
      const long long smem =
          static_cast<long long>(c[1] * R + 4 * V) * c[0] * elem_bytes +
          R * kRowBytes + phi_bytes;
      if (smem <= limit) {
        p->te = c[0];
        p->stages = c[1];
        p->smem = static_cast<int>(smem);
        break;
      }
    }
    if (p->te) break;
  }
  if (p->te == 0) return cudaErrorInvalidValue;
  p->vec = (static_cast<long long>(E) * elem_bytes) % 16 == 0 &&
           aligned16(JxW) && aligned16(dphi) && (nC == 0 || aligned16(C)) &&
           (nD == 0 || aligned16(D)) && (nE == 0 || aligned16(Es));
  if (p->smem > 48 * 1024) {
    const rdc::DeviceGuard guard(device);
    return cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                p->smem);
  }
  return cudaSuccess;
}

// x (V, N) -> Ye (V, K, E) with the plan's tables and stacks.
extern "C" int rdc_apply_generic_f32(const void* plan, const float* x,
                                     float* Ye, void* stream) {
  return launch_generic<float>(plan, x, Ye, stream);
}

extern "C" int rdc_apply_generic_f64(const void* plan, const double* x,
                                     double* Ye, void* stream) {
  return launch_generic<double>(plan, x, Ye, stream);
}
