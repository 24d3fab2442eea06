// Line-search merit sums, one thread per (candidate, scenario, node) instance.
//
// Replaces the TPU kernel _merit_kernel of
// bipedal_control_tpu/ops/pallas_merit.py (pallas_call in
// _merit_sums_flat_static).  Per instance: the centroidal flow at x (FK,
// fields, CMM, 6x6 inverse; centroidal_circuit.cuh), the RK2 midpoint flow
// (or euler), defect = F - x_next, and the masked equality residual
// (ocp/problem.py layout: 12 complementary zero-velocity / zero-force rows,
// 4 swing normal-velocity rows); out = [sum|d|, sum d^2, sum|e|, sum e^2].
//
// Design.  The TPU kernel put instances on the 128 vector lanes and unrolled
// the tree at trace time.  Here each thread owns one instance and walks the
// compiled-in tree with per-thread arrays of static size; the robot's
// numeric constants (~0.5k values) are staged once per block into shared
// memory, where all threads read the same addresses (broadcast).
//
// Bound: per-thread work and local memory.  An instance costs a few
// thousand flops over a few hundred live values per flow pass, more than
// the register file holds per thread, so the circuit's arrays spill to local
// memory (cached in L1/L2); the inputs are 79 values and the output 4, so
// device-memory traffic for the instance data is small.
#include <cuda_runtime.h>

#include "centroidal_circuit.cuh"

namespace {

using namespace circuit;

template <typename T>
__global__ void merit_kernel(const T* __restrict__ params, const T* __restrict__ xs, const T* __restrict__ us,
                             const T* __restrict__ xns, const T* __restrict__ flags,
                             const T* __restrict__ vref, const T* __restrict__ pref,
                             const T* __restrict__ dts, T* __restrict__ out, int M, T gain, int rk2) {
  __shared__ T P[P_SIZE];
  for (int i = threadIdx.x; i < P_SIZE; i += blockDim.x) P[i] = params[i];
  __syncthreads();
  const int inst = blockIdx.x * blockDim.x + threadIdx.x;
  if (inst >= M) return;

  T x[kNX], u[kNU], xn[kNX];
#pragma unroll
  for (int i = 0; i < kNX; ++i) {
    x[i] = xs[(size_t)inst * kNX + i];
    xn[i] = xns[(size_t)inst * kNX + i];
  }
#pragma unroll
  for (int i = 0; i < kNU; ++i) u[i] = us[(size_t)inst * kNU + i];
  const T dt = dts[inst];

  T f0[kNX], W[kNV][3], V0[kNV][3], pee[kNC][3], v[kNV];
  flow(P, x, u, f0, W, V0, pee, v);
  T d1 = T(0), d2 = T(0);
  {
    T F[kNX];
    if (rk2) {
      T x1[kNX], f1[kNX], W1[kNV][3], V01[kNV][3], pee1[kNC][3], v1[kNV];
#pragma unroll
      for (int i = 0; i < kNX; ++i) x1[i] = x[i] + T(0.5) * dt * f0[i];
      flow(P, x1, u, f1, W1, V01, pee1, v1);
#pragma unroll
      for (int i = 0; i < kNX; ++i) F[i] = x[i] + dt * f1[i];
    } else {
#pragma unroll
      for (int i = 0; i < kNX; ++i) F[i] = x[i] + dt * f0[i];
    }
#pragma unroll
    for (int i = 0; i < kNX; ++i) {
      const T d = F[i] - xn[i];
      d1 += fabs(d);
      d2 += d * d;
    }
  }

  T e1 = T(0), e2 = T(0);
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    const T fi = flags[(size_t)inst * kNC + i];
    const T swing = T(1) - fi;
    T vee[3];
    contact_velocity(P, i, W, V0, pee[i], v, vee);
    const T pz = pee[i][2];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T zv = (c == 2) ? vee[c] + gain * pz : vee[c];
      const T r = fi * zv + swing * u[3 * i + c];
      e1 += fabs(r);
      e2 += r * r;
    }
    const T nv = swing * (vee[2] - vref[(size_t)inst * kNC + i] + gain * (pz - pref[(size_t)inst * kNC + i]));
    e1 += fabs(nv);
    e2 += nv * nv;
  }
  out[(size_t)inst * 4 + 0] = d1;
  out[(size_t)inst * 4 + 1] = d2;
  out[(size_t)inst * 4 + 2] = e1;
  out[(size_t)inst * 4 + 3] = e2;
}

template <typename T>
int launch(const void* params, const void* xs, const void* us, const void* xns, const void* flags,
           const void* vref, const void* pref, const void* dts, void* out, int M, double gain, int rk2,
           void* stream) {
  if (M <= 0) return 0;
  const int threads = 128;
  const int blocks = (M + threads - 1) / threads;
  merit_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)params, (const T*)xs, (const T*)us, (const T*)xns, (const T*)flags, (const T*)vref,
      (const T*)pref, (const T*)dts, (T*)out, M, (T)gain, rk2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int merit_param_size() { return P_SIZE; }
extern "C" int merit_state_dim() { return kNX; }

#define MERIT_ENTRY(NAME, T)                                                                         \
  extern "C" int NAME(const void* params, const void* xs, const void* us, const void* xns,          \
                      const void* flags, const void* vref, const void* pref, const void* dts,       \
                      void* out, int M, double gain, int rk2, void* stream) {                       \
    return launch<T>(params, xs, us, xns, flags, vref, pref, dts, out, M, gain, rk2, stream);       \
  }

MERIT_ENTRY(merit_sums_f32, float)
MERIT_ENTRY(merit_sums_f64, double)
