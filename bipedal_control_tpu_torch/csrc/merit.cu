// Line-search merit sums per (candidate, scenario, node) instance, one
// warp-synchronous group of lanes per instance.
//
// Replaces the TPU kernel _merit_kernel of
// bipedal_control_tpu/ops/pallas_merit.py (pallas_call in
// _merit_sums_flat_static).  Per instance: the centroidal flow at x (FK,
// fields, CMM, 6x6 inverse; centroidal_circuit.cuh), the RK2 midpoint flow
// (or euler), defect = F - x_next, and the masked equality residual
// (ocp/problem.py layout: 12 complementary zero-velocity / zero-force rows,
// 4 swing normal-velocity rows); out = [sum|d|, sum d^2, sum|e|, sum e^2].
//
// Bound: the inputs are 79 values and the output 4, so the card's bound is
// operations (chip_smoke.py phase 4 prints it: a few microseconds); what the
// kernel spends is the latency and issue of two centroidal passes per
// instance.
//
// Design.  The group form of the circuit, as the linearization uses it:
// kG lanes per instance (16 for H1, two instances per warp), the pass at x,
// the midpoint, the pass at x1 (one copy of the pass's code in a loop).
// After the first pass lane l adds its column to each contact velocity
// J_i v = sum_l move(b_i, l) (v0_l + w_l x p_i) v_l from the w_l, v0_l it
// holds in registers, and the 12 sums are reduced by shuffles; lane r then
// takes equality row r, and each lane its share of the 22 defect rows.  The
// four sums are reduced by shuffles within the group and lane 0 stores
// them.  No per-thread array of width kNX or kNV is live across a pass.
// Occupancy (H1's shapes, float32): 128-thread blocks (8 instances), 80
// registers and no spills under __launch_bounds__(128, 6); shared memory
// 2,000 B of parameters, 7,040 B of leaves and 8 instances of 2,964 B:
// 32,752 B a block, so 6 blocks = 24 warps = 48 instances per SM.  float64:
// (128, 3), 65,504 B a block, 12 warps per SM.  No block-wide barrier after
// the parameter buffer is staged.
// The first version gave each thread a whole instance (two one-thread flow
// passes, ~1k live values): 255 registers, 4,876 B of spill stores per
// thread in float32, 134 blocks of 4 warps for 17,152 instances, 0.10 ms.
#include <cuda_runtime.h>

#include "centroidal_circuit.cuh"

namespace {

using namespace circuit;

constexpr int kThreads = 128;
constexpr int kInstPerBlock = kThreads / kG;
constexpr int kMinBlocksF32 = 6;  // 6 x 128 threads a SM: at most 85 registers a thread

template <typename T>
struct InstBody {
  Pass<T> s;
  T x[kNX], u[kNU], x1[kNX];
};
template <typename T>
using Inst = OddStride<T, InstBody<T>>;

template <typename T>
__host__ __device__ constexpr size_t leaf_bytes() {  // the block's per-body leaves, 16-byte rows
  return kInstPerBlock * kNB * kLeaf * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kMinBlocksF32 : 3)
    merit_kernel(const T* __restrict__ params, const T* __restrict__ xs, const T* __restrict__ us,
                 const T* __restrict__ xns, const T* __restrict__ flags, const T* __restrict__ vref,
                 const T* __restrict__ pref, const T* __restrict__ dts, T* __restrict__ out, int M, T gain,
                 int rk2) {
  extern __shared__ __align__(16) unsigned char k4_smem[];
  T* P = reinterpret_cast<T*>(k4_smem);
  for (int i = threadIdx.x; i < P_SIZE; i += blockDim.x) P[i] = params[i];
  __syncthreads();  // the only block-wide barrier

  const Group g = this_group();
  const int lane = g.lane;
  const Slot slot = this_slot<kInstPerBlock>(M);
  if (slot.warp_done) return;
  T* leaf = reinterpret_cast<T*>(k4_smem + param_bytes<T>()) + (threadIdx.x / kG) * (kNB * kLeaf);
  Inst<T>& I = reinterpret_cast<Inst<T>*>(k4_smem + param_bytes<T>() + leaf_bytes<T>())[threadIdx.x / kG];
  Pass<T>& s = I.s;
  const unsigned moved = moved_bodies(P, lane);
  const size_t o = slot.inst;

  for (int k = lane; k < kNX; k += kG) I.x[k] = xs[o * kNX + k];
  for (int k = lane; k < kNU; k += kG) I.u[k] = us[o * kNU + k];
  const T dt = dts[o];
  g.sync();

  // pass 0 at x: the equality residual; pass 1 (rk2) at the midpoint x1.
  // One copy of the pass's code serves both.
  T w[3], v0[3], Acol[6];
  T e1 = T(0), e2 = T(0);
#pragma unroll 1
  for (int pass = 0; pass <= rk2; ++pass) {
    if (pass > 0) g.sync();  // every lane is done with the first pass
    centroidal_pass(P, pass == 0 ? I.x : I.x1, I.u, s, leaf, g, moved, w, v0, Acol);
    if (pass > 0) break;
    if (rk2)
      for (int k = lane; k < kNX; k += kG) I.x1[k] = I.x[k] + T(0.5) * dt * s.f[k];

    // contact velocities J_i v: lane l's column, summed over the group
    T vee[kNC][3];
#pragma unroll
    for (int i = 0; i < kNC; ++i) {
      T wxp[3];
      cross3(w, s.pee[i], wxp);
      const bool mv = moves(moved, contact_body(i));
      const T vl = lane < kNV ? s.v[lane] : T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c) vee[i][c] = g.sum(mv ? (v0[c] + wxp[c]) * vl : T(0));
    }
    // equality row lane
    if (lane < kNE) {
      const int i = lane < kNF ? lane / 3 : lane - kNF;
      const T fi = flags[o * kNC + i];
      const T swing = T(1) - fi;
      const T pz = s.pee[i][2];
      T vz[3] = {T(0), T(0), T(0)};  // contact i's velocity, picked by 0/1 weights (no run-time index)
#pragma unroll
      for (int k = 0; k < kNC; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) vz[c] += (i == k ? T(1) : T(0)) * vee[k][c];
      T r;
      if (lane < kNF) {
        const int c = lane % 3;
        const T v = c == 0 ? vz[0] : (c == 1 ? vz[1] : vz[2] + gain * pz);
        r = fi * v + swing * I.u[lane];
      } else {
        r = swing * (vz[2] - vref[o * kNC + i] + gain * (pz - pref[o * kNC + i]));
      }
      e1 = fabs(r);
      e2 = r * r;
    }
  }
  T d1 = T(0), d2 = T(0);
  for (int k = lane; k < kNX; k += kG) {
    const T d = I.x[k] + dt * s.f[k] - xns[o * kNX + k];
    d1 += fabs(d);
    d2 += d * d;
  }
  d1 = g.sum(d1);
  d2 = g.sum(d2);
  e1 = g.sum(e1);
  e2 = g.sum(e2);
  if (lane == 0 && slot.live) {
    out[o * 4 + 0] = d1;
    out[o * 4 + 1] = d2;
    out[o * 4 + 2] = e1;
    out[o * 4 + 3] = e2;
  }
}

template <typename T>
size_t smem_bytes() {
  return param_bytes<T>() + leaf_bytes<T>() + kInstPerBlock * sizeof(Inst<T>);
}

template <typename T>
int launch(const void* params, const void* xs, const void* us, const void* xns, const void* flags,
           const void* vref, const void* pref, const void* dts, void* out, int M, double gain, int rk2,
           void* stream) {
  if (M <= 0) return 0;
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(merit_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + kInstPerBlock - 1) / kInstPerBlock;
  merit_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)params, (const T*)xs, (const T*)us, (const T*)xns, (const T*)flags, (const T*)vref,
      (const T*)pref, (const T*)dts, (T*)out, M, (T)gain, rk2);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm() {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(merit_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, merit_kernel<T>, kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" int merit_param_size() { return P_SIZE; }
extern "C" int merit_state_dim() { return kNX; }
extern "C" int merit_block_threads() { return kThreads; }
// resident blocks per SM of the float32 (4) or float64 (8) kernel, or -(CUDA error)
extern "C" int merit_blocks_per_sm(int dtype_bytes) {
  return dtype_bytes == 4 ? blocks_per_sm<float>() : blocks_per_sm<double>();
}

#define MERIT_ENTRY(NAME, T)                                                                         \
  extern "C" int NAME(const void* params, const void* xs, const void* us, const void* xns,          \
                      const void* flags, const void* vref, const void* pref, const void* dts,       \
                      void* out, int M, double gain, int rk2, void* stream) {                       \
    return launch<T>(params, xs, us, xns, flags, vref, pref, dts, out, M, gain, rk2, stream);       \
  }

MERIT_ENTRY(merit_sums_f32, float)
MERIT_ENTRY(merit_sums_f64, double)
