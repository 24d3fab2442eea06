// Whole-node linearization (A, B, c, C, D, e) per (scenario, node) instance.
//
// Replaces the TPU kernels _lin_kernel and _lin_kernel_fields of
// bipedal_control_tpu/ops/pallas_linearize_kernel.py (pallas_call in
// linearize_flat_static and linearize_lanes_batched), whose body is
// linearize_node_lanes.  Per instance: FK, velocity fields, CMM, the base
// block inverse, v, contact Jacobians and dA(q)v (centroidal_circuit.cuh);
// the block-sparse same-point RK2 (or euler) A and B,
//   A = I + dt Jx + h Jx^2,  B = dt Ju + h Jx Ju,  h = dt^2 / 2 (0 for euler),
// with Jx's nonzero blocks Pq (rows 3:6, q columns), m Ab^{-1} (rows 6:12, h
// columns) and Nq = -Ab^{-1} dA_v (rows 6:12, q columns); the exact RK2 value
// c = x + dt f(x + dt/2 f(x, u), u) - x_next from a second centroidal pass;
// and the contact-masked C, D, e of ocp/linearize.py::_eq_jacobians.
// Outputs are batch-leading, A (M,nx,nx), B (M,nx,nu), c (M,nx),
// C (M,16,nx), D (M,16,nu), e (M,16): what riccati.cu reads, no transpose.
//
// Bound: the card's bound is bytes (an instance reads 79 values and writes
// 1,710, 6.8 KB in float32; its ~45k operations take less time at the
// float32 rate; chip_smoke.py phase 5 prints both), but what the kernel
// spends is latency and issue: each instance is a chain of dependent steps
// (FK down the tree, the CMM, inv6, the derivative columns, the outputs,
// the midpoint pass), ~7k instructions per warp.
//
// Design (one warp-synchronous group of kG = 16 lanes per instance for H1,
// two instances per warp; 8 instances per 128-thread block):
// - No block-wide barrier after the parameter buffer is staged: an
//   instance's lanes meet at __syncwarp only.  A warp past the end of a
//   ragged grid returns at once; a group past it inside a live warp computes
//   on the last instance and stores nothing.
// - The circuit is spread over the lanes (centroidal_circuit.cuh): FK by
//   tree level, the CMM from per-body leaves, inv6 and the flow value by
//   independent entries.  One copy of the pass's code serves both passes
//   (a loop over them), which halves the code the SM fetches.
// - Lane l owns q-column l of every column stack: its contact Jacobian
//   column, dA_v, Nq, GJ = -Ab^{-1} A_j, Pq and dv_ee/dq stay in its
//   registers.  Only what other lanes need goes to shared memory (Exchange:
//   the Jacobians' rows, the base-column rows of Pq and Nq, m Ab^{-1},
//   taken once per instance), in the leaf block that the CMM no longer
//   needs, with 16-byte rows.
// - Each lane writes the output entries it owns from its registers: its
//   q-column of A's rows 3:12, its force or joint column of B's rows 3:12,
//   its q-column of C, its column of D, and (one lane per row) C's base
//   columns and e.  A's identity rows and B's dt / m and dt rows are
//   written as constants.
// - The rk2 midpoint pass runs after the stores are issued, so it overlaps
//   their drain; only c waits for it.
// Occupancy (H1's shapes): __launch_bounds__(128, 4) in float32 holds a
// thread to 128 registers (65,536 / (4 x 128)); ptxas spills ~250 B.  A
// block's shared memory is the 2,000 B parameter buffer, 8 leaf blocks of
// 1,248 B and 8 instances of 3,108 B: 36,848 B, so 4 blocks (147 KB of the
// SM's 227 KB) = 16 warps = 32 instances are resident per SM (12 and 24
// for the first version).  float64: (128, 2), 255 registers, 73,696 B a
// block, 8 warps per SM.  A 168-register build (3 blocks, 12 warps, no
// spills) measured the same time (PERF.md).
// The first version (block-wide barriers, FK, inv6 and the flow in lane 0,
// every output element recomputed by a branchy per-element function, 168
// registers) took 0.46-0.48 ms at M = 17,152 on the H100; PERF.md has both.
#include <cuda_runtime.h>

#include "centroidal_circuit.cuh"

namespace {

using namespace circuit;

constexpr int kThreads = 128;
constexpr int kInstPerBlock = kThreads / kG;
constexpr int kMinBlocksF32 = 4;  // 4 x 128 threads a SM: 128 registers a thread

template <typename T>
struct InstBody {
  Pass<T> s;  // centroidal evaluation (at x, then at the midpoint x1)
  T x[kNX], u[kNU], xn[kNX], x1[kNX], flags[kNC], vref[kNC], pref[kNC], dt;
};
template <typename T>
using Inst = OddStride<T, InstBody<T>>;

// What the lanes share after the derivative columns, in the instance's
// 16-byte aligned leaf block (dead once the CMM is known; the midpoint pass
// rewrites it after the outputs).  Rows are padded to 16 bytes, so a lane
// reads a Jacobian row or a 6-row in 16-byte loads.
constexpr int kRow = (kNV + 3) / 4 * 4;
template <typename T>
struct Exchange {
  T Jee[kNF][kRow];  // contact Jacobians, row 3i + c
  T Pq6[3][8];       // Pq's base columns
  T Nq6[6][8];       // Nq's base columns
  T mAbi[6][8];      // m Ab^{-1}
};
// the instance's leaf block: the CMM's per-body leaves, then the exchange
template <typename T>
__host__ __device__ constexpr int scratch_words() {
  return (cmax(kNB * kLeaf, (int)(sizeof(Exchange<T>) / sizeof(T))) + 3) / 4 * 4;
}

// skew(p_i - com)[a][b]
template <typename T>
__device__ __forceinline__ T skew_rel(const Pass<T>& s, int i, int a, int b) {
  if (a == b) return T(0);
  const int k = 3 - a - b;  // the component that is not a or b
  const T rk = s.pee[i][k] - s.com[k];
  return ((a + 1) % 3 == b) ? -rk : rk;
}

template <typename T>
__host__ __device__ constexpr size_t leaf_bytes() {  // the block's leaf blocks, 16-byte aligned
  return kInstPerBlock * scratch_words<T>() * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kMinBlocksF32 : 2)
    linearize_kernel(const T* __restrict__ params, const T* __restrict__ xs, const T* __restrict__ us,
                     const T* __restrict__ xns, const T* __restrict__ flags, const T* __restrict__ vref,
                     const T* __restrict__ pref, const T* __restrict__ dts, T* __restrict__ Aout,
                     T* __restrict__ Bout, T* __restrict__ cdef, T* __restrict__ Cout, T* __restrict__ Dout,
                     T* __restrict__ eout, int M, T gain, int rk2) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  T* P = reinterpret_cast<T*>(k1_smem);
  for (int i = threadIdx.x; i < P_SIZE; i += blockDim.x) P[i] = params[i];
  __syncthreads();  // the only block-wide barrier

  const Group g = this_group();
  const int lane = g.lane;
  const Slot slot = this_slot<kInstPerBlock>(M);
  if (slot.warp_done) return;
  T* leaf = reinterpret_cast<T*>(k1_smem + param_bytes<T>()) + (threadIdx.x / kG) * scratch_words<T>();
  Inst<T>& I = reinterpret_cast<Inst<T>*>(k1_smem + param_bytes<T>() + leaf_bytes<T>())[threadIdx.x / kG];
  Pass<T>& s = I.s;
  const unsigned moved = moved_bodies(P, lane);
  const size_t o = slot.inst;

  for (int k = lane; k < kNX; k += kG) {
    I.x[k] = xs[o * kNX + k];
    I.xn[k] = xns[o * kNX + k];
  }
  for (int k = lane; k < kNU; k += kG) I.u[k] = us[o * kNU + k];
  if (lane < kNC) {
    I.flags[lane] = flags[o * kNC + lane];
    I.vref[lane] = vref[o * kNC + lane];
    I.pref[lane] = pref[o * kNC + lane];
  }
  if (lane == 0) I.dt = dts[o];
  g.sync();
  const T dt = I.dt;
  const T h = rk2 ? T(0.5) * dt * dt : T(0);
  const T m = P[P_ROBOT_MASS];

  // pass 0 at x: the derivative columns and every output but c (rk2); pass 1
  // at the midpoint x1: c.  One copy of the pass's code serves both.
  T w[3], v0[3], Acol[6];
#pragma unroll 1
  for (int pass = 0; pass <= rk2; ++pass) {
    if (pass > 0) g.sync();  // the outputs' reads of s are done
    centroidal_pass(P, pass == 0 ? I.x : I.x1, I.u, s, leaf, g, moved, w, v0, Acol);
    if (pass == rk2 && slot.live)
      for (int k = lane; k < kNX; k += kG) cdef[o * kNX + k] = I.x[k] + dt * s.f[k] - I.xn[k];
    if (pass > 0) break;
    if (rk2)
      for (int k = lane; k < kNX; k += kG) I.x1[k] = I.x[k] + T(0.5) * dt * s.f[k];

    // derivative columns: lane l owns q-column l
    const bool col = lane < kNV;
    T J[kNC][3], dJ[kNC][3], Nq[6], GJ[6], Pq[3];
    if (col) {
      T dA[6];
      contact_jacobian_column(s, moved, w, v0, J);
      cmm_v_derivative_column(P, s, lane, moved, w, v0, Acol, J, dA, dJ);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T acc = T(0), acc2 = T(0);
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          acc += s.Abi[6 * r + q] * dA[q];
          acc2 += s.Abi[6 * r + q] * Acol[q];
        }
        Nq[r] = -acc;
        GJ[r] = -acc2;  // d v_b / d v_j of joint lane - 6 (used by lanes >= 6)
      }
      // Pq = sum_i (J_i - dcom) x F_i / m
      const T total_mass = P[P_TOTAL_MASS];
      const T dcom[3] = {Acol[0] / total_mass, Acol[1] / total_mass, Acol[2] / total_mass};
      T cr[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int i = 0; i < kNC; ++i) {
        const T drel[3] = {J[i][0] - dcom[0], J[i][1] - dcom[1], J[i][2] - dcom[2]};
        T t[3];
        cross3(drel, I.u + 3 * i, t);
#pragma unroll
        for (int c = 0; c < 3; ++c) cr[c] += t[c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) Pq[c] = cr[c] / m;
    }
    // the leaves are dead since the CMM (the flow value's steps synchronised)
    Exchange<T>& X = *reinterpret_cast<Exchange<T>*>(leaf);
    if (col) {
#pragma unroll
      for (int i = 0; i < kNC; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) X.Jee[3 * i + c][lane] = J[i][c];
      if (lane < 6) {
#pragma unroll
        for (int r = 0; r < 3; ++r) X.Pq6[r][lane] = Pq[r];
#pragma unroll
        for (int r = 0; r < 6; ++r) X.Nq6[r][lane] = Nq[r];
      }
    }
    for (int k = lane; k < 36; k += kG) X.mAbi[k / 6][k % 6] = m * s.Abi[k];
    g.sync();
    if (!slot.live) continue;

    const T dtm = dt / m;
    T* Ai = Aout + o * kNX * kNX;
    T* Bi = Bout + o * kNX * kNU;
    T* Ci = Cout + o * kNE * kNX;
    T* Di = Dout + o * kNE * kNU;
    // ------------------------------------------------------------------ A
    // A's identity rows 0:3 and 12:22, as constants
    for (int k = lane; k < 3 * kNX; k += kG) Ai[k] = (k % (kNX + 1) == 0) ? T(1) : T(0);
    for (int k = 12 * kNX + lane; k < kNX * kNX; k += kG) Ai[k] = (k % (kNX + 1) == 0) ? T(1) : T(0);
    if (col) {  // q-column 6 + lane of rows 3:12
      const int c = 6 + lane;
#pragma unroll
      for (int ri = 0; ri < 3; ++ri) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += X.Pq6[ri][q] * Nq[q];
        T val = (3 + ri == c) ? T(1) : T(0);
        val += dt * Pq[ri] + h * acc;
        Ai[(3 + ri) * kNX + c] = val;
      }
#pragma unroll
      for (int ri = 0; ri < 6; ++ri) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < 3; ++j) acc += X.mAbi[ri][3 + j] * Pq[j];
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += X.Nq6[ri][q] * Nq[q];
        T val = (6 + ri == c) ? T(1) : T(0);
        val += dt * Nq[ri] + h * acc;
        Ai[(6 + ri) * kNX + c] = val;
      }
    }
    if (lane < 6) {  // h-column lane of rows 3:12
      const int c = lane;
#pragma unroll
      for (int ri = 0; ri < 3; ++ri) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += X.Pq6[ri][q] * X.mAbi[q][c];
        T val = (3 + ri == c) ? T(1) : T(0);
        val += h * acc;
        Ai[(3 + ri) * kNX + c] = val;
      }
#pragma unroll
      for (int ri = 0; ri < 6; ++ri) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += X.Nq6[ri][q] * X.mAbi[q][c];
        T val = T(0);
        val += dt * X.mAbi[ri][c] + h * acc;
        Ai[(6 + ri) * kNX + c] = val;
      }
    }
    // ------------------------------------------------------------------ B
    // the dt / m rows 0:3 and the dt rows 12:22, as constants
    for (int k = lane; k < 3 * kNU; k += kG) {
      const int r = k / kNU, c = k - r * kNU;
      Bi[k] = (c < kNF && c % 3 == r) ? dtm : T(0);
    }
    for (int k = 12 * kNU + lane; k < kNX * kNU; k += kG) {
      const int r = k / kNU, c = k - r * kNU;
      Bi[k] = (c == r) ? dt : T(0);
    }
    if (lane < kNF) {  // force column lane of rows 3:12
      const int c = lane, i = c / 3, cc = c % 3;
#pragma unroll
      for (int ri = 0; ri < 3; ++ri) Bi[(3 + ri) * kNU + c] = dtm * skew_rel(s, i, ri, cc);
#pragma unroll
      for (int ri = 0; ri < 6; ++ri) {
        T ent = s.Abi[6 * ri + cc];  // (m Ab^-1 / m) [I | skew(p_i - com)]
#pragma unroll
        for (int t = 0; t < 3; ++t) ent += s.Abi[6 * ri + 3 + t] * skew_rel(s, i, t, cc);
        Bi[(6 + ri) * kNU + c] = h * ent;
      }
    }
    if (col && lane >= 6) {  // joint column kNF + lane - 6 of rows 3:12
      const int c = kNF + lane - 6;
#pragma unroll
      for (int ri = 0; ri < 3; ++ri) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += X.Pq6[ri][q] * GJ[q];
        Bi[(3 + ri) * kNU + c] = h * (acc + Pq[ri]);
      }
#pragma unroll
      for (int ri = 0; ri < 6; ++ri) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += X.Nq6[ri][q] * GJ[q];
        Bi[(6 + ri) * kNU + c] = dt * GJ[ri] + h * (acc + Nq[ri]);
      }
    }
    // ------------------------------------------------------------------ C, D
    if (col) {  // q-column 6 + lane of C: d v_ee / dq = dJ_v + J6 Nq (+ gain dp_z/dq on the z rows)
      T dzv[kNF];
#pragma unroll
      for (int i = 0; i < kNC; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T acc = dJ[i][c];
#pragma unroll
          for (int q = 0; q < 6; ++q) acc += X.Jee[3 * i + c][q] * Nq[q];
          if (c == 2) acc += gain * J[i][2];
          dzv[3 * i + c] = acc;
        }
#pragma unroll
      for (int r = 0; r < kNE; ++r) {
        const T wgt = r < kNF ? I.flags[r / 3] : T(1) - I.flags[r - kNF];
        Ci[r * kNX + 6 + lane] = wgt * dzv[r < kNF ? r : 3 * (r - kNF) + 2];
      }
    }
    if (lane < kNE) {  // row lane of C's h-columns, and e
      const int r = lane;
      const int i = r < kNF ? r / 3 : r - kNF;
      const int row = r < kNF ? r : 3 * i + 2;
      const T fi = I.flags[i];
      const T wgt = r < kNF ? fi : T(1) - fi;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        T acc = T(0);
#pragma unroll
        for (int t = 0; t < 6; ++t) acc += X.Jee[row][t] * X.mAbi[t][c];
        Ci[r * kNX + c] = wgt * acc;
      }
      T vee = T(0);
#pragma unroll
      for (int l = 0; l < kNV; ++l) vee += X.Jee[row][l] * s.v[l];
      T ev;
      if (r < kNF) {
        if (r % 3 == 2) vee += gain * s.pee[i][2];
        ev = fi * vee + (T(1) - fi) * I.u[r];
      } else {
        ev = (T(1) - fi) * (vee - I.vref[i] + gain * (s.pee[i][2] - I.pref[i]));
      }
      eout[o * kNE + r] = ev;
    }
    if (lane < kNF) {  // force column lane of D: 1 - flag on the diagonal of the first 12 rows
      const T sw = T(1) - I.flags[lane / 3];
#pragma unroll
      for (int r = 0; r < kNE; ++r) Di[r * kNU + lane] = (r == lane) ? sw : T(0);
    }
    if (col && lane >= 6) {  // joint column kNF + lane - 6 of D: d v_ee / d v_j = J6 GJ + J_ee[:, lane]
      const int c = kNF + lane - 6;
      T dvee[kNF];
#pragma unroll
      for (int row = 0; row < kNF; ++row) {
        T acc = J[row / 3][row % 3];
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += X.Jee[row][q] * GJ[q];
        dvee[row] = acc;
      }
#pragma unroll
      for (int r = 0; r < kNE; ++r)
        Di[r * kNU + c] = r < kNF ? I.flags[r / 3] * dvee[r] : (T(1) - I.flags[r - kNF]) * dvee[3 * (r - kNF) + 2];
    }

  }
}

template <typename T>
size_t smem_bytes() {
  return param_bytes<T>() + leaf_bytes<T>() + kInstPerBlock * sizeof(Inst<T>);
}

template <typename T>
int launch(const void* params, const void* xs, const void* us, const void* xns, const void* flags,
           const void* vref, const void* pref, const void* dts, void* A, void* B, void* c, void* C, void* D,
           void* e, int M, double gain, int rk2, void* stream) {
  if (M <= 0) return 0;
  const size_t smem = smem_bytes<T>();
  cudaError_t err =
      cudaFuncSetAttribute(linearize_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + kInstPerBlock - 1) / kInstPerBlock;
  linearize_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)params, (const T*)xs, (const T*)us, (const T*)xns, (const T*)flags, (const T*)vref,
      (const T*)pref, (const T*)dts, (T*)A, (T*)B, (T*)c, (T*)C, (T*)D, (T*)e, M, (T)gain, rk2);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm() {
  const size_t smem = smem_bytes<T>();
  cudaError_t err =
      cudaFuncSetAttribute(linearize_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, linearize_kernel<T>, kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" int linearize_param_size() { return P_SIZE; }
extern "C" int linearize_state_dim() { return kNX; }
extern "C" int linearize_input_dim() { return kNU; }
extern "C" int linearize_block_threads() { return kThreads; }
// resident blocks per SM of the float32 (4) or float64 (8) kernel, or -(CUDA error)
extern "C" int linearize_blocks_per_sm(int dtype_bytes) {
  return dtype_bytes == 4 ? blocks_per_sm<float>() : blocks_per_sm<double>();
}

#define LINEARIZE_ENTRY(NAME, T)                                                                       \
  extern "C" int NAME(const void* params, const void* xs, const void* us, const void* xns,            \
                      const void* flags, const void* vref, const void* pref, const void* dts, void* A, \
                      void* B, void* c, void* C, void* D, void* e, int M, double gain, int rk2,       \
                      void* stream) {                                                                 \
    return launch<T>(params, xs, us, xns, flags, vref, pref, dts, A, B, c, C, D, e, M, gain, rk2,     \
                     stream);                                                                         \
  }

LINEARIZE_ENTRY(linearize_f32, float)
LINEARIZE_ENTRY(linearize_f64, double)
