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
//
// Design.  The TPU kernel put 128 instances on the vector lanes and unrolled
// everything with the robot's constants baked in.  One GPU thread per
// instance would carry the fields, J_ee, dA_v, Nq and the per-body P/W
// aggregates (~1k live values) and spill most of them; so a group of kNV
// threads (16 for H1: two instances per warp) evaluates one instance, lane l
// owning coordinate column l of every column stack (fields, CMM, J_ee, dA_v,
// Nq, Pq, dv_ee/dq).  What the instance shares (FK, body coms and inertias,
// com, Ab^{-1}, v, contact positions, flow value) is computed once into
// shared memory: FK, inv6 and the flow value by lane 0, per-body and
// per-column pieces by one lane each.  The 1,710 outputs per instance are
// then written by the whole block from shared memory, element by element in
// output order, so each field is one contiguous store stream: batch-leading
// A (M,nx,nx), B (M,nx,nu), c (M,nx), C (M,16,nx), D (M,16,nu), e (M,16),
// exactly what riccati.cu reads, with no transpose in between.
//
// Bound: bytes.  An instance reads 79 values and writes 1,710; its arithmetic
// (two centroidal passes, the derivative columns, the short output sums) is
// a few tens of thousands of flops, less time at the card's flop rate than
// the stores take at its memory rate.  This first version synchronises the
// block 12 times (rk2; 7 for euler) and leaves FK, inv6 and the flow value
// serial in one lane.
#include <cuda_runtime.h>

#include "centroidal_circuit.cuh"

namespace {

using namespace circuit;

constexpr int kGroup = kNV;       // threads per instance
constexpr int kInstPerBlock = 8;  // instances per block
constexpr int kNF = 3 * kNC;      // force inputs
constexpr int kNE = 4 * kNC;      // equality rows: 3 per contact, then 1 normal-velocity row per contact

template <typename T>
struct Inst {
  T x[kNX], u[kNU], xn[kNX], flags[kNC], vref[kNC], pref[kNC], dt;
  T x1[kNX];        // RK2 midpoint
  Pass<T> s;        // centroidal evaluation (at x, then at x1)
  T Pq[3][kNV];     // Jx rows 3:6, q columns
  T Nq[6][kNV];     // Jx rows 6:12, q columns
  T GJ[6][kNJ];     // d v_b / d v_j = -Ab^{-1} A_j
  T Jee[kNF][kNV];  // contact Jacobians, row 3i + c
  T dzv[kNF][kNV];  // d v_ee / dq (+ gain dp_z/dq on z rows), row 3i + c
};

template <typename T>
__host__ __device__ constexpr size_t param_bytes() {
  return (P_SIZE * sizeof(T) + 15) / 16 * 16;
}

// ---------------------------------------------------------------- outputs
// (m Ab^{-1})[r][c]: Jx rows 6:12, h columns
template <typename T>
__device__ __forceinline__ T mh(const T* __restrict__ P, const Inst<T>& I, int r, int c) {
  return P[P_ROBOT_MASS] * I.s.Abi[6 * r + c];
}

// skew(p_i - com)[a][b]
template <typename T>
__device__ __forceinline__ T skew_rel(const Inst<T>& I, int i, int a, int b) {
  if (a == b) return T(0);
  const int k = 3 - a - b;  // the component that is not a or b
  const T rk = I.s.pee[i][k] - I.s.com[k];
  return ((a + 1) % 3 == b) ? -rk : rk;
}

template <typename T>
__device__ T a_elem(const T* __restrict__ P, const Inst<T>& I, int r, int c, T h) {
  T val = (r == c) ? T(1) : T(0);
  T acc = T(0);
  if (r >= 3 && r < 6) {
    const int ri = r - 3;
    if (c < 6) {
#pragma unroll
      for (int q = 0; q < 6; ++q) acc += I.Pq[ri][q] * mh(P, I, q, c);
      val += h * acc;
    } else {
      const int l = c - 6;
#pragma unroll
      for (int q = 0; q < 6; ++q) acc += I.Pq[ri][q] * I.Nq[q][l];
      val += I.dt * I.Pq[ri][l] + h * acc;
    }
  } else if (r >= 6 && r < 12) {
    const int ri = r - 6;
    if (c < 6) {
#pragma unroll
      for (int q = 0; q < 6; ++q) acc += I.Nq[ri][q] * mh(P, I, q, c);
      val += I.dt * mh(P, I, ri, c) + h * acc;
    } else {
      const int l = c - 6;
#pragma unroll
      for (int j = 0; j < 3; ++j) acc += mh(P, I, ri, 3 + j) * I.Pq[j][l];
#pragma unroll
      for (int q = 0; q < 6; ++q) acc += I.Nq[ri][q] * I.Nq[q][l];
      val += I.dt * I.Nq[ri][l] + h * acc;
    }
  }
  return val;
}

template <typename T>
__device__ T b_elem(const T* __restrict__ P, const Inst<T>& I, int r, int c, T h) {
  const T dt = I.dt, m = P[P_ROBOT_MASS];
  if (r < 3) return (c < kNF && c % 3 == r) ? dt / m : T(0);
  if (r >= 12) return (c == r) ? dt : T(0);
  if (c < kNF) {
    const int i = c / 3, cc = c % 3;
    if (r < 6) return dt * skew_rel(I, i, r - 3, cc) / m;
    const int ri = r - 6;
    T ent = mh(P, I, ri, cc) / m;
#pragma unroll
    for (int t = 0; t < 3; ++t) ent += mh(P, I, ri, 3 + t) * skew_rel(I, i, t, cc) / m;
    return h * ent;
  }
  const int jj = c - kNF;
  T acc = T(0);
  if (r < 6) {
    const int ri = r - 3;
#pragma unroll
    for (int q = 0; q < 6; ++q) acc += I.Pq[ri][q] * I.GJ[q][jj];
    return h * (acc + I.Pq[ri][6 + jj]);
  }
  const int ri = r - 6;
#pragma unroll
  for (int q = 0; q < 6; ++q) acc += I.Nq[ri][q] * I.GJ[q][jj];
  return dt * I.GJ[ri][jj] + h * (acc + I.Nq[ri][6 + jj]);
}

// d v_ee / d v_j of Jacobian row `row` = J6 (-Ab^{-1} A_j) + J_ee[:, 6 + jj]
template <typename T>
__device__ __forceinline__ T dvee_dvj(const Inst<T>& I, int row, int jj) {
  T acc = I.Jee[row][6 + jj];
#pragma unroll
  for (int q = 0; q < 6; ++q) acc += I.Jee[row][q] * I.GJ[q][jj];
  return acc;
}

template <typename T>
__device__ T c_elem(const T* __restrict__ P, const Inst<T>& I, int r, int c) {
  const int row = r < kNF ? r : 3 * (r - kNF) + 2;
  const T wgt = r < kNF ? I.flags[r / 3] : T(1) - I.flags[r - kNF];
  if (c >= 6) return wgt * I.dzv[row][c - 6];
  T acc = T(0);
#pragma unroll
  for (int t = 0; t < 6; ++t) acc += I.Jee[row][t] * mh(P, I, t, c);
  return wgt * acc;
}

template <typename T>
__device__ T d_elem(const Inst<T>& I, int r, int c) {
  if (r < kNF) {
    const T fi = I.flags[r / 3];
    if (c < kNF) return c == r ? T(1) - fi : T(0);
    return fi * dvee_dvj(I, r, c - kNF);
  }
  const int i = r - kNF;
  if (c < kNF) return T(0);
  return (T(1) - I.flags[i]) * dvee_dvj(I, 3 * i + 2, c - kNF);
}

template <typename T>
__device__ T e_elem(const Inst<T>& I, int r, T gain) {
  const int i = r < kNF ? r / 3 : r - kNF;
  const int row = r < kNF ? r : 3 * i + 2;
  T vee = T(0);
#pragma unroll
  for (int l = 0; l < kNV; ++l) vee += I.Jee[row][l] * I.s.v[l];
  const T fi = I.flags[i];
  if (r < kNF) {
    if (r % 3 == 2) vee += gain * I.s.pee[i][2];
    return fi * vee + (T(1) - fi) * I.u[r];
  }
  return (T(1) - fi) * (vee - I.vref[i] + gain * (I.s.pee[i][2] - I.pref[i]));
}

// block-wide copies between device memory (S values per instance, instances
// contiguous) and the block's instances; the last instance stands in for
// the missing ones of a ragged final block, whose outputs are not stored
template <int S, typename T, typename F>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int base, int M, F put) {
  for (int idx = threadIdx.x; idx < kInstPerBlock * S; idx += blockDim.x) {
    const int g = idx / S, k = idx - g * S;
    const int inst = min(base + g, M - 1);
    put(g, k, src[(size_t)inst * S + k]);
  }
}

template <int S, typename T, typename F>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int base, int M, F elem) {
  for (int idx = threadIdx.x; idx < kInstPerBlock * S; idx += blockDim.x) {
    const int g = idx / S, k = idx - g * S;
    if (base + g < M) dst[(size_t)base * S + idx] = elem(g, k);
  }
}

template <typename T>
__global__ void __launch_bounds__(kGroup * kInstPerBlock)
    linearize_kernel(const T* __restrict__ params, const T* __restrict__ xs, const T* __restrict__ us,
                     const T* __restrict__ xns, const T* __restrict__ flags, const T* __restrict__ vref,
                     const T* __restrict__ pref, const T* __restrict__ dts, T* __restrict__ Aout,
                     T* __restrict__ Bout, T* __restrict__ cdef, T* __restrict__ Cout, T* __restrict__ Dout,
                     T* __restrict__ eout, int M, T gain, int rk2) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  T* P = reinterpret_cast<T*>(k1_smem);
  Inst<T>* insts = reinterpret_cast<Inst<T>*>(k1_smem + param_bytes<T>());
  const int g = threadIdx.x / kGroup, lane = threadIdx.x - g * kGroup;
  const int base = blockIdx.x * kInstPerBlock;
  Inst<T>& I = insts[g];

  for (int i = threadIdx.x; i < P_SIZE; i += blockDim.x) P[i] = params[i];
  load_rows<kNX>(xs, base, M, [&](int gg, int k, T v) { insts[gg].x[k] = v; });
  load_rows<kNU>(us, base, M, [&](int gg, int k, T v) { insts[gg].u[k] = v; });
  load_rows<kNX>(xns, base, M, [&](int gg, int k, T v) { insts[gg].xn[k] = v; });
  load_rows<kNC>(flags, base, M, [&](int gg, int k, T v) { insts[gg].flags[k] = v; });
  load_rows<kNC>(vref, base, M, [&](int gg, int k, T v) { insts[gg].vref[k] = v; });
  load_rows<kNC>(pref, base, M, [&](int gg, int k, T v) { insts[gg].pref[k] = v; });
  load_rows<1>(dts, base, M, [&](int gg, int, T v) { insts[gg].dt = v; });
  __syncthreads();

  centroidal_pass(P, I.x, I.u, I.s, lane);

  // derivative columns: lane l owns q-column l
  {
    const T m = P[P_ROBOT_MASS];
    T J[kNC][3], dA[6], dJ[kNC][3], Nq[6];
    contact_jacobian_column(P, I.s, lane, J);
    cmm_v_derivative_column(P, I.s, lane, J, dA, dJ);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < 6; ++q) acc += I.s.Abi[6 * r + q] * dA[q];
      Nq[r] = -acc;
      I.Nq[r][lane] = Nq[r];
    }
    if (lane >= 6) {
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += I.s.Abi[6 * r + q] * I.s.A[q][lane];
        I.GJ[r][lane - 6] = -acc;
      }
    }
    // Pq = sum_i (J_i - dcom) x F_i / m
    const T total_mass = P[P_TOTAL_MASS];
    const T dcom[3] = {I.s.A[0][lane] / total_mass, I.s.A[1][lane] / total_mass, I.s.A[2][lane] / total_mass};
    T cr[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int i = 0; i < kNC; ++i) {
      const T drel[3] = {J[i][0] - dcom[0], J[i][1] - dcom[1], J[i][2] - dcom[2]};
      T t[3];
      cross3(drel, I.u + 3 * i, t);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cr[c] += t[c];
        I.Jee[3 * i + c][lane] = J[i][c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) I.Pq[c][lane] = cr[c] / m;
    __syncthreads();
    // d v_ee / dq = dJ_v + J6 Nq (+ gain dp_z/dq on the z rows)
#pragma unroll
    for (int i = 0; i < kNC; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T acc = dJ[i][c];
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += I.Jee[3 * i + c][q] * Nq[q];
        if (c == 2) acc += gain * J[i][2];
        I.dzv[3 * i + c][lane] = acc;
      }
  }
  __syncthreads();

  auto hof = [&](int gg) { return rk2 ? T(0.5) * insts[gg].dt * insts[gg].dt : T(0); };
  store_rows<kNX * kNX>(Aout, base, M,
                        [&](int gg, int k) { return a_elem(P, insts[gg], k / kNX, k % kNX, hof(gg)); });
  store_rows<kNX * kNU>(Bout, base, M,
                        [&](int gg, int k) { return b_elem(P, insts[gg], k / kNU, k % kNU, hof(gg)); });
  store_rows<kNE * kNX>(Cout, base, M, [&](int gg, int k) { return c_elem(P, insts[gg], k / kNX, k % kNX); });
  store_rows<kNE * kNU>(Dout, base, M, [&](int gg, int k) { return d_elem(insts[gg], k / kNU, k % kNU); });
  store_rows<kNE>(eout, base, M, [&](int gg, int k) { return e_elem(insts[gg], k, gain); });

  if (rk2) {
    for (int i = lane; i < kNX; i += kGroup) I.x1[i] = I.x[i] + T(0.5) * I.dt * I.s.f[i];
    __syncthreads();
    centroidal_pass(P, I.x1, I.u, I.s, lane);
  }
  store_rows<kNX>(cdef, base, M, [&](int gg, int k) {
    const Inst<T>& in = insts[gg];
    return in.x[k] + in.dt * in.s.f[k] - in.xn[k];
  });
}

template <typename T>
int launch(const void* params, const void* xs, const void* us, const void* xns, const void* flags,
           const void* vref, const void* pref, const void* dts, void* A, void* B, void* c, void* C, void* D,
           void* e, int M, double gain, int rk2, void* stream) {
  if (M <= 0) return 0;
  const size_t smem = param_bytes<T>() + kInstPerBlock * sizeof(Inst<T>);
  cudaError_t err =
      cudaFuncSetAttribute(linearize_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + kInstPerBlock - 1) / kInstPerBlock;
  linearize_kernel<T><<<blocks, kGroup * kInstPerBlock, smem, (cudaStream_t)stream>>>(
      (const T*)params, (const T*)xs, (const T*)us, (const T*)xns, (const T*)flags, (const T*)vref,
      (const T*)pref, (const T*)dts, (T*)A, (T*)B, (T*)c, (T*)C, (T*)D, (T*)e, M, (T)gain, rk2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int linearize_param_size() { return P_SIZE; }
extern "C" int linearize_state_dim() { return kNX; }
extern "C" int linearize_input_dim() { return kNU; }

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
