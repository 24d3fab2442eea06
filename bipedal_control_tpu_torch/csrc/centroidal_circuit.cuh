// Per-instance centroidal model circuit: forward kinematics, velocity fields,
// centroidal momentum matrix by subtree aggregates, the closed-form 6x6
// momentum-block inverse, the generalized velocity, contact positions and
// Jacobian-velocity products, and the centroidal flow value.
//
// These __device__ functions follow the TPU lane circuits of
// bipedal_control_tpu/ops/pallas_linearize.py (fk_lanes, fields_lanes,
// cmm_lanes, inv6_scalars, generalized_velocity_lanes,
// contact_jacobians_lanes) and ops/pallas_merit.py (flow_lanes,
// node_eval_lanes).  There the scenario x node instances sat on the vector
// lanes and every per-instance loop was unrolled at trace time with the
// robot's constants baked in.  Here one CUDA thread evaluates one instance;
// the model's topology is compiled in (NJ, PARENT_LIST, JTYPE_LIST,
// CONTACT_BODY_LIST), so the loops over joints and bodies unroll with static
// indices, and the numeric constants come from a small parameter buffer that
// the kernel stages into shared memory.
//
// Parameter buffer layout (type T; ops/merit_kernel.py packs it):
//   off_R (NJ,3,3) | off_p (NJ,3) | axis (NJ,3) | mass (NB) | com (NB,3)
//   | inertia (NB,3,3) | contact_p (NC,3) | msub (NV) | move (NB,NV)
//   | total_mass | robot_mass
#pragma once

#ifndef NJ
#error "NJ (number of moving joints) must be defined"
#endif

namespace circuit {

constexpr int kNJ = NJ;
constexpr int kNB = NJ + 1;
constexpr int kNV = NJ + 6;
constexpr int kNC = 4;
constexpr int kNX = 12 + NJ;
constexpr int kNU = 3 * kNC + NJ;

constexpr int P_OFF_R = 0;
constexpr int P_OFF_P = P_OFF_R + 9 * kNJ;
constexpr int P_AXIS = P_OFF_P + 3 * kNJ;
constexpr int P_MASS = P_AXIS + 3 * kNJ;
constexpr int P_COM = P_MASS + kNB;
constexpr int P_INERTIA = P_COM + 3 * kNB;
constexpr int P_CONTACT_P = P_INERTIA + 9 * kNB;
constexpr int P_MSUB = P_CONTACT_P + 3 * kNC;
constexpr int P_MOVE = P_MSUB + kNV;
constexpr int P_TOTAL_MASS = P_MOVE + kNB * kNV;
constexpr int P_ROBOT_MASS = P_TOTAL_MASS + 1;
constexpr int P_SIZE = P_ROBOT_MASS + 1;

__device__ __forceinline__ int parent_of(int j) {
  constexpr int p[kNJ] = {PARENT_LIST};
  return p[j];
}
__device__ __forceinline__ bool revolute(int j) {
  constexpr int t[kNJ] = {JTYPE_LIST};
  return t[j] == 0;
}
__device__ __forceinline__ int contact_body(int i) {
  constexpr int cb[kNC] = {CONTACT_BODY_LIST};
  return cb[i];
}

template <typename T>
struct Kin {
  T R[kNB][9];  // world rotation of each body, row-major
  T p[kNB][3];  // world position of each body origin
  T E[9];       // Euler-rate map: omega_world = E theta_dot
};

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// q = [p_base(3), theta zyx(3), q_j(NJ)]  (model/kinematics.py forward_kinematics)
template <typename T>
__device__ void fk(const T* __restrict__ P, const T* q, Kin<T>& k) {
  const T cz = cos(q[3]), sz = sin(q[3]);
  const T cy = cos(q[4]), sy = sin(q[4]);
  const T cx = cos(q[5]), sx = sin(q[5]);
  T* R0 = k.R[0];
  R0[0] = cz * cy; R0[1] = cz * sy * sx - sz * cx; R0[2] = cz * sy * cx + sz * sx;
  R0[3] = sz * cy; R0[4] = sz * sy * sx + cz * cx; R0[5] = sz * sy * cx - cz * sx;
  R0[6] = -sy;     R0[7] = cy * sx;                R0[8] = cy * cx;
  k.E[0] = T(0); k.E[1] = -sz;  k.E[2] = cy * cz;
  k.E[3] = T(0); k.E[4] = cz;   k.E[5] = cy * sz;
  k.E[6] = T(1); k.E[7] = T(0); k.E[8] = -sy;
  k.p[0][0] = q[0]; k.p[0][1] = q[1]; k.p[0][2] = q[2];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int par = parent_of(j);
    const T* Rp = k.R[par];
    const T* pp = k.p[par];
    const T* oR = P + P_OFF_R + 9 * j;
    const T* op = P + P_OFF_P + 3 * j;
    const T* a = P + P_AXIS + 3 * j;
    T Rj[9], pj[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        Rj[3 * r + c] = Rp[3 * r] * oR[c] + Rp[3 * r + 1] * oR[3 + c] + Rp[3 * r + 2] * oR[6 + c];
      pj[r] = pp[r] + (Rp[3 * r] * op[0] + Rp[3 * r + 1] * op[1] + Rp[3 * r + 2] * op[2]);
    }
    const T qj = q[6 + j];
    if (revolute(j)) {
      const T c = cos(qj), s = sin(qj);
      const T K[9] = {T(0), -a[2], a[1], a[2], T(0), -a[0], -a[1], a[0], T(0)};
      T Rm[9];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          const T kk = K[3 * r] * K[cc] + K[3 * r + 1] * K[3 + cc] + K[3 * r + 2] * K[6 + cc];
          Rm[3 * r + cc] = (r == cc ? T(1) : T(0)) + s * K[3 * r + cc] + (T(1) - c) * kk;
        }
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          k.R[j + 1][3 * r + cc] =
              Rj[3 * r] * Rm[cc] + Rj[3 * r + 1] * Rm[3 + cc] + Rj[3 * r + 2] * Rm[6 + cc];
        k.p[j + 1][r] = pj[r];
      }
    } else {
      const T d[3] = {a[0] * qj, a[1] * qj, a[2] * qj};
#pragma unroll
      for (int q = 0; q < 9; ++q) k.R[j + 1][q] = Rj[q];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        k.p[j + 1][r] = pj[r] + (Rj[3 * r] * d[0] + Rj[3 * r + 1] * d[1] + Rj[3 * r + 2] * d[2]);
    }
  }
}

// velocity field w_l, v0_l of coordinate l (model/second_order.py velocity_fields)
template <typename T>
__device__ __forceinline__ void field_column(const T* __restrict__ P, const Kin<T>& k, int l, T* w, T* v0) {
  if (l < 3) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      w[d] = T(0);
      v0[d] = (l == d) ? T(1) : T(0);
    }
  } else if (l < 6) {
    const int i = l - 3;
    const T e[3] = {k.E[i], k.E[3 + i], k.E[6 + i]};
    T wxp[3];
    cross3(e, k.p[0], wxp);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      w[d] = e[d];
      v0[d] = -wxp[d];
    }
  } else {
    const int j = l - 6;
    const T* Rb = k.R[j + 1];
    const T* ax = P + P_AXIS + 3 * j;
    T a[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) a[r] = Rb[3 * r] * ax[0] + Rb[3 * r + 1] * ax[1] + Rb[3 * r + 2] * ax[2];
    if (revolute(j)) {
      T axp[3];
      cross3(a, k.p[j + 1], axp);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        w[d] = a[d];
        v0[d] = -axp[d];
      }
    } else {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        w[d] = T(0);
        v0[d] = a[d];
      }
    }
  }
}

// all velocity fields, one thread
template <typename T>
__device__ void fields(const T* __restrict__ P, const Kin<T>& k, T W[kNV][3], T V0[kNV][3]) {
#pragma unroll
  for (int l = 0; l < kNV; ++l) field_column(P, k, l, W[l], V0[l]);
}

// 3x3 inverse via the adjugate (ops/linalg.py inv3)
template <typename T>
__device__ __forceinline__ void inv3(const T* M, T* out) {
  const T a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5], g = M[6], h = M[7], i = M[8];
  const T c00 = e * i - f * h, c01 = c * h - b * i, c02 = b * f - c * e;
  const T c10 = f * g - d * i, c11 = a * i - c * g, c12 = c * d - a * f;
  const T c20 = d * h - e * g, c21 = b * g - a * h, c22 = a * e - b * d;
  const T det = a * c00 + b * c10 + c * c20;
  out[0] = c00 / det; out[1] = c01 / det; out[2] = c02 / det;
  out[3] = c10 / det; out[4] = c11 / det; out[5] = c12 / det;
  out[6] = c20 / det; out[7] = c21 / det; out[8] = c22 / det;
}

template <typename T>
__device__ __forceinline__ void mul3(const T* A, const T* B, T* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[3 * r + c] = A[3 * r] * B[c] + A[3 * r + 1] * B[3 + c] + A[3 * r + 2] * B[6 + c];
}

// 6x6 block-Schur inverse, row-major (ops/linalg.py inv6_block)
template <typename T>
__device__ void inv6(const T* M, T* out) {
  T A11[9], A12[9], A21[9], A22[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      A11[3 * r + c] = M[6 * r + c];
      A12[3 * r + c] = M[6 * r + c + 3];
      A21[3 * r + c] = M[6 * (r + 3) + c];
      A22[3 * r + c] = M[6 * (r + 3) + c + 3];
    }
  T A11i[9], A11iA12[9], t[9], S[9], Si[9], A21A11i[9], TR[9], BL[9];
  inv3(A11, A11i);
  mul3(A11i, A12, A11iA12);
  mul3(A21, A11iA12, t);
#pragma unroll
  for (int q = 0; q < 9; ++q) S[q] = A22[q] - t[q];
  inv3(S, Si);
  mul3(A21, A11i, A21A11i);
  mul3(A11iA12, Si, TR);
  mul3(Si, A21A11i, BL);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    TR[q] = -TR[q];
    BL[q] = -BL[q];
  }
  mul3(TR, A21A11i, t);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[6 * r + c] = A11i[3 * r + c] - t[3 * r + c];
      out[6 * r + c + 3] = TR[3 * r + c];
      out[6 * (r + 3) + c] = BL[3 * r + c];
      out[6 * (r + 3) + c + 3] = Si[3 * r + c];
    }
}

// Centroidal flow value f(x, u) (ocp/linearize.py _flow_from_terms), with the
// pass's velocity fields, contact positions and generalized velocity.
template <typename T>
__device__ void flow(const T* __restrict__ P, const T* x, const T* u, T* f, T W[kNV][3], T V0[kNV][3],
                     T pee[kNC][3], T v[kNV]) {
  Kin<T> k;
  fk(P, x + 6, k);
  fields(P, k, W, V0);
  const T total_mass = P[P_TOTAL_MASS];
  const T m = P[P_ROBOT_MASS];

  // body coms, total com, and per-body leaves of the subtree aggregates
  T cs[kNB][3], qs[kNB], cc[kNB][6], Ir[kNB][9];
  T com[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int b = 0; b < kNB; ++b) {
    const T* Rb = k.R[b];
    const T* cb = P + P_COM + 3 * b;
    const T mb = P[P_MASS + b];
    T c[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) c[r] = k.p[b][r] + (Rb[3 * r] * cb[0] + Rb[3 * r + 1] * cb[1] + Rb[3 * r + 2] * cb[2]);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      com[r] += mb * c[r];
      cs[b][r] = mb * c[r];
    }
    qs[b] = mb * (c[0] * c[0] + c[1] * c[1] + c[2] * c[2]);
    cc[b][0] = mb * c[0] * c[0]; cc[b][1] = mb * c[0] * c[1]; cc[b][2] = mb * c[0] * c[2];
    cc[b][3] = mb * c[1] * c[1]; cc[b][4] = mb * c[1] * c[2]; cc[b][5] = mb * c[2] * c[2];
    // world inertia R I R^T
    const T* Ib = P + P_INERTIA + 9 * b;
    T RI[9];
    mul3(Rb, Ib, RI);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int l = 0; l < 3; ++l)
        Ir[b][3 * r + l] = RI[3 * r] * Rb[3 * l] + RI[3 * r + 1] * Rb[3 * l + 1] + RI[3 * r + 2] * Rb[3 * l + 2];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) com[r] /= total_mass;
  // subtree sums bottom-up (bodies are in topological order)
#pragma unroll
  for (int b = kNB - 1; b >= 1; --b) {
    const int par = parent_of(b - 1);
#pragma unroll
    for (int r = 0; r < 3; ++r) cs[par][r] += cs[b][r];
    qs[par] += qs[b];
#pragma unroll
    for (int r = 0; r < 6; ++r) cc[par][r] += cc[b][r];
#pragma unroll
    for (int r = 0; r < 9; ++r) Ir[par][r] += Ir[b][r];
  }

  // CMM columns: A_lin = msub v0 + w x csub;
  // A_ang = Isub_rot w + ssub x v0 + w alpha - CC w + csub (com . w)
  T Ab[36];
  T Ajv[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int l = 0; l < kNV; ++l) {
    const int src = l < 6 ? 0 : l - 5;
    const T* csub = cs[src];
    const T msub = P[P_MSUB + l];
    const T* w = W[l];
    const T* v0 = V0[l];
    T wxc[3], ssub[3], sxv[3], Alin[3], Aang[3];
    cross3(w, csub, wxc);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      Alin[r] = msub * v0[r] + wxc[r];
      ssub[r] = csub[r] - msub * com[r];
    }
    cross3(ssub, v0, sxv);
    const T alpha = qs[src] - (com[0] * csub[0] + com[1] * csub[1] + com[2] * csub[2]);
    const T comw = com[0] * w[0] + com[1] * w[1] + com[2] * w[2];
    const T* C6 = cc[src];
    const T CCw[3] = {C6[0] * w[0] + C6[1] * w[1] + C6[2] * w[2], C6[1] * w[0] + C6[3] * w[1] + C6[4] * w[2],
                      C6[2] * w[0] + C6[4] * w[1] + C6[5] * w[2]};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T Iw = l < 3 ? T(0) : Ir[src][3 * r] * w[0] + Ir[src][3 * r + 1] * w[1] + Ir[src][3 * r + 2] * w[2];
      Aang[r] = Iw + sxv[r] + w[r] * alpha - CCw[r] + csub[r] * comw;
    }
    if (l < 6) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        Ab[6 * r + l] = Alin[r];
        Ab[6 * (r + 3) + l] = Aang[r];
      }
    } else {
      const T vj = u[3 * kNC + (l - 6)];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        Ajv[r] += Alin[r] * vj;
        Ajv[r + 3] += Aang[r] * vj;
      }
    }
  }

  // v_b = A_b^{-1} (m h/m - A_j v_j)
  T Abi[36];
  inv6(Ab, Abi);
  T rhs[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) rhs[r] = m * x[r] - Ajv[r];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    T acc = T(0);
#pragma unroll
    for (int s = 0; s < 6; ++s) acc += Abi[6 * r + s] * rhs[s];
    v[r] = acc;
  }
#pragma unroll
  for (int j = 0; j < kNJ; ++j) v[6 + j] = u[3 * kNC + j];

  // contact positions and momentum rate
  T fsum[3] = {T(0), T(0), T(0)}, ang[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    const int b = contact_body(i);
    const T* Rb = k.R[b];
    const T* cp = P + P_CONTACT_P + 3 * i;
#pragma unroll
    for (int r = 0; r < 3; ++r) pee[i][r] = k.p[b][r] + (Rb[3 * r] * cp[0] + Rb[3 * r + 1] * cp[1] + Rb[3 * r + 2] * cp[2]);
    const T* Fi = u + 3 * i;
    const T rel[3] = {pee[i][0] - com[0], pee[i][1] - com[1], pee[i][2] - com[2]};
    T t[3];
    cross3(rel, Fi, t);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      fsum[r] += Fi[r];
      ang[r] += t[r];
    }
  }
  f[0] = fsum[0] / m;
  f[1] = fsum[1] / m;
  f[2] = fsum[2] / m + T(-9.81);
#pragma unroll
  for (int r = 0; r < 3; ++r) f[3 + r] = ang[r] / m;
#pragma unroll
  for (int r = 0; r < 6; ++r) f[6 + r] = v[r];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) f[12 + j] = u[3 * kNC + j];
}

// Contact-point velocity J_ee v of contact i from a pass's fields
// (contact_jacobians_lanes: column l = move(b, l) (v0_l + w_l x p_ee)).
template <typename T>
__device__ __forceinline__ void contact_velocity(const T* __restrict__ P, int i, const T W[kNV][3],
                                                 const T V0[kNV][3], const T* pee, const T* v, T* vee) {
  const int b = contact_body(i);
  vee[0] = vee[1] = vee[2] = T(0);
#pragma unroll
  for (int l = 0; l < kNV; ++l) {
    const T mv = P[P_MOVE + b * kNV + l];
    T wxp[3];
    cross3(W[l], pee, wxp);
#pragma unroll
    for (int c = 0; c < 3; ++c) vee[c] += mv * (V0[l][c] + wxp[c]) * v[l];
  }
}

// ---------------------------------------------------------------------------
// Group-parallel form: a group of kNV threads evaluates one instance, lane l
// owning coordinate column l of every (nv)-column stack.  What the whole
// instance shares (FK, body coms and inertias, the CMM, its inverse base
// block, v, contact positions, the flow value) lives in shared memory.

// One centroidal evaluation of an instance, resident in shared memory.
template <typename T>
struct Pass {
  Kin<T> k;
  T W[kNV][3], V0[kNV][3];  // velocity fields
  T cb[kNB][3];             // body coms (world)
  T Ib[kNB][9];             // body inertias (world)
  T com[3];
  T A[6][kNV];              // centroidal momentum matrix
  T Abi[36];                // inverse of its base block, row-major
  T v[kNV];                 // generalized velocity
  T pee[kNC][3];            // contact positions
  T f[kNX];                 // flow value
};

template <typename T>
__device__ __forceinline__ bool moves(const T* __restrict__ P, int b, int l) {
  return P[P_MOVE + b * kNV + l] != T(0);
}

// CMM column l from per-body coms and inertias, summed over the bodies that
// coordinate l moves (its subtree); cmm_lanes' A_lin / A_ang rows.
template <typename T>
__device__ void cmm_column(const T* __restrict__ P, Pass<T>& s, int l) {
  T com[3] = {T(0), T(0), T(0)}, csub[3] = {T(0), T(0), T(0)}, qsub = T(0);
  T cc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)}, Isub[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) Isub[q] = T(0);
#pragma unroll
  for (int b = 0; b < kNB; ++b) {
    const T mb = P[P_MASS + b];
    const T* c = s.cb[b];
#pragma unroll
    for (int r = 0; r < 3; ++r) com[r] += mb * c[r];
    if (moves(P, b, l)) {
#pragma unroll
      for (int r = 0; r < 3; ++r) csub[r] += mb * c[r];
      qsub += mb * (c[0] * c[0] + c[1] * c[1] + c[2] * c[2]);
      cc[0] += mb * c[0] * c[0]; cc[1] += mb * c[0] * c[1]; cc[2] += mb * c[0] * c[2];
      cc[3] += mb * c[1] * c[1]; cc[4] += mb * c[1] * c[2]; cc[5] += mb * c[2] * c[2];
#pragma unroll
      for (int q = 0; q < 9; ++q) Isub[q] += s.Ib[b][q];
    }
  }
  const T total_mass = P[P_TOTAL_MASS];
#pragma unroll
  for (int r = 0; r < 3; ++r) com[r] /= total_mass;
  if (l == 0) {
#pragma unroll
    for (int r = 0; r < 3; ++r) s.com[r] = com[r];
  }
  const T msub = P[P_MSUB + l];
  const T* w = s.W[l];
  const T* v0 = s.V0[l];
  T wxc[3], ssub[3], sxv[3];
  cross3(w, csub, wxc);
#pragma unroll
  for (int r = 0; r < 3; ++r) ssub[r] = csub[r] - msub * com[r];
  cross3(ssub, v0, sxv);
  const T alpha = qsub - (com[0] * csub[0] + com[1] * csub[1] + com[2] * csub[2]);
  const T comw = com[0] * w[0] + com[1] * w[1] + com[2] * w[2];
  const T CCw[3] = {cc[0] * w[0] + cc[1] * w[1] + cc[2] * w[2], cc[1] * w[0] + cc[3] * w[1] + cc[4] * w[2],
                    cc[2] * w[0] + cc[4] * w[1] + cc[5] * w[2]};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T Iw = l < 3 ? T(0) : Isub[3 * r] * w[0] + Isub[3 * r + 1] * w[1] + Isub[3 * r + 2] * w[2];
    s.A[r][l] = msub * v0[r] + wxc[r];
    s.A[3 + r][l] = Iw + sxv[r] + w[r] * alpha - CCw[r] + csub[r] * comw;
  }
}

// One thread: Ab^{-1}, v = [Ab^{-1}(m h - A_j v_j); v_j] and the flow value.
template <typename T>
__device__ void flow_from_cmm(const T* __restrict__ P, const T* x, const T* u, Pass<T>& s) {
  const T m = P[P_ROBOT_MASS];
  T Ab[36];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int c = 0; c < 6; ++c) Ab[6 * r + c] = s.A[r][c];
  inv6(Ab, s.Abi);
  T rhs[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    T ajv = T(0);
#pragma unroll
    for (int j = 0; j < kNJ; ++j) ajv += s.A[r][6 + j] * u[3 * kNC + j];
    rhs[r] = m * x[r] - ajv;
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < 6; ++q) acc += s.Abi[6 * r + q] * rhs[q];
    s.v[r] = acc;
    s.f[6 + r] = acc;
  }
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    s.v[6 + j] = u[3 * kNC + j];
    s.f[12 + j] = u[3 * kNC + j];
  }
  T fsum[3] = {T(0), T(0), T(0)}, ang[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    const T* Fi = u + 3 * i;
    const T rel[3] = {s.pee[i][0] - s.com[0], s.pee[i][1] - s.com[1], s.pee[i][2] - s.com[2]};
    T t[3];
    cross3(rel, Fi, t);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      fsum[r] += Fi[r];
      ang[r] += t[r];
    }
  }
  s.f[0] = fsum[0] / m;
  s.f[1] = fsum[1] / m;
  s.f[2] = fsum[2] / m + T(-9.81);
#pragma unroll
  for (int r = 0; r < 3; ++r) s.f[3 + r] = ang[r] / m;
}

// The centroidal evaluation at state x (flow()'s circuit, group-parallel).
// Every thread of the block calls it (it synchronises the block); lane is
// the thread's index in its instance's group, 0 <= lane < kNV.
template <typename T>
__device__ void centroidal_pass(const T* __restrict__ P, const T* x, const T* u, Pass<T>& s, int lane) {
  if (lane == 0) fk(P, x + 6, s.k);
  __syncthreads();
  field_column(P, s.k, lane, s.W[lane], s.V0[lane]);
  if (lane < kNB) {
    const T* Rb = s.k.R[lane];
    const T* cbody = P + P_COM + 3 * lane;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      s.cb[lane][r] = s.k.p[lane][r] + (Rb[3 * r] * cbody[0] + Rb[3 * r + 1] * cbody[1] + Rb[3 * r + 2] * cbody[2]);
    T RI[9];
    mul3(Rb, P + P_INERTIA + 9 * lane, RI);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s.Ib[lane][3 * r + c] = RI[3 * r] * Rb[3 * c] + RI[3 * r + 1] * Rb[3 * c + 1] + RI[3 * r + 2] * Rb[3 * c + 2];
  }
  if (lane < kNC) {
    const int b = contact_body(lane);
    const T* Rb = s.k.R[b];
    const T* cp = P + P_CONTACT_P + 3 * lane;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      s.pee[lane][r] = s.k.p[b][r] + (Rb[3 * r] * cp[0] + Rb[3 * r + 1] * cp[1] + Rb[3 * r + 2] * cp[2]);
  }
  __syncthreads();
  cmm_column(P, s, lane);
  __syncthreads();
  if (lane == 0) flow_from_cmm(P, x, u, s);
  __syncthreads();
}

// Column l of every contact Jacobian, J_i[:, l] = move(b_i, l) (v0_l + w_l x p_i)
// (contact_jacobians_lanes).
template <typename T>
__device__ __forceinline__ void contact_jacobian_column(const T* __restrict__ P, const Pass<T>& s, int l,
                                                        T J[kNC][3]) {
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    const bool mv = moves(P, contact_body(i), l);
    T wxp[3];
    cross3(s.W[l], s.pee[i], wxp);
#pragma unroll
    for (int c = 0; c < 3; ++c) J[i][c] = mv ? s.V0[l][c] + wxp[c] : T(0);
  }
}

// Column l of the directional CMM derivative dA_v = d/dq (A(q) v) at fixed v,
// and of the contacts' dJ_v = d/dq (J_i v) (cmm_v_derivative_lanes and the
// dJ_v term of linearize_node_lanes).  The per-body aggregates walk the
// tree root to leaves: P_b = sum of v_k dv0_k, W_b = sum of v_k dw_k over
// the coordinates k that move body b (column l each), omega_b and the
// body-origin velocity v0a_b (instance-wide; every lane recomputes them).
template <typename T>
__device__ void cmm_v_derivative_column(const T* __restrict__ P, const Pass<T>& s, int l, const T J[kNC][3],
                                        T dA[6], T dJ[kNC][3]) {
  const T* w = s.W[l];
  const T* v0 = s.V0[l];
  const T* pb = s.k.p[0];
  const T total_mass = P[P_TOTAL_MASS];
  const T dcom[3] = {s.A[0][l] / total_mass, s.A[1][l] / total_mass, s.A[2][l] / total_mass};
  T Pb[kNB][3], Wb[kNB][3], om[kNB][3], v0a[kNB][3];
  T dp[3] = {T(0), T(0), T(0)}, dL[3] = {T(0), T(0), T(0)};

  // base (body 0): Euler coordinates k = 3 + i; dw_k[l] = w_l x w_k for the
  // Euler coordinates l before k, dp_base/dq_l = e_l for l < 3
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Pb[0][c] = Wb[0][c] = om[0][c] = T(0);
    v0a[0][c] = s.v[c];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T wk[3] = {s.k.E[i], s.k.E[3 + i], s.k.E[6 + i]};
    const T vk = s.v[3 + i];
    T dw[3] = {T(0), T(0), T(0)};
    if (l >= 3 && l < 3 + i) cross3(w, wk, dw);
    const T dpb[3] = {l == 0 ? T(1) : T(0), l == 1 ? T(1) : T(0), l == 2 ? T(1) : T(0)};
    T t1[3], t2[3];
    cross3(dw, pb, t1);
    cross3(wk, dpb, t2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Pb[0][c] -= vk * (t1[c] + t2[c]);
      Wb[0][c] += vk * dw[c];
      om[0][c] += vk * wk[c];
      v0a[0][c] += vk * s.V0[3 + i][c];
    }
  }
  // joints: body b = j + 1 hangs off body parent_of(j)
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int b = j + 1, par = parent_of(j);
    const T vk = s.v[6 + j];
    const bool rev = revolute(j);
    const T* a = rev ? s.W[6 + j] : s.V0[6 + j];  // world joint axis
    const T* anchor = s.k.p[b];
    const bool mv = moves(P, b, l);
    const bool rot = mv && l >= 3;
    T da[3], dan[3], t[3];
    cross3(w, a, t);
#pragma unroll
    for (int c = 0; c < 3; ++c) da[c] = rot ? t[c] : T(0);
    cross3(w, anchor, t);
#pragma unroll
    for (int c = 0; c < 3; ++c) dan[c] = mv ? v0[c] + t[c] : T(0);
    T dv0_row[3], v0_row[3];
    if (rev) {
      T t1[3], t2[3];
      cross3(da, anchor, t1);
      cross3(a, dan, t2);
      cross3(a, anchor, t);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dv0_row[c] = -(t1[c] + t2[c]);
        v0_row[c] = -t[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dv0_row[c] = da[c];
        v0_row[c] = a[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Pb[b][c] = Pb[par][c] + vk * dv0_row[c];
      Wb[b][c] = Wb[par][c] + (rev ? vk * da[c] : T(0));
      om[b][c] = om[par][c] + (rev ? vk * a[c] : T(0));
      v0a[b][c] = v0a[par][c] + vk * v0_row[c];
    }
  }
  // body-wise assembly of d(momentum)/dq_l
#pragma unroll
  for (int b = 0; b < kNB; ++b) {
    const T mb = P[P_MASS + b];
    const T* cb = s.cb[b];
    const T* Iw = s.Ib[b];
    const bool mv = moves(P, b, l);
    const bool rot = mv && l >= 3;
    T t[3], t2[3], cdot[3], Jv[3], dcdot[3];
    cross3(om[b], cb, t);
#pragma unroll
    for (int c = 0; c < 3; ++c) cdot[c] = v0a[b][c] + t[c];
    cross3(w, cb, t);
#pragma unroll
    for (int c = 0; c < 3; ++c) Jv[c] = mv ? v0[c] + t[c] : T(0);
    cross3(Wb[b], cb, t);
    cross3(om[b], Jv, t2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dcdot[c] = Pb[b][c] + t[c] + t2[c];
      dp[c] += mb * dcdot[c];
    }
    T Iom[3], wxom[3], IWb[3], Iwxom[3], wxIom[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      Iom[r] = Iw[3 * r] * om[b][0] + Iw[3 * r + 1] * om[b][1] + Iw[3 * r + 2] * om[b][2];
      IWb[r] = Iw[3 * r] * Wb[b][0] + Iw[3 * r + 1] * Wb[b][1] + Iw[3 * r + 2] * Wb[b][2];
    }
    cross3(w, om[b], wxom);
#pragma unroll
    for (int r = 0; r < 3; ++r) Iwxom[r] = Iw[3 * r] * wxom[0] + Iw[3 * r + 1] * wxom[1] + Iw[3 * r + 2] * wxom[2];
    cross3(w, Iom, wxIom);
    const T rel[3] = {cb[0] - s.com[0], cb[1] - s.com[1], cb[2] - s.com[2]};
    const T jm[3] = {Jv[0] - dcom[0], Jv[1] - dcom[1], Jv[2] - dcom[2]};
    cross3(jm, cdot, t);
    cross3(rel, dcdot, t2);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      dL[c] += (rot ? wxIom[c] - Iwxom[c] : T(0)) + IWb[c] + mb * (t[c] + t2[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dA[c] = dp[c];
    dA[3 + c] = dL[c];
  }
  // dJ_v of contact i on body b: P_b + W_b x p_i + omega_b x J_i
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    const int b = contact_body(i);
    T t[3], t2[3];
    cross3(Wb[b], s.pee[i], t);
    cross3(om[b], J[i], t2);
#pragma unroll
    for (int c = 0; c < 3; ++c) dJ[i][c] = Pb[b][c] + t[c] + t2[c];
  }
}

}  // namespace circuit
