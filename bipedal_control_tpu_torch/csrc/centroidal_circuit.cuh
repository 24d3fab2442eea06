// Per-instance centroidal model circuit, one warp-synchronous group of lanes
// per instance: forward kinematics, velocity fields, centroidal momentum
// matrix (CMM) by subtree sums, the block-Schur inverse of its 6x6 base
// block, the generalized velocity, contact positions, the centroidal flow
// value, and the per-column derivative pieces of the linearization.  The
// linearization (K1, linearize.cu) and the merit sums (K4, merit.cu) both
// run on it.
//
// These __device__ functions follow the TPU lane circuits of
// bipedal_control_tpu/ops/pallas_linearize.py (fk_lanes, fields_lanes,
// cmm_lanes, inv6_scalars, generalized_velocity_lanes,
// contact_jacobians_lanes, cmm_v_derivative_lanes) and ops/pallas_merit.py
// (flow_lanes, node_eval_lanes).  There the scenario x node instances sat on
// the 128 vector lanes and every per-instance loop was unrolled at trace
// time.  Here a group of kG lanes of one warp evaluates one instance (kG =
// GROUP, the next power of two >= kNV and at least 16: 16 for H1's 16
// coordinates, two instances per warp; 32 for g1's 18).  Lane l owns
// coordinate column l of every column stack; what the instance shares lives
// in shared memory (Pass, and a 16-byte aligned block of per-body leaves).
// Inside an instance the lanes meet only at __syncwarp and shuffles of
// width kG, so no instance waits for another.
//
// What bounds it on the H100: the latency of each instance's chain of
// dependent steps and the instructions issued for it; the bytes it moves
// are few.  So the work is spread over the lanes and kept short:
// - FK: lane j builds joint j's frame in its parent's (sincos of q_j,
//   Rodrigues, the fixed offset); the last lane builds the base's rotation
//   and Euler-rate map.  The world frames are then composed one tree level
//   at a time (LEVEL_ORDER, LEVEL_START from ops/static_model.py), three
//   lanes per joint, one row each: row r of a body's rotation needs only
//   row r of its parent's.  H1's legs are 5 levels deep.
// - fields, body coms and world inertias, contact positions: one lane per
//   column, body or contact.  Body lanes also write each body's leaves of
//   the subtree sums (m c, m |c|^2, m c c^T, world inertia), and lane l sums
//   the leaves of the bodies coordinate l moves (a bitmask in a register).
// - inv6, v and the flow value: seven steps of independent entries (3x3
//   adjugate entries, 3x3 product entries, the rows of Ab^-1 rhs, the
//   momentum rates), one entry per lane.
// - The topology is compiled in; an index known only at run time (a lane's
//   joint) picks from it by a chain of selects between constants.  An array
//   of constants indexed at run time was materialised in local memory and
//   read back with one predicated load per entry, the largest single cost
//   the redesign removed (PERF.md).
//
// The one-thread form (fk, fields, flow, contact_velocity: one thread
// walking a whole instance, ~1k live values) is gone: in the merit kernel it
// needed 255 registers and spilled 4.9 KB per thread in float32, and in the
// linearization lane 0 ran FK and inv6 while the other 15 lanes waited.
//
// Parameter buffer layout (type T; ops/static_model.py packs it):
//   off_R (NJ,3,3) | off_p (NJ,3) | axis (NJ,3) | mass (NB) | com (NB,3)
//   | inertia (NB,3,3) | contact_p (NC,3) | msub (NV) | move (NB,NV)
//   | total_mass | robot_mass
#pragma once

#if !defined(NJ) || !defined(GROUP) || !defined(NLEVELS)
#error "NJ, GROUP, NLEVELS (and PARENT_LIST, JTYPE_LIST, CONTACT_BODY_LIST, LEVEL_ORDER, LEVEL_START) must be defined"
#endif

namespace circuit {

constexpr int kNJ = NJ;
constexpr int kNB = NJ + 1;
constexpr int kNV = NJ + 6;
constexpr int kNC = 4;
constexpr int kNX = 12 + NJ;
constexpr int kNU = 3 * kNC + NJ;
constexpr int kNF = 3 * kNC;  // force inputs
constexpr int kNE = 4 * kNC;  // equality rows: 3 per contact, then 1 normal-velocity row per contact
constexpr int kG = GROUP;     // lanes per instance
constexpr int kLevels = NLEVELS;

static_assert(kNV <= 32, "one instance per group of at most a warp");
static_assert((kG & (kG - 1)) == 0 && kG >= kNV && (kG == 16 || kG / 2 < kNV),
              "GROUP is the next power of two >= kNV, at least 16");
static_assert(kG >= kNE, "a lane per equality row");

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

template <typename T>
__host__ __device__ constexpr size_t param_bytes() {
  return (P_SIZE * sizeof(T) + 15) / 16 * 16;
}

// Compile-time topology.  An index known only at run time (a lane's joint)
// goes through a chain of selects between constants: an array indexed at
// run time would be materialised in local memory and read back with one
// predicated local load per entry.
enum Table { kParentT, kTypeT, kContactT, kOrderT, kStartT };
__host__ __device__ constexpr int table(Table t, int i) {
  constexpr int parent[kNJ] = {PARENT_LIST};
  constexpr int type[kNJ] = {JTYPE_LIST};
  constexpr int contact[kNC] = {CONTACT_BODY_LIST};
  constexpr int order[kNJ] = {LEVEL_ORDER};
  constexpr int start[kLevels + 1] = {LEVEL_START};
  return t == kParentT ? parent[i] : t == kTypeT ? type[i] : t == kContactT ? contact[i] : t == kOrderT ? order[i]
                                                                                                    : start[i];
}
template <Table t, int K>
__device__ __forceinline__ int lookup(int i) {
  constexpr int v = table(t, K);
  if constexpr (K == 0) {
    return v;
  } else {
    return i == K ? v : lookup<t, K - 1>(i);
  }
}
__device__ __forceinline__ int parent_of(int j) { return lookup<kParentT, kNJ - 1>(j); }
__device__ __forceinline__ bool revolute(int j) { return lookup<kTypeT, kNJ - 1>(j) == 0; }
__device__ __forceinline__ int contact_body(int i) { return lookup<kContactT, kNC - 1>(i); }
__device__ __forceinline__ int level_joint(int k) { return lookup<kOrderT, kNJ - 1>(k); }
__host__ __device__ constexpr int level_start(int d) { return table(kStartT, d); }

// The lanes of one instance inside a warp.  Every lane of a warp reaches
// every barrier and shuffle (a kernel lets a group past the end of a ragged
// grid compute on the last instance and store nothing), so both take the
// whole warp's constant mask: one instruction each, where a mask computed
// per group costs a loop that re-converges the warp.
struct Group {
  int lane;  // 0 <= lane < kG
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  template <typename T>
  __device__ __forceinline__ T sum(T v) const {  // over the group's lanes
#pragma unroll
    for (int o = kG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, kG);
    return v;
  }
};

__device__ __forceinline__ Group this_group() { return Group{static_cast<int>(threadIdx.x & (kG - 1))}; }

// The instances of a block's warp: a warp whose first instance lies past M
// leaves at once; a group past M inside a live warp computes on instance
// M - 1 (live false) so that its warp's barriers stay whole.
struct Slot {
  int inst;   // the instance this group computes
  bool live;  // whether its results are stored
  bool warp_done;
};

template <int kInstPerBlock>
__device__ __forceinline__ Slot this_slot(int M) {
  const int gi = threadIdx.x / kG;
  const int first = blockIdx.x * kInstPerBlock + (threadIdx.x / 32) * (32 / kG);
  const int inst = blockIdx.x * kInstPerBlock + gi;
  return Slot{inst < M ? inst : M - 1, inst < M, first >= M};
}

__device__ __forceinline__ void sin_cos(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ void sin_cos(double a, double* s, double* c) { sincos(a, s, c); }

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// entry of a 3x3 product: row a (stride sa) . column b (stride sb)
template <typename T>
__device__ __forceinline__ T dot3(const T* a, int sa, const T* b, int sb) {
  return a[0] * b[0] + a[sa] * b[sb] + a[2 * sa] * b[2 * sb];
}

// entry (r, c) of the adjugate of a 3x3 matrix with row stride ld, in the
// product order of the one-thread inverse (ops/linalg.py inv3)
template <typename T>
__device__ __forceinline__ T adj3(const T* M, int ld, int r, int c) {
  const int c1 = c == 2 ? 0 : c + 1, c2 = c == 0 ? 2 : c - 1;
  const int r1 = r == 2 ? 0 : r + 1, r2 = r == 0 ? 2 : r - 1;
  return M[ld * c1 + r1] * M[ld * c2 + r2] - M[ld * c1 + r2] * M[ld * c2 + r1];
}

// entry (r, c) of the inverse of a 3x3 matrix (adjugate / determinant)
template <typename T>
__device__ __forceinline__ T inv3_entry(const T* M, int ld, int r, int c) {
  const T det = M[0] * adj3(M, ld, 0, 0) + M[1] * adj3(M, ld, 1, 0) + M[2] * adj3(M, ld, 2, 0);
  return adj3(M, ld, r, c) / det;
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kScr = cmax(12 * kNJ, 42);  // the joints' frames, then the inv6 pieces

// One centroidal evaluation of an instance, resident in shared memory.
template <typename T>
struct Pass {
  T R[kNB][9];   // world rotation of each body, row-major
  T A[6][kNV];   // centroidal momentum matrix
  T scr[kScr];   // the joints' frames in their parents', then the inv6 pieces
  T p[kNB][3];   // world position of each body origin
  T E[9];        // Euler-rate map: omega_world = E theta_dot
  T W[kNV][3], V0[kNV][3];  // velocity fields
  T cb[kNB][3];  // body coms (world)
  T Ib[kNB][9];  // body inertias (world)
  T com[3];
  T Abi[36];     // inverse of the CMM's base block, row-major
  T v[kNV];      // generalized velocity
  T pee[kNC][3]; // contact positions
  T f[kNX];      // flow value
};

// A kernel's per-instance shared layout, padded to an odd number of T.  The
// instances of a block lie at a stride of sizeof(OddStride), so the compiler
// can prove no more than T's own alignment for them.  With an even stride
// (16-byte aligned instances) nvcc for sm_90a merged the two operand choices
// of an inv6 step (A11^-1 A12's row or S^-1's row) into one 8- or 16-byte
// load that was aligned for one of them only: a misaligned-address fault on
// the H100 at every launch.
template <typename T, typename Body>
struct OddStride : Body {
  T pad[(sizeof(Body) / sizeof(T)) % 2 == 0 ? 1 : 2];
};

// Bit b set: coordinate l moves body b (the move table of the parameter
// buffer, read once per lane into a register).
template <typename T>
__device__ __forceinline__ unsigned moved_bodies(const T* __restrict__ P, int l) {
  unsigned m = 0u;
  if (l < kNV) {
#pragma unroll
    for (int b = 0; b < kNB; ++b) m |= (P[P_MOVE + b * kNV + l] != T(0)) ? (1u << b) : 0u;
  }
  return m;
}
static_assert(kNB <= 32, "one bit per body");
__device__ __forceinline__ bool moves(unsigned moved, int b) { return (moved >> b) & 1u; }

// Per-body leaves of the subtree sums, one row of kLeaf values per body:
// m c (3), m |c|^2, m c c^T (xx, xy, xz, yy, yz, zz), world inertia (9), pad.
// A kernel keeps an instance's rows in a 16-byte aligned block of its
// shared memory, so a lane reads a row in five 16-byte loads.
constexpr int kLeaf = 20;

// q = [p_base(3), theta zyx(3), q_j(NJ)]  (model/kinematics.py forward_kinematics)
template <typename T>
__device__ void fk(const T* __restrict__ P, const T* q, Pass<T>& s, const Group& g) {
  const int lane = g.lane;
  if (lane < kNJ) {  // joint lane: its frame in its parent's, offR Rm(q_j) and off_p + offR d(q_j), in scr
    const int j = lane;
    const T* a = P + P_AXIS + 3 * j;
    const T* oR = P + P_OFF_R + 9 * j;
    const T* op = P + P_OFF_P + 3 * j;
    const T qj = q[6 + j];
    T Rm[9], d[3];
    if (revolute(j)) {
      T sn, c;
      sin_cos(qj, &sn, &c);
      const T K[9] = {T(0), -a[2], a[1], a[2], T(0), -a[0], -a[1], a[0], T(0)};
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          const T kk = K[3 * r] * K[cc] + K[3 * r + 1] * K[3 + cc] + K[3 * r + 2] * K[6 + cc];
          Rm[3 * r + cc] = (r == cc ? T(1) : T(0)) + sn * K[3 * r + cc] + (T(1) - c) * kk;
        }
#pragma unroll
      for (int r = 0; r < 3; ++r) d[r] = T(0);
    } else {
#pragma unroll
      for (int r = 0; r < 9; ++r) Rm[r] = (r % 4 == 0) ? T(1) : T(0);
#pragma unroll
      for (int r = 0; r < 3; ++r) d[r] = a[r] * qj;
    }
    T* Rl = s.scr + 12 * j;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) Rl[3 * r + c] = dot3(oR + 3 * r, 1, Rm + c, 3);
      Rl[9 + r] = op[r] + dot3(oR + 3 * r, 1, d, 1);
    }
  } else if (lane == kG - 1) {  // the base
    T cz, sz, cy, sy, cx, sx;
    sin_cos(q[3], &sz, &cz);
    sin_cos(q[4], &sy, &cy);
    sin_cos(q[5], &sx, &cx);
    T* R0 = s.R[0];
    R0[0] = cz * cy; R0[1] = cz * sy * sx - sz * cx; R0[2] = cz * sy * cx + sz * sx;
    R0[3] = sz * cy; R0[4] = sz * sy * sx + cz * cx; R0[5] = sz * sy * cx - cz * sx;
    R0[6] = -sy;     R0[7] = cy * sx;                R0[8] = cy * cx;
    s.E[0] = T(0); s.E[1] = -sz;  s.E[2] = cy * cz;
    s.E[3] = T(0); s.E[4] = cz;   s.E[5] = cy * sz;
    s.E[6] = T(1); s.E[7] = T(0); s.E[8] = -sy;
    s.p[0][0] = q[0]; s.p[0][1] = q[1]; s.p[0][2] = q[2];
  }
  g.sync();
  // world frames, one tree level at a time: lane 3k + r takes row r of the
  // level's k-th joint (R_b = R_parent Rl, p_b = p_parent + R_parent pl)
#pragma unroll
  for (int d = 0; d < kLevels; ++d) {
    const int n = 3 * (level_start(d + 1) - level_start(d));
    for (int k = lane; k < n; k += kG) {
      const int slot = k / 3, r = k - 3 * slot;
      const int j = level_joint(level_start(d) + slot);
      const int par = parent_of(j);
      const T* Rp = s.R[par] + 3 * r;
      const T* Rl = s.scr + 12 * j;
      const T Rrow[3] = {Rp[0], Rp[1], Rp[2]};
#pragma unroll
      for (int c = 0; c < 3; ++c) s.R[j + 1][3 * r + c] = dot3(Rrow, 1, Rl + c, 3);
      s.p[j + 1][r] = s.p[par][r] + dot3(Rrow, 1, Rl + 9, 1);
    }
    g.sync();
  }
}

// velocity field w_l, v0_l of coordinate l (model/second_order.py velocity_fields)
template <typename T>
__device__ __forceinline__ void field_column(const T* __restrict__ P, const Pass<T>& s, int l, T* w, T* v0) {
  if (l < 3) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      w[d] = T(0);
      v0[d] = (l == d) ? T(1) : T(0);
    }
  } else if (l < 6) {
    const int i = l - 3;
    const T e[3] = {s.E[i], s.E[3 + i], s.E[6 + i]};
    T wxp[3];
    cross3(e, s.p[0], wxp);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      w[d] = e[d];
      v0[d] = -wxp[d];
    }
  } else {
    const int j = l - 6;
    const T* Rb = s.R[j + 1];
    const T* ax = P + P_AXIS + 3 * j;
    T a[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) a[r] = Rb[3 * r] * ax[0] + Rb[3 * r + 1] * ax[1] + Rb[3 * r + 2] * ax[2];
    if (revolute(j)) {
      T axp[3];
      cross3(a, s.p[j + 1], axp);
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

// CMM column l from the per-body leaves, summed over the bodies that
// coordinate l moves (its subtree); cmm_lanes' A_lin / A_ang rows.
template <typename T>
__device__ void cmm_column(const T* __restrict__ P, Pass<T>& s, const T* __restrict__ leaf, int l, unsigned moved,
                           const T* w, const T* v0, T* Acol) {
  T ctot[3] = {T(0), T(0), T(0)}, csub[3] = {T(0), T(0), T(0)}, qsub = T(0);
  T cc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)}, Isub[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) Isub[q] = T(0);
#pragma unroll 1
  for (int b = 0; b < kNB; ++b) {
    const T* L = leaf + kLeaf * b;
#pragma unroll
    for (int r = 0; r < 3; ++r) ctot[r] += L[r];
    if (moves(moved, b)) {
#pragma unroll
      for (int r = 0; r < 3; ++r) csub[r] += L[r];
      qsub += L[3];
#pragma unroll
      for (int q = 0; q < 6; ++q) cc[q] += L[4 + q];
#pragma unroll
      for (int q = 0; q < 9; ++q) Isub[q] += L[10 + q];
    }
  }
  const T total_mass = P[P_TOTAL_MASS];
  T com[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) com[r] = ctot[r] / total_mass;
  if (l == 0) {
#pragma unroll
    for (int r = 0; r < 3; ++r) s.com[r] = com[r];
  }
  const T msub = P[P_MSUB + l];
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
    Acol[r] = msub * v0[r] + wxc[r];
    Acol[3 + r] = Iw + sxv[r] + w[r] * alpha - CCw[r] + csub[r] * comw;
    s.A[r][l] = Acol[r];
    s.A[3 + r][l] = Acol[3 + r];
  }
}

// Ab^{-1} (block Schur, ops/linalg.py inv6_block), v = [Ab^{-1}(m h - A_j v_j); v_j]
// and the flow value, in seven steps of independent entries.  scr holds
// A11^-1 (0), A11^-1 A12 (9), A21 A11^-1 (18), S = A22 - A21 A11^-1 A12 (27),
// rhs (36); Abi's blocks are written where they are made.
template <typename T>
__device__ void flow_from_cmm(const T* __restrict__ P, const T* x, const T* u, Pass<T>& s, const Group& g) {
  constexpr int L = kNV;  // row stride of A
  const T m = P[P_ROBOT_MASS];
  T* A11i = s.scr;
  T* X = s.scr + 9;
  T* Y = s.scr + 18;
  T* S = s.scr + 27;
  T* rhs = s.scr + 36;
  const int lane = g.lane;
  for (int t = lane; t < 15; t += kG) {
    if (t < 9) {
      A11i[t] = inv3_entry(&s.A[0][0], L, t / 3, t % 3);
    } else {
      const int r = t - 9;
      T ajv = T(0);
#pragma unroll
      for (int j = 0; j < kNJ; ++j) ajv += s.A[r][6 + j] * u[kNF + j];
      rhs[r] = m * x[r] - ajv;
    }
  }
  g.sync();
  for (int t = lane; t < 18; t += kG) {
    if (t < 9) {
      const int r = t / 3, c = t % 3;
      X[t] = dot3(A11i + 3 * r, 1, &s.A[0][3 + c], L);
    } else {
      const int r = (t - 9) / 3, c = (t - 9) % 3;
      Y[t - 9] = dot3(&s.A[3 + r][0], 1, A11i + c, 3);
    }
  }
  g.sync();
  for (int t = lane; t < 15; t += kG) {
    if (t < 9) {
      const int r = t / 3, c = t % 3;
      S[t] = s.A[3 + r][3 + c] - dot3(&s.A[3 + r][0], 1, X + c, 3);
    } else {
      const int k = t - 9;
      T acc = T(0);
      if (k < 3) {
#pragma unroll
        for (int i = 0; i < kNC; ++i) acc += u[3 * i + k];
        s.f[k] = k == 2 ? acc / m + T(-9.81) : acc / m;
      } else {
#pragma unroll
        for (int i = 0; i < kNC; ++i) {  // component k - 3 of (p_i - com) x F_i
          const int a = k == 3 ? 1 : (k == 4 ? 2 : 0), b = k == 3 ? 2 : (k == 4 ? 0 : 1);
          acc += (s.pee[i][a] - s.com[a]) * u[3 * i + b] - (s.pee[i][b] - s.com[b]) * u[3 * i + a];
        }
        s.f[k] = acc / m;
      }
    }
  }
  g.sync();
  for (int t = lane; t < 9 + kNJ; t += kG) {
    if (t < 9) {
      const int r = t / 3, c = t % 3;
      s.Abi[6 * (3 + r) + 3 + c] = inv3_entry(S, 3, r, c);
    } else {
      const int j = t - 9;
      s.v[6 + j] = u[kNF + j];
      s.f[12 + j] = u[kNF + j];
    }
  }
  g.sync();
  for (int t = lane; t < 18; t += kG) {
    if (t < 9) {  // top right: -(A11^-1 A12) S^-1
      const int r = t / 3, c = t % 3;
      s.Abi[6 * r + 3 + c] = -dot3(X + 3 * r, 1, &s.Abi[6 * 3 + 3 + c], 6);
    } else {      // bottom left: -S^-1 (A21 A11^-1)
      const int r = (t - 9) / 3, c = (t - 9) % 3;
      s.Abi[6 * (3 + r) + c] = -dot3(&s.Abi[6 * (3 + r) + 3], 1, Y + c, 3);
    }
  }
  g.sync();
  if (lane < 9) {  // top left: A11^-1 - (top right) (A21 A11^-1)
    const int r = lane / 3, c = lane % 3;
    s.Abi[6 * r + c] = A11i[lane] - dot3(&s.Abi[6 * r + 3], 1, Y + c, 3);
  }
  g.sync();
  if (lane < 6) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < 6; ++q) acc += s.Abi[6 * lane + q] * rhs[q];
    s.v[lane] = acc;
    s.f[6 + lane] = acc;
  }
  g.sync();
}

// The centroidal evaluation at state x: FK, fields (lane l keeps w_l, v0_l
// and CMM column l in registers, and stores the fields in s.W / s.V0), body
// coms and inertias, contact positions, CMM, Ab^{-1}, v, flow value.  Every
// lane of the group calls it.
template <typename T>
__device__ void centroidal_pass(const T* __restrict__ P, const T* x, const T* u, Pass<T>& s, T* __restrict__ leaf,
                                const Group& g, unsigned moved, T* w, T* v0, T* Acol) {
  const int lane = g.lane;
  fk(P, x + 6, s, g);
  if (lane < kNV) {
    field_column(P, s, lane, w, v0);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s.W[lane][d] = w[d];
      s.V0[lane][d] = v0[d];
    }
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) w[d] = v0[d] = T(0);
  }
  if (lane < kNB) {
    const T* Rb = s.R[lane];
    const T* cbody = P + P_COM + 3 * lane;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      s.cb[lane][r] = s.p[lane][r] + (Rb[3 * r] * cbody[0] + Rb[3 * r + 1] * cbody[1] + Rb[3 * r + 2] * cbody[2]);
    const T* Il = P + P_INERTIA + 9 * lane;
    T RI[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) RI[3 * r + c] = Rb[3 * r] * Il[c] + Rb[3 * r + 1] * Il[3 + c] + Rb[3 * r + 2] * Il[6 + c];
    T* L = leaf + kLeaf * lane;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T Iw = RI[3 * r] * Rb[3 * c] + RI[3 * r + 1] * Rb[3 * c + 1] + RI[3 * r + 2] * Rb[3 * c + 2];
        s.Ib[lane][3 * r + c] = Iw;
        L[10 + 3 * r + c] = Iw;
      }
    const T mb = P[P_MASS + lane];
    const T* c = s.cb[lane];
#pragma unroll
    for (int r = 0; r < 3; ++r) L[r] = mb * c[r];
    L[3] = mb * (c[0] * c[0] + c[1] * c[1] + c[2] * c[2]);
    L[4] = mb * c[0] * c[0]; L[5] = mb * c[0] * c[1]; L[6] = mb * c[0] * c[2];
    L[7] = mb * c[1] * c[1]; L[8] = mb * c[1] * c[2]; L[9] = mb * c[2] * c[2];
  }
  if (lane < kNC) {
    const int b = contact_body(lane);
    const T* Rb = s.R[b];
    const T* cp = P + P_CONTACT_P + 3 * lane;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      s.pee[lane][r] = s.p[b][r] + (Rb[3 * r] * cp[0] + Rb[3 * r + 1] * cp[1] + Rb[3 * r + 2] * cp[2]);
  }
  g.sync();
  if (lane < kNV) cmm_column(P, s, leaf, lane, moved, w, v0, Acol);
  g.sync();
  flow_from_cmm(P, x, u, s, g);
}

// Column l of every contact Jacobian, J_i[:, l] = move(b_i, l) (v0_l + w_l x p_i)
// (contact_jacobians_lanes).
template <typename T>
__device__ __forceinline__ void contact_jacobian_column(const Pass<T>& s, unsigned moved, const T* w, const T* v0,
                                                        T J[kNC][3]) {
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    const bool mv = moves(moved, contact_body(i));
    T wxp[3];
    cross3(w, s.pee[i], wxp);
#pragma unroll
    for (int c = 0; c < 3; ++c) J[i][c] = mv ? v0[c] + wxp[c] : T(0);
  }
}

// Column l of the directional CMM derivative dA_v = d/dq (A(q) v) at fixed v,
// and of the contacts' dJ_v = d/dq (J_i v) (cmm_v_derivative_lanes and the
// dJ_v term of linearize_node_lanes).  The per-body aggregates walk the
// tree root to leaves: P_b = sum of v_k dv0_k, W_b = sum of v_k dw_k over
// the coordinates k that move body b (column l each), omega_b and the
// body-origin velocity v0a_b; each body's share of d(momentum)/dq_l is
// added as soon as its aggregates are known, in body order, so only the
// aggregates of bodies with children still to come (and of the contact
// bodies) stay live.
template <typename T>
__device__ void cmm_v_derivative_column(const T* __restrict__ P, const Pass<T>& s, int l, unsigned moved, const T* w,
                                        const T* v0, const T* Acol, const T J[kNC][3], T dA[6], T dJ[kNC][3]) {
  const T* pb = s.p[0];
  const T total_mass = P[P_TOTAL_MASS];
  const T dcom[3] = {Acol[0] / total_mass, Acol[1] / total_mass, Acol[2] / total_mass};
  T Pb[kNB][3], Wb[kNB][3], om[kNB][3], v0a[kNB][3];
  T dp[3] = {T(0), T(0), T(0)}, dL[3] = {T(0), T(0), T(0)};

#pragma unroll
  for (int b = 0; b < kNB; ++b) {
    if (b == 0) {
      // base: Euler coordinates k = 3 + i; dw_k[l] = w_l x w_k for the
      // Euler coordinates l before k, dp_base/dq_l = e_l for l < 3
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Pb[0][c] = Wb[0][c] = om[0][c] = T(0);
        v0a[0][c] = s.v[c];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const T wk[3] = {s.E[i], s.E[3 + i], s.E[6 + i]};
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
    } else {
      // joint j = b - 1: body b hangs off body parent_of(j)
      const int j = b - 1, par = parent_of(j);
      const T vk = s.v[6 + j];
      const bool rev = revolute(j);
      const T* a = rev ? s.W[6 + j] : s.V0[6 + j];  // world joint axis
      const T* anchor = s.p[b];
      const bool mv = moves(moved, b);
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
    // body b's share of d(momentum)/dq_l
    const T mb = P[P_MASS + b];
    const T* cb = s.cb[b];
    const T* Iw = s.Ib[b];
    const bool mv = moves(moved, b);
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
    for (int c = 0; c < 3; ++c) dL[c] += (rot ? wxIom[c] - Iwxom[c] : T(0)) + IWb[c] + mb * (t[c] + t2[c]);
    // dJ_v of the contacts on body b: P_b + W_b x p_i + omega_b x J_i (taken
    // here, so that no body's aggregates stay live to the end)
#pragma unroll
    for (int i = 0; i < kNC; ++i) {
      if (contact_body(i) != b) continue;
      T t3[3], t4[3];
      cross3(Wb[b], s.pee[i], t3);
      cross3(om[b], J[i], t4);
#pragma unroll
      for (int c = 0; c < 3; ++c) dJ[i][c] = Pb[b][c] + t3[c] + t4[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dA[c] = dp[c];
    dA[3 + c] = dL[c];
  }
}

}  // namespace circuit
