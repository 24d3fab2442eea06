// The host WBC of the controller's tick in one call: the task rows, the QP's
// SPD Schur complement and its inverse, the warm-started ADMM and the
// residuals of wbc/host_wbc.py (HostWbc._assemble + solve_qp_np), after the
// C++ host model (native/host_model.cc) has filled the WBC kinematics.
//
// In numpy the assembly and the Schur complement's inverse were most of the
// 2.5 ms tick's host time, all of it holding the GIL beside the MPC worker
// (PERF.md, phase 12); here ctypes releases the GIL for the whole call.
// The row stacking, the ADMM iteration and its defaults are solve_qp_np's;
// the products with A run over its nonzeros (a quarter of its entries), the
// dense ones in axpy form (one contiguous row per step, which the compiler
// vectorises), and the inverse comes from a Cholesky factor instead of
// LAPACK's LU.
// tests/test_torch_host_wbc.py holds the assembly against HostWbc._assemble
// and the solve against the numpy path.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (utils/native_build.py).

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <vector>

namespace {

constexpr int NC = 4;          // contact points (wbc/tasks.py::NUM_CONTACTS)
constexpr int NFC = 3 * NC;    // contact force unknowns
constexpr double BIG = 1e20;   // host_wbc.py::_BIG, the open side of an inequality

struct Wbc {
  int nj, nv, ndec, n_eq, m;
  double w_swing, w_base, w_force, swing_kp, swing_kd, mu;
  double base_kp[6], base_kd[6];
  double rho, sigma, alpha, eq_rho_scale;
  std::vector<double> limits, reg;                     // (nj), (ndec)
  std::vector<double> A, l, u, Wa, Wb, H, g;           // the assembled QP
  std::vector<double> rho_vec, inv_rho, P, P_inv, Y;  // the solve's operands
  std::vector<int> row_ptr, cols;                      // A's nonzeros by rows
  std::vector<double> vals, rho_vals;                  // A's and diag(rho) A's
  std::vector<double> b_rhs, rhs, x_t, ax;
};

struct Mat3 {
  double m[9];
  double operator()(int r, int c) const { return m[3 * r + c]; }
};

Mat3 mul(const Mat3& a, const Mat3& b) {
  Mat3 out;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) out.m[3 * r + c] = a(r, 0) * b(0, c) + a(r, 1) * b(1, c) + a(r, 2) * b(2, c);
  return out;
}

// R = Rz Ry Rx of theta = [z, y, x] (host_model.py::rotmat_from_zyx_np)
Mat3 rotmat_from_zyx(const double* th) {
  const double cz = std::cos(th[0]), sz = std::sin(th[0]);
  const double cy = std::cos(th[1]), sy = std::sin(th[1]);
  const double cx = std::cos(th[2]), sx = std::sin(th[2]);
  const Mat3 Rz{{cz, -sz, 0.0, sz, cz, 0.0, 0.0, 0.0, 1.0}};
  const Mat3 Ry{{cy, 0.0, sy, 0.0, 1.0, 0.0, -sy, 0.0, cy}};
  const Mat3 Rx{{1.0, 0.0, 0.0, 0.0, cx, -sx, 0.0, sx, cx}};
  return mul(mul(Rz, Ry), Rx);
}

// log of SO(3) of R_d R_m^T (host_dynamics.py::rotation_error_in_world_np)
void rotation_error_in_world(const Mat3& Rd, const Mat3& Rm, double* out) {
  Mat3 R;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) R.m[3 * r + c] = Rd(r, 0) * Rm(c, 0) + Rd(r, 1) * Rm(c, 1) + Rd(r, 2) * Rm(c, 2);
  const double trace = R(0, 0) + R(1, 1) + R(2, 2);
  const double cos_angle = std::clamp(0.5 * (trace - 1.0), -1.0, 1.0);
  const double angle = std::acos(cos_angle);
  const double factor = angle < 1e-6 ? 0.5 * (1.0 + angle * angle / 6.0) : 0.5 * angle / std::sin(angle);
  out[0] = factor * (R(2, 1) - R(1, 2));
  out[1] = factor * (R(0, 2) - R(2, 0));
  out[2] = factor * (R(1, 0) - R(0, 1));
}

double dot(const double* a, const double* b, int n) {
  double acc = 0.0;
  for (int i = 0; i < n; ++i) acc += a[i] * b[i];
  return acc;
}

// max(acc, v) that keeps a NaN, as numpy's max does
double nan_max(double acc, double v) { return (v > acc || std::isnan(v)) ? v : acc; }

// y = M^T x for row-major M (rows x cols): one contiguous row of M per step
void gemv_t(const double* M, const double* x, double* y, int rows, int cols) {
  std::fill(y, y + cols, 0.0);
  for (int r = 0; r < rows; ++r) {
    const double* row = M + static_cast<std::size_t>(r) * cols;
    const double xr = x[r];
    for (int c = 0; c < cols; ++c) y[c] += row[c] * xr;
  }
}

// The WBC kinematics that native/host_model.cc's host_model_wbc_kinematics
// fills, and the desired contact forces (u_des[:12]).
struct Kin {
  const double *q_m, *v_m, *M, *nle, *Jc, *dJc, *p_c, *v_c, *base_J, *base_dJ, *p_d, *v_cd, *pose_d, *vel_d,
      *acc_d, *forces_d;
};

// HostWbc._assemble: A (m x ndec), l, u; the weighted rows Wa (30 x ndec),
// Wb; H = Wa^T Wa + diag(reg), g = -Wa^T Wb.
void assemble(Wbc& w, const Kin& k, const double* flags) {
  const int nv = w.nv, nj = w.nj, ndec = w.ndec;
  double* A = w.A.data();
  std::fill(w.A.begin(), w.A.end(), 0.0);
  auto a = [&](int r, int c) -> double& { return A[static_cast<std::size_t>(r) * ndec + c]; };
  // equalities: eom (nv) | friction (12) | no contact motion (12)
  for (int r = 0; r < nv; ++r) {
    for (int c = 0; c < nv; ++c) a(r, c) = k.M[r * nv + c];
    for (int c = 0; c < NFC; ++c) a(r, nv + c) = -k.Jc[c * nv + r];
    if (r >= 6) a(r, nv + NFC + r - 6) = -1.0;
    w.l[r] = -k.nle[r];
  }
  for (int i = 0; i < NC; ++i) {
    const double swing = 1.0 - flags[i];
    for (int j = 0; j < 3; ++j) {
      const int row = 3 * i + j;
      a(nv + row, nv + row) = swing;
      w.l[nv + row] = 0.0;
      const double* J = k.Jc + static_cast<std::size_t>(row) * nv;
      for (int c = 0; c < nv; ++c) a(nv + NFC + row, c) = flags[i] * J[c];
      w.l[nv + NFC + row] = flags[i] * (-dot(k.dJc + static_cast<std::size_t>(row) * nv, k.v_m, nv));
    }
  }
  for (int r = 0; r < w.n_eq; ++r) w.u[r] = w.l[r];
  // inequalities: torque limits (2 nj) | friction pyramids (20)
  const int off_tau = nv + NFC;
  for (int j = 0; j < nj; ++j) {
    a(w.n_eq + j, off_tau + j) = 1.0;
    a(w.n_eq + nj + j, off_tau + j) = -1.0;
    w.u[w.n_eq + j] = w.u[w.n_eq + nj + j] = w.limits[j];
  }
  const double pyramid[5][3] = {{0.0, 0.0, -1.0}, {1.0, 0.0, -w.mu}, {-1.0, 0.0, -w.mu},
                                {0.0, 1.0, -w.mu}, {0.0, -1.0, -w.mu}};
  for (int i = 0; i < NC; ++i)
    for (int r = 0; r < 5; ++r) {
      const int row = w.n_eq + 2 * nj + 5 * i + r;
      for (int c = 0; c < 3; ++c) a(row, nv + 3 * i + c) = flags[i] * pyramid[r][c];
      w.u[row] = 0.0;
    }
  for (int r = w.n_eq; r < w.m; ++r) w.l[r] = -BIG;

  // weighted tasks: swing legs (12) | base acceleration (6) | contact forces (12)
  double* Wa = w.Wa.data();
  std::fill(w.Wa.begin(), w.Wa.end(), 0.0);
  auto wa = [&](int r, int c) -> double& { return Wa[static_cast<std::size_t>(r) * ndec + c]; };
  for (int i = 0; i < NC; ++i) {
    const double swing = 1.0 - flags[i];
    for (int j = 0; j < 3; ++j) {
      const int row = 3 * i + j;
      const double accel = w.swing_kp * (k.p_d[row] - k.p_c[row]) + w.swing_kd * (k.v_cd[row] - k.v_c[row]);
      const double* J = k.Jc + static_cast<std::size_t>(row) * nv;
      for (int c = 0; c < nv; ++c) wa(row, c) = w.w_swing * (swing * J[c]);
      w.Wb[row] = w.w_swing * (swing * (accel - dot(k.dJc + static_cast<std::size_t>(row) * nv, k.v_m, nv)));
    }
  }
  const double* th = k.q_m + 3;
  const double cz = std::cos(th[0]), sz = std::sin(th[0]), cy = std::cos(th[1]), sy = std::sin(th[1]);
  const double* dth = k.v_m + 3;
  const double omega_m[3] = {0.0 * dth[0] + -sz * dth[1] + cz * cy * dth[2],
                             0.0 * dth[0] + cz * dth[1] + sz * cy * dth[2],
                             1.0 * dth[0] + 0.0 * dth[1] + -sy * dth[2]};
  double rot_err[3];
  rotation_error_in_world(rotmat_from_zyx(k.pose_d + 3), rotmat_from_zyx(th), rot_err);
  for (int r = 0; r < 3; ++r) {
    wa(NFC + r, r) = w.w_base * 1.0;
    const double* J = k.base_J + static_cast<std::size_t>(3 + r) * nv;
    for (int c = 0; c < nv; ++c) wa(NFC + 3 + r, c) = w.w_base * J[c];
    const double pos_err = k.pose_d[r] - k.q_m[r], vel_err = k.vel_d[r] - k.v_m[r];
    w.Wb[NFC + r] = w.w_base * (k.acc_d[r] + w.base_kp[r] * pos_err + w.base_kd[r] * vel_err);
    const double omega_err = k.vel_d[3 + r] - omega_m[r];
    w.Wb[NFC + 3 + r] = w.w_base * (k.acc_d[3 + r] + w.base_kp[3 + r] * rot_err[r] + w.base_kd[3 + r] * omega_err -
                                    dot(k.base_dJ + static_cast<std::size_t>(3 + r) * nv, k.v_m, nv));
  }
  for (int c = 0; c < NFC; ++c) {
    wa(NFC + 6 + c, nv + c) = w.w_force * 1.0;
    w.Wb[NFC + 6 + c] = w.w_force * k.forces_d[c];
  }
  const int nw = 2 * NFC + 6;
  double* H = w.H.data();
  std::fill(w.H.begin(), w.H.end(), 0.0);
  for (int r = 0; r < nw; ++r) {  // H += Wa[r]^T Wa[r], one outer product per row
    const double* row = Wa + static_cast<std::size_t>(r) * ndec;
    for (int i = 0; i < ndec; ++i) {
      const double ri = row[i];
      if (ri == 0.0) continue;
      double* Hi = H + static_cast<std::size_t>(i) * ndec;
      for (int c = 0; c < ndec; ++c) Hi[c] += ri * row[c];
    }
  }
  for (int i = 0; i < ndec; ++i) H[static_cast<std::size_t>(i) * ndec + i] += w.reg[i];
  gemv_t(Wa, w.Wb.data(), w.g.data(), nw, ndec);
  for (int i = 0; i < ndec; ++i) w.g[i] = -w.g[i];
}

// Lower Cholesky factor L of the SPD P in place, then P^{-1} = Y^T Y into
// inv (n x n, exactly symmetric) with Y = L^{-1} (lower) built in Y by rows.
void spd_inverse(double* P, double* inv, double* Y, int n) {
  for (int j = 0; j < n; ++j) {
    double d = P[j * n + j];
    for (int k = 0; k < j; ++k) d -= P[j * n + k] * P[j * n + k];
    const double ljj = std::sqrt(d);
    P[j * n + j] = ljj;
    for (int i = j + 1; i < n; ++i) {
      double s = P[i * n + j];
      for (int k = 0; k < j; ++k) s -= P[i * n + k] * P[j * n + k];
      P[i * n + j] = s / ljj;
    }
  }
  std::fill(Y, Y + n * n, 0.0);
  for (int i = 0; i < n; ++i) {  // row i of L^{-1}: (e_i - sum_{k<i} L_ik Y_k) / L_ii
    double* yi = Y + i * n;
    yi[i] = 1.0;
    for (int k = 0; k < i; ++k) {
      const double lik = P[i * n + k];
      const double* yk = Y + k * n;
      for (int c = 0; c <= k; ++c) yi[c] -= lik * yk[c];
    }
    const double inv_lii = 1.0 / P[i * n + i];
    for (int c = 0; c <= i; ++c) yi[c] *= inv_lii;
  }
  std::fill(inv, inv + n * n, 0.0);
  for (int k = 0; k < n; ++k) {
    const double* yk = Y + k * n;
    for (int a = 0; a <= k; ++a) {
      const double yka = yk[a];
      double* row = inv + a * n;
      for (int b = 0; b <= k; ++b) row[b] += yka * yk[b];
    }
  }
}

}  // namespace

extern "C" {

void* host_wbc_create(int nj, double w_swing, double w_base, double w_force, double swing_kp, double swing_kd,
                      double mu, const double* base_kp, const double* base_kd, const double* limits,
                      const double* reg, double rho, double sigma, double alpha, double eq_rho_scale) {
  auto* w = new Wbc;
  w->nj = nj;
  w->nv = 6 + nj;
  w->ndec = w->nv + NFC + nj;
  w->n_eq = w->nv + 2 * NFC;
  w->m = w->n_eq + 2 * nj + 5 * NC;
  w->w_swing = w_swing;
  w->w_base = w_base;
  w->w_force = w_force;
  w->swing_kp = swing_kp;
  w->swing_kd = swing_kd;
  w->mu = mu;
  std::copy(base_kp, base_kp + 6, w->base_kp);
  std::copy(base_kd, base_kd + 6, w->base_kd);
  w->rho = rho;
  w->sigma = sigma;
  w->alpha = alpha;
  w->eq_rho_scale = eq_rho_scale;
  w->limits.assign(limits, limits + nj);
  w->reg.assign(reg, reg + w->ndec);
  const std::size_t n = w->ndec, m = w->m;
  w->A.resize(m * n);
  w->l.resize(m);
  w->u.resize(m);
  w->Wa.resize((2 * NFC + 6) * n);
  w->Wb.resize(2 * NFC + 6);
  w->H.resize(n * n);
  w->g.resize(n);
  w->rho_vec.resize(m);
  w->inv_rho.resize(m);
  w->P.resize(n * n);
  w->P_inv.resize(n * n);
  w->Y.resize(n * n);
  w->row_ptr.resize(m + 1);
  w->cols.resize(m * n);
  w->vals.resize(m * n);
  w->rho_vals.resize(m * n);
  w->b_rhs.resize(m);
  w->rhs.resize(n);
  w->x_t.resize(n);
  w->ax.resize(m);
  return w;
}

void host_wbc_destroy(void* h) { delete static_cast<Wbc*>(h); }

int host_wbc_rows(void* h) { return static_cast<Wbc*>(h)->m; }

// The assembled QP of the given kinematics and contact flags, copied out:
// H (ndec x ndec), g (ndec), A (m x ndec), l, u (m).
void host_wbc_assemble(void* h, const double* const* kin, const double* flags, double* H, double* g, double* A,
                       double* l, double* u) {
  auto& w = *static_cast<Wbc*>(h);
  const Kin k{kin[0], kin[1], kin[2],  kin[3],  kin[4],  kin[5],  kin[6],  kin[7],
              kin[8], kin[9], kin[10], kin[11], kin[12], kin[13], kin[14], kin[15]};
  assemble(w, k, flags);
  std::copy(w.H.begin(), w.H.end(), H);
  std::copy(w.g.begin(), w.g.end(), g);
  std::copy(w.A.begin(), w.A.end(), A);
  std::copy(w.l.begin(), w.l.end(), l);
  std::copy(w.u.begin(), w.u.end(), u);
}

// One tick: assemble, factor, then `iters` ADMM iterations from (x, z, y)
// (cold = 1: from x = 0, z = clip(0, l, u), y = 0), updated in place.
// residuals[0] = max |A x - clip(A x, l, u)|, residuals[1] = max |H x + g + A^T y|.
// kin: the 16 arrays of Kin, in its order.
void host_wbc_solve(void* h, const double* const* kin, const double* flags, int iters, int cold, double* x,
                    double* z, double* y, double* residuals) {
  auto& w = *static_cast<Wbc*>(h);
  const Kin k{kin[0], kin[1], kin[2],  kin[3],  kin[4],  kin[5],  kin[6],  kin[7],
              kin[8], kin[9], kin[10], kin[11], kin[12], kin[13], kin[14], kin[15]};
  assemble(w, k, flags);
  const int n = w.ndec, m = w.m;
  const double *A = w.A.data(), *l = w.l.data(), *u = w.u.data();
  double *rho_vec = w.rho_vec.data(), *inv_rho = w.inv_rho.data();
  // A's nonzeros by rows (~1/4 of its entries): skipping its zeros leaves
  // every product's sum as the dense one's
  int *row_ptr = w.row_ptr.data(), *cols = w.cols.data();
  double *vals = w.vals.data(), *rho_vals = w.rho_vals.data();
  row_ptr[0] = 0;
  for (int r = 0, nz = 0; r < m; ++r) {
    rho_vec[r] = (u[r] - l[r]) < 1e-9 ? w.rho * w.eq_rho_scale : w.rho;
    inv_rho[r] = 1.0 / rho_vec[r];
    const double* ar = A + static_cast<std::size_t>(r) * n;
    for (int c = 0; c < n; ++c)
      if (ar[c] != 0.0) {
        cols[nz] = c;
        vals[nz] = ar[c];
        rho_vals[nz] = rho_vec[r] * ar[c];
        ++nz;
      }
    row_ptr[r + 1] = nz;
  }
  // y = A x and y = A^T x on the nonzeros
  auto a_mul = [&](const double* x, double* y) {
    for (int r = 0; r < m; ++r) {
      double acc = 0.0;
      for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) acc += vals[e] * x[cols[e]];
      y[r] = acc;
    }
  };
  auto at_mul = [&](const double* v, const double* x, double* y) {
    std::fill(y, y + n, 0.0);
    for (int r = 0; r < m; ++r)
      for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) y[cols[e]] += v[e] * x[r];
  };
  // P = H + sigma I + A^T diag(rho) A, one outer product per row of A
  double* P = w.P.data();
  std::copy(w.H.begin(), w.H.end(), P);
  for (int i = 0; i < n; ++i) P[i * n + i] += w.sigma;
  for (int r = 0; r < m; ++r)
    for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
      double* Pi = P + static_cast<std::size_t>(cols[e]) * n;
      for (int f = row_ptr[r]; f < row_ptr[r + 1]; ++f) Pi[cols[f]] += vals[e] * rho_vals[f];
    }
  double* P_inv = w.P_inv.data();
  spd_inverse(P, P_inv, w.Y.data(), n);

  if (cold) {
    std::fill(x, x + n, 0.0);
    for (int r = 0; r < m; ++r) {
      z[r] = std::clamp(0.0, l[r], u[r]);
      y[r] = 0.0;
    }
  }
  double *b_rhs = w.b_rhs.data(), *rhs = w.rhs.data(), *x_t = w.x_t.data(), *ax = w.ax.data();
  const double* g = w.g.data();
  const double sigma = w.sigma, alpha = w.alpha;
  for (int it = 0; it < iters; ++it) {
    for (int r = 0; r < m; ++r) b_rhs[r] = z[r] - y[r] * inv_rho[r];
    at_mul(rho_vals, b_rhs, rhs);  // (diag(rho) A)^T b_rhs
    for (int i = 0; i < n; ++i) rhs[i] += sigma * x[i] - g[i];
    gemv_t(P_inv, rhs, x_t, n, n);  // P^{-1} is symmetric
    a_mul(x_t, ax);
    for (int i = 0; i < n; ++i) x[i] = alpha * x_t[i] + (1.0 - alpha) * x[i];
    for (int r = 0; r < m; ++r) {
      const double nu = rho_vec[r] * (ax[r] - b_rhs[r]);
      const double z_t = z[r] + (nu - y[r]) * inv_rho[r];
      const double z_mix = alpha * z_t + (1.0 - alpha) * z[r];
      const double z_new = std::clamp(z_mix + y[r] * inv_rho[r], l[r], u[r]);
      y[r] += rho_vec[r] * (z_mix - z_new);
      z[r] = z_new;
    }
  }
  a_mul(x, ax);
  double primal = 0.0;
  for (int r = 0; r < m; ++r) primal = nan_max(primal, std::abs(ax[r] - std::clamp(ax[r], l[r], u[r])));
  gemv_t(w.H.data(), x, rhs, n, n);  // H is symmetric
  at_mul(vals, y, x_t);
  double dual = 0.0;
  for (int i = 0; i < n; ++i) dual = nan_max(dual, std::abs(rhs[i] + g[i] + x_t[i]));
  residuals[0] = primal;
  residuals[1] = dual;
}

}  // extern "C"
