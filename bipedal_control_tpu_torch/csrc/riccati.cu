// Constrained Riccati backward sweep + forward rollout, one CTA per scenario.
//
// Replaces the TPU kernels of bipedal_control_tpu/ops/pallas_riccati.py:
// _backward_kernel (K2) and _forward_kernel (K3), reached through
// riccati_backward_pallas / riccati_solve_pallas.  Stage math is that of
// solver/riccati.py::_stage_kkt and solve_lqr:
//
//   H_xx = Qxx + A'SA,  H_uu = Quu + B'SB,  H_ux = Qux + B'SA,
//   h_x = qx + A'(S c + s),  h_u = qu + B'(S c + s)
//   [H_uu + r I  D' | H_ux  h_u]      pivot-free Gauss-Jordan (quasi-definite)
//   [D       -Reg  | C     e  ]  ->  K, k
//   S = H_xx + K'H_uu K - K'H_ux - H_ux'K (symmetrized), s = ...
//   forward: du = -K dx - k,  dx' = A dx + B du + c
//
// Design.  On the TPU the scenario batch sat on the 128 vector lanes and the
// stage axis was a sequential grid dimension carrying (S, s) in VMEM scratch.
// On a GPU one thread per scenario would be only B threads, so each scenario
// gets a CTA, and its threads split every small product by output element.
// The stage loop N-1..0 runs inside the block with S, s and the 38 x 61
// augmented KKT in shared memory (the VMEM carry's counterpart); Gauss-Jordan
// takes one __syncthreads() per pivot by double-buffering the next pivot row
// and column.  The forward rollout (K3) runs in the same CTA afterwards, so
// K and k are never re-read by another launch.
//
// Bound: latency.  Per stage the block does ~38 + 8 barrier-separated steps
// of a few hundred flops per thread, and B = 256 CTAs fill the 132 SMs only
// twice over; device-memory traffic is one read of the stage tensors.  The
// TPU kernel's unit-Huu padding of empty batch lanes has no counterpart:
// there are no padding lanes, every CTA is a real scenario.
#include <cuda_runtime.h>

#include "gauss_jordan.cuh"

namespace {

template <typename T>
__global__ void riccati_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ c,
    const T* __restrict__ C, const T* __restrict__ D, const T* __restrict__ e,
    const T* __restrict__ Qxx, const T* __restrict__ Quu, const T* __restrict__ Qux,
    const T* __restrict__ qx, const T* __restrict__ qu, const T* __restrict__ mask,
    const T* __restrict__ dx0,
    T* __restrict__ Kout, T* __restrict__ kout, T* __restrict__ dxout, T* __restrict__ duout,
    int N, int nx, int nu, int ne, T dual_eps, T huu_reg) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nk = nu + ne;        // KKT rows
  const int W = nk + nx + 1;     // augmented columns: KKT | state | rhs
  T* S = sm;                     // nx*nx cost-to-go
  T* s = S + nx * nx;            // nx
  T* sA = s + nx;                // nx*nx stage A
  T* sB = sA + nx * nx;          // nx*nu stage B
  T* SA = sB + nx * nu;          // nx*nx  S A  (later: unsymmetrized S)
  T* SB = SA + nx * nx;          // nx*nu  S B  (later: H_uu K)
  T* Sc = SB + nx * nu;          // max(nx,nu)  S c + s (later: H_uu k)
  T* Hxx = Sc + (nx > nu ? nx : nu);  // nx*nx
  T* Huu = Hxx + nx * nx;        // nu*nu
  T* Hux = Huu + nu * nu;        // nu*nx
  T* hx = Hux + nu * nx;         // nx
  T* hu = hx + nx;               // nu
  T* aug = hu + nu;              // nk*W
  T* rowb = aug + nk * W;        // 2*W   pivot row, double-buffered
  T* colb = rowb + 2 * W;        // 2*nk  pivot column, double-buffered
  T* dxs = colb + 2 * nk;        // 2*nx  forward state, double-buffered
  T* dus = dxs + 2 * nx;         // nu

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const size_t sAx = (size_t)nx * nx, sBx = (size_t)nx * nu;

  for (int i = tid; i < nx * nx; i += nth) S[i] = T(0);
  for (int i = tid; i < nx; i += nth) s[i] = T(0);
  __syncthreads();

  for (int t = N - 1; t >= 0; --t) {
    const size_t st = (size_t)b * N + t;
    const T* At = A + st * sAx;
    const T* Bt = Bm + st * sBx;
    const T* ct = c + st * nx;
    for (int i = tid; i < nx * nx; i += nth) sA[i] = At[i];
    for (int i = tid; i < nx * nu; i += nth) sB[i] = Bt[i];
    __syncthreads();

    // SA = S A, SB = S B, Sc = S c + s
    for (int idx = tid; idx < nx * nx + nx * nu + nx; idx += nth) {
      if (idx < nx * nx) {
        const int i = idx / nx, j = idx % nx;
        T acc = T(0);
        for (int k2 = 0; k2 < nx; ++k2) acc += S[i * nx + k2] * sA[k2 * nx + j];
        SA[idx] = acc;
      } else if (idx < nx * nx + nx * nu) {
        const int r = idx - nx * nx, i = r / nu, j = r % nu;
        T acc = T(0);
        for (int k2 = 0; k2 < nx; ++k2) acc += S[i * nx + k2] * sB[k2 * nu + j];
        SB[r] = acc;
      } else {
        const int i = idx - nx * nx - nx * nu;
        T acc = T(0);
        for (int k2 = 0; k2 < nx; ++k2) acc += S[i * nx + k2] * ct[k2];
        Sc[i] = acc + s[i];
      }
    }
    __syncthreads();

    // H_xx, H_uu, H_ux, h_x, h_u
    {
      const T* Qxxt = Qxx + st * sAx;
      const T* Quut = Quu + st * (size_t)nu * nu;
      const T* Quxt = Qux + st * sBx;
      const int n1 = nx * nx, n2 = n1 + nu * nu, n3 = n2 + nu * nx, n4 = n3 + nx, n5 = n4 + nu;
      for (int idx = tid; idx < n5; idx += nth) {
        if (idx < n1) {
          const int i = idx / nx, j = idx % nx;
          T acc = T(0);
          for (int k2 = 0; k2 < nx; ++k2) acc += sA[k2 * nx + i] * SA[k2 * nx + j];
          Hxx[idx] = Qxxt[idx] + acc;
        } else if (idx < n2) {
          const int r = idx - n1, i = r / nu, j = r % nu;
          T acc = T(0);
          for (int k2 = 0; k2 < nx; ++k2) acc += sB[k2 * nu + i] * SB[k2 * nu + j];
          Huu[r] = Quut[r] + acc;
        } else if (idx < n3) {
          const int r = idx - n2, i = r / nx, j = r % nx;
          T acc = T(0);
          for (int k2 = 0; k2 < nx; ++k2) acc += sB[k2 * nu + i] * SA[k2 * nx + j];
          Hux[r] = Quxt[r] + acc;
        } else if (idx < n4) {
          const int i = idx - n3;
          T acc = T(0);
          for (int k2 = 0; k2 < nx; ++k2) acc += sA[k2 * nx + i] * Sc[k2];
          hx[i] = qx[st * nx + i] + acc;
        } else {
          const int i = idx - n4;
          T acc = T(0);
          for (int k2 = 0; k2 < nx; ++k2) acc += sB[k2 * nu + i] * Sc[k2];
          hu[i] = qu[st * nu + i] + acc;
        }
      }
    }
    __syncthreads();

    // augmented KKT [H_uu + r I, D' | H_ux, h_u ; D, -Reg | C, e]
    {
      const T* Ct = C + st * (size_t)ne * nx;
      const T* Dt = D + st * (size_t)ne * nu;
      const T* et = e + st * ne;
      const T* mt = mask + st * ne;
      for (int idx = tid; idx < nk * W; idx += nth) {
        const int r = idx / W, col = idx % W;
        T v;
        if (r < nu) {
          if (col < nu) v = Huu[r * nu + col] + (r == col ? huu_reg : T(0));
          else if (col < nk) v = Dt[(col - nu) * nu + r];
          else if (col < nk + nx) v = Hux[r * nx + (col - nk)];
          else v = hu[r];
        } else {
          const int q = r - nu;
          if (col < nu) v = Dt[q * nu + col];
          else if (col < nk) v = (col - nu == q) ? -(mt[q] * dual_eps + (T(1) - mt[q])) : T(0);
          else if (col < nk + nx) v = Ct[q * nx + (col - nk)];
          else v = et[q];
        }
        aug[idx] = v;
        if (r == 0) rowb[col] = v;
        if (col == 0) colb[r] = v;
      }
    }
    __syncthreads();

    // Gauss-Jordan without pivoting: aug -= (col - e_i) (row_i / pivot)
    gauss_jordan_eliminate(aug, rowb, colb, nk, W);

    // K = X[:nu, state cols], k = X[:nu, rhs col]; H_uu K -> SB, H_uu k -> Sc
    {
      T* Kt = Kout + st * (size_t)nu * nx;
      T* kt = kout + st * nu;
      for (int idx = tid; idx < nu * nx + nu; idx += nth) {
        if (idx < nu * nx) {
          const int a = idx / nx, j = idx % nx;
          Kt[idx] = aug[a * W + nk + j];
          T acc = T(0);
          for (int b2 = 0; b2 < nu; ++b2) acc += Huu[a * nu + b2] * aug[b2 * W + nk + j];
          SB[idx] = acc;
        } else {
          const int a = idx - nu * nx;
          kt[a] = aug[a * W + nk + nx];
          T acc = T(0);
          for (int b2 = 0; b2 < nu; ++b2) acc += Huu[a * nu + b2] * aug[b2 * W + nk + nx];
          Sc[a] = acc;
        }
      }
    }
    __syncthreads();

    // unsymmetrized S -> SA, and s
    for (int idx = tid; idx < nx * nx + nx; idx += nth) {
      if (idx < nx * nx) {
        const int i = idx / nx, j = idx % nx;
        T acc = Hxx[idx];
        for (int a = 0; a < nu; ++a) {
          const T Kai = aug[a * W + nk + i], Kaj = aug[a * W + nk + j];
          acc += Kai * SB[a * nx + j] - Kai * Hux[a * nx + j] - Hux[a * nx + i] * Kaj;
        }
        SA[idx] = acc;
      } else {
        const int i = idx - nx * nx;
        T acc = hx[i];
        for (int a = 0; a < nu; ++a) {
          const T Kai = aug[a * W + nk + i];
          acc += Kai * Sc[a] - Kai * hu[a] - Hux[a * nx + i] * aug[a * W + nk + nx];
        }
        s[i] = acc;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nx * nx; idx += nth) {
      const int i = idx / nx, j = idx % nx;
      S[idx] = T(0.5) * (SA[i * nx + j] + SA[j * nx + i]);
    }
    __syncthreads();
  }

  // forward rollout (K3): du = -K dx - k, dx' = A dx + B du + c
  T* dxo = dxout + (size_t)b * (N + 1) * nx;
  for (int i = tid; i < nx; i += nth) {
    dxs[i] = dx0[(size_t)b * nx + i];
    dxo[i] = dxs[i];
  }
  __syncthreads();
  for (int t = 0; t < N; ++t) {
    const size_t st = (size_t)b * N + t;
    const T* cur = dxs + (t & 1) * nx;
    T* nxt = dxs + ((t + 1) & 1) * nx;
    const T* Kt = Kout + st * (size_t)nu * nx;
    for (int a = tid; a < nu; a += nth) {
      T acc = T(0);
      for (int j = 0; j < nx; ++j) acc += Kt[a * nx + j] * cur[j];
      const T v = -acc - kout[st * nu + a];
      dus[a] = v;
      duout[st * nu + a] = v;
    }
    __syncthreads();
    const T* At = A + st * sAx;
    const T* Bt = Bm + st * sBx;
    for (int i = tid; i < nx; i += nth) {
      T acc = T(0);
      for (int j = 0; j < nx; ++j) acc += At[i * nx + j] * cur[j];
      T acc2 = T(0);
      for (int a = 0; a < nu; ++a) acc2 += Bt[i * nu + a] * dus[a];
      const T v = acc + acc2 + c[st * nx + i];
      nxt[i] = v;
      dxo[(size_t)(t + 1) * nx + i] = v;
    }
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int nx, int nu, int ne) {
  const int nk = nu + ne, W = nk + nx + 1;
  const size_t n = (size_t)nx * nx * 4 + (size_t)nx * nu * 2 + (size_t)nu * nu + (size_t)nu * nx +
                   (size_t)nx * 4 + (size_t)(nx > nu ? nx : nu) + (size_t)nu * 2 + (size_t)nk * W +
                   2 * (size_t)W + 2 * (size_t)nk;
  return n * sizeof(T);
}

template <typename T>
int launch(const void* A, const void* B, const void* c, const void* C, const void* D, const void* e,
           const void* Qxx, const void* Quu, const void* Qux, const void* qx, const void* qu,
           const void* mask, const void* dx0, void* K, void* k, void* dx, void* du, int Bn, int N,
           int nx, int nu, int ne, double dual_eps, double huu_reg, void* stream) {
  const size_t smem = smem_bytes<T>(nx, nu, ne);
  cudaError_t err = cudaFuncSetAttribute(riccati_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  riccati_kernel<T><<<Bn, 256, smem, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)B, (const T*)c, (const T*)C, (const T*)D, (const T*)e, (const T*)Qxx,
      (const T*)Quu, (const T*)Qux, (const T*)qx, (const T*)qu, (const T*)mask, (const T*)dx0, (T*)K,
      (T*)k, (T*)dx, (T*)du, N, nx, nu, ne, (T)dual_eps, (T)huu_reg);
  return (int)cudaGetLastError();
}

}  // namespace

#define RICCATI_ENTRY(NAME, T)                                                                      \
  extern "C" int NAME(const void* A, const void* B, const void* c, const void* C, const void* D,   \
                      const void* e, const void* Qxx, const void* Quu, const void* Qux,            \
                      const void* qx, const void* qu, const void* mask, const void* dx0, void* K,  \
                      void* k, void* dx, void* du, int Bn, int N, int nx, int nu, int ne,          \
                      double dual_eps, double huu_reg, void* stream) {                             \
    return launch<T>(A, B, c, C, D, e, Qxx, Quu, Qux, qx, qu, mask, dx0, K, k, dx, du, Bn, N, nx,  \
                     nu, ne, dual_eps, huu_reg, stream);                                           \
  }

RICCATI_ENTRY(riccati_solve_f32, float)
RICCATI_ENTRY(riccati_solve_f64, double)
