// K5: batched pivot-free Gauss-Jordan solve A X = B of quasi-definite systems.
//
// Replaces the TPU kernel _gj_kernel of bipedal_control_tpu/ops/pallas_gj.py
// (pallas_call in gauss_jordan_solve_pallas).  The TPU kernel padded each
// augmented system to (8, 128) tiles, eliminated a tile of systems in VMEM
// and picked pivot rows and columns with one-hot masked reductions.  Its
// callers here are the device WBC's QP (wbc/qp.py): the inverse of its
// (128 x 128) KKT at G1's widths, B = eye(128), one system per controller
// tick and 256 under wbc_update_batch; and the stage KKT (38 x 38 | 23).
// It takes n <= 192 and n + k <= 512 (gauss_jordan_limits): the WBC's KKT
// is n = 68 + 5 nj, 128 at nj = 12 (G1, OpenLoong), 118 at H1's nj = 10.
//
// What bounds it on this card.  A (128 | 128) system is 6.25 M operations
// on 0.39 MB (float64): ~16 operations per byte, under the card's float64
// ratio (~20 on the tensor cores), so at B = 256 operations (float32) or
// bytes (float64) bound it at 0.024-0.030 ms.  At B = 1 neither does: the
// n pivots form a chain, each needing the one before, so the time is the
// chain's latency -- here 16 panels, each a round of stores between the
// SMs of a cluster, a barrier, and an 8-pivot elimination on one warp.  The
// stage KKT (38 | 23) x 17,152 is bytes (0.065 ms).
//
// Design.  The augmented matrix [A | B] of a system lives in registers, an
// 8 x 8-tiled fragment per warp (thread (g, q) = (lane / 4, lane % 4) holds
// row 8a + g, columns 8b + 2q, 8b + 2q + 1 of tile (a, b): the layout of
// mma.m8n8k4's accumulator), and is eliminated once.  Three shapes of CTA:
//   L64: 8 warps own 128 rows x 64 columns of one system;
//   T64: 12 warps own 192 rows x 64 columns (128 < n <= 192);
//   S40: one warp (float32) or two (float64) own 40 rows x 64 columns of
//        one system, 8 or 2 systems per CTA (n <= 40, n + k <= 64).
// A system of more than 64 columns belongs to a thread-block cluster of
// ceil((n + k) / 64) <= 8 L64 or T64 CTAs on neighbouring SMs, each holding
// a block of columns: the device WBC's KKT takes 4, at B = 1 as at B = 256.
// That is the fewest CTAs whose registers hold the system; more (8 CTAs of
// 32 columns at B = 1) measured slower, because every CTA added is one more
// destination of each panel's stores on the chain.  The cluster's CTAs
// meet at its barrier after their loads, before any CTA stores into
// another's shared memory (which must have started).
//
// Pivots go in panels of 8 (one tile).  Panel P (pivots p .. p + 7):
//   1. at the end of panel P - 1 (or after the load), look-ahead: the warps
//      holding the panel's rows write them (8 x this CTA's columns) to this
//      CTA's shared memory; the warps holding its columns (n x 8) store
//      them into the shared memory of every CTA of the cluster (distributed
//      shared memory: remote stores, no remote loads, which would put a
//      round trip between SMs on the chain of every pivot); the one warp
//      holding the 8 x 8 diagonal block then eliminates it (lanes 0-7, a
//      row each, shuffles, branch-free, one reciprocal per pivot) and
//      stores its factors -- W[i][j] (j > i) the normalised pivot rows,
//      L[i][j] (j < i) the multipliers, 1 / pivot_i -- likewise, in 16-byte
//      pieces; all double-buffered;
//   2. one barrier per panel: __syncthreads (__syncwarp for a system per
//      warp), or the cluster's barrier (release/acquire), which makes the
//      remote stores visible;
//   3. every warp, on its own: the multipliers of its rows (f_j = x_j -
//      sum_{j'<j} f_j' W[j'][j]) and the normalised panel rows at its
//      columns (u_j = (x_j - sum_{j'<j} L[j][j'] u_j') / pivot_j) into its
//      own shared memory, __syncwarp only;
//   4. the rank-8 update of the warp's register tile, X -= F U (the panel's
//      rows start from U): float64 on the tensor cores (mma.sync m8n8k4
//      f64; wgmma has no float64), float32 as fused multiply-adds on the
//      CUDA cores (TF32 would keep ~3 digits: the port keeps matrix
//      arithmetic in full float32); a warp whose columns are all left of
//      the panel is done.
// Each element sees the plain version's operations in its order
// (ops/linalg.py::gauss_jordan_solve): the eight rank-1 updates of a panel,
// summed in pivot order, only grouped; a pivot row is set to its
// normalised value instead of having (pivot - 1) x itself subtracted.
// Shared memory holds only the panel (2 x n x 12 + 2 x 8 x the CTA's
// columns) and each warp's multipliers and normalised rows, so registers,
// not shared memory, set the residency.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int PANEL = 8;  // pivots per panel: one 8 x 8 tile
constexpr int FS = 12;    // row stride of the panel-column and multiplier buffers

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
// correctly rounded 1 / x (the value of the plain version's division by the pivot)
__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double recip(double x) { return __drcp_rn(x); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// the cluster's barrier: remote stores before it are visible after it
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the same split at the kernel's start: once the wait returns, every CTA of
// the cluster has started, so its shared memory may take remote stores
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// d = a b + d on one 8 x 8 float64 tile, k = 4 (mma.sync m8n8k4: a at row g,
// column q; b at row q, column g; d at row g, columns 2q, 2q + 1)
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

template <int WR_, int WC_, int WGR_, int WGC_, int SPC_>
struct Tile {
  static constexpr int WR = WR_, WC = WC_;     // 8 x 8 tiles per warp: rows, columns
  static constexpr int WGR = WGR_, WGC = WGC_;  // warps per system: rows, columns
  static constexpr int SPC = SPC_;              // systems per CTA
  static constexpr int WARPS = WGR * WGC;
  static constexpr int THREADS = 32 * WARPS * SPC;
  static constexpr int WROWS = 8 * WR, WCOLS = 8 * WC;
  static constexpr int ROWS = WROWS * WGR;  // rows of a system
  static constexpr int COLS = WCOLS * WGC;  // columns of a CTA
  static constexpr int US = COLS + 4;       // row stride of the panel-row buffer
  static constexpr int UWS = WCOLS + 4;     // row stride of a warp's normalised rows
  // shared memory in elements, per system: panel columns [2][ROWS][FS],
  // diagonal factors [2][W 64, L 64, 1/pivot 8], panel rows [2][PANEL][US];
  // per warp: multipliers [WROWS][FS], normalised rows [PANEL][UWS]
  static constexpr int PC_SZ = ROWS * FS;
  static constexpr int DW_SZ = 64 + 64 + 8;
  static constexpr int PR_SZ = PANEL * US;
  static constexpr int FW_SZ = WROWS * FS;
  static constexpr int UW_SZ = PANEL * UWS;
  static constexpr int SYS_SZ = 2 * PC_SZ + 2 * DW_SZ + 2 * PR_SZ + WARPS * (FW_SZ + UW_SZ);
};

using L64 = Tile<4, 4, 4, 2, 1>;
using T64 = Tile<4, 4, 6, 2, 1>;  // 192 rows
constexpr int MAX_CLUSTER = 8;    // CTAs per system (the portable cluster size)
// 40 rows x 64 columns: float32 one warp per system (8 per CTA), float64
// (twice the registers) two (2 systems per CTA)
template <typename T>
using S40 = std::conditional_t<sizeof(T) == 4, Tile<5, 8, 1, 1, 8>, Tile<5, 4, 1, 2, 2>>;

// resident CTAs the registers must allow: 128 registers a thread for float64
// and for a warp per system, 85 otherwise
template <typename T, typename L>
constexpr int min_blocks() { return 65536 / (L::THREADS * (sizeof(T) == 8 || L::WARPS == 1 ? 128 : 85)); }

// The panel's 8 x 8 diagonal block (pc's rows p .. p + 7, local), eliminated
// by lanes 0-7 (one row each) into dw: W[i][j] (j > i) the normalised pivot
// rows, L[i][j] (j < i) the multipliers, IP[i] = 1 / pivot_i; zero outside
// the bn live pivots.
template <typename T>
__device__ __forceinline__ void factor_diagonal(const T* pc, T* dw, int p, int bn, int lane) {
  T* W = dw;
  T* Lo = dw + 64;
  T* IP = dw + 128;
  T row[PANEL];
#pragma unroll
  for (int j = 0; j < PANEL; ++j) row[j] = lane < PANEL ? pc[(p + lane) * FS + j] : T(0);
  T ip = T(0);
  // branch-free: the rows above the pivot take a zero multiplier, the
  // pivot's row its normalised values
#pragma unroll
  for (int j = 0; j < PANEL; ++j) {
    if (j < bn) {
      T w[PANEL];
#pragma unroll
      for (int jj = j; jj < PANEL; ++jj) w[jj] = __shfl_sync(0xffffffffu, row[jj], j);
      const T inv = recip(w[j]);
      const T f = lane > j ? row[j] : T(0);
      ip = lane == j ? inv : ip;
      if (lane > j && lane < PANEL) Lo[lane * 8 + j] = f;
#pragma unroll
      for (int jj = j + 1; jj < PANEL; ++jj) {
        const T wn = w[jj] * inv;
        const T v = fmadd(-f, wn, row[jj]);
        row[jj] = lane == j ? wn : v;
      }
    }
  }
  if (lane < PANEL) {
#pragma unroll
    for (int j = 0; j < PANEL; ++j) {
      W[lane * 8 + j] = (j > lane && j < bn) ? row[j] : T(0);
      if (j >= lane || lane >= bn) Lo[lane * 8 + j] = T(0);
    }
    IP[lane] = ip;
  }
}

// Look-ahead for the panel at pivot p (buffers pc, dw, pr of its parity):
// the warps holding rows p .. p + 7 write them at this CTA's columns to pr;
// the warps holding columns p .. p + 7 store them into every CTA's pc; the
// warp holding the diagonal block factors it into dw and copies that into
// every other CTA's dw (16-byte stores).
template <typename T, typename L>
__device__ __forceinline__ void publish(const T (&m)[L::WR][L::WC][2], T* pc, T* dw, T* pr, int p, int n, int rank,
                                        int cs, int rowbase, int colbase, int g, int q, int lane) {
#pragma unroll
  for (int a = 0; a < L::WR; ++a)
    if (rowbase + 8 * a == p)
#pragma unroll
      for (int b = 0; b < L::WC; ++b) store2(pr + g * L::US + colbase + 8 * b + 2 * q, m[a][b][0], m[a][b][1]);
  const int lc = p - rank * L::COLS;
  bool holds_diagonal = false;
#pragma unroll
  for (int b = 0; b < L::WC; ++b)
    if (colbase + 8 * b == lc) {
      for (int d = 0; d < cs; ++d) {
        T* dst = cs > 1 ? cg::this_cluster().map_shared_rank(pc, (unsigned)d) : pc;
#pragma unroll
        for (int a = 0; a < L::WR; ++a) store2(dst + (rowbase + 8 * a + g) * FS + 2 * q, m[a][b][0], m[a][b][1]);
      }
      holds_diagonal = p >= rowbase && p < rowbase + L::WROWS;
    }
  if (holds_diagonal) {
    __syncwarp();
    factor_diagonal<T>(pc, dw, p, min(PANEL, n - p), lane);
    if (cs > 1) {
      __syncwarp();
      constexpr int V = 16 / sizeof(T), NV = L::DW_SZ / V;
      for (int i = lane; i < (cs - 1) * NV; i += 32) {
        const int d = i / NV + (i / NV >= rank), v = i % NV;
        copy16(cg::this_cluster().map_shared_rank(dw, (unsigned)d) + v * V, dw + v * V);
      }
    }
  }
}

// The warp's multipliers (its rows, into fw) and normalised panel rows (its
// columns, into uw).  A row of the panel takes its normalised row right of
// its pivot as x, so its multipliers are those that clear the pivots after it.
template <typename T, typename L>
__device__ __forceinline__ void panel_factors(const T* pc, const T* pr, const T* dw, T* fw, T* uw, int p, int bn,
                                              int rowbase, int colbase, int gcol0, int lane) {
  const T* W = dw;
  const T* Lo = dw + 64;
  const T* IP = dw + 128;
  for (int rr = lane; rr < L::WROWS; rr += 32) {
    const int r = rowbase + rr, i = r - p;
    const bool in_panel = i >= 0 && i < PANEL;
    T f[PANEL];
#pragma unroll
    for (int j = 0; j < PANEL; ++j) {
      T acc = in_panel ? W[i * 8 + j] : pc[r * FS + j];
#pragma unroll
      for (int jj = 0; jj < j; ++jj) acc = fmadd(-f[jj], W[jj * 8 + j], acc);
      f[j] = j < bn ? acc : T(0);
    }
#pragma unroll
    for (int j = 0; j < PANEL; ++j) fw[rr * FS + j] = f[j];
  }
  for (int cc = lane; cc < L::WCOLS; cc += 32) {
    const bool live = gcol0 + cc >= p + bn;  // right of the panel's pivots
    T u[PANEL];
#pragma unroll
    for (int j = 0; j < PANEL; ++j) {
      T acc = pr[j * L::US + colbase + cc];
#pragma unroll
      for (int jj = 0; jj < j; ++jj) acc = fmadd(-Lo[j * 8 + jj], u[jj], acc);
      u[j] = live ? acc * IP[j] : T(0);
    }
#pragma unroll
    for (int j = 0; j < PANEL; ++j) uw[j * L::UWS + cc] = u[j];
  }
}

// X -= F U on the warp's register tile; the panel's rows start from U (a
// column left of the panel's last pivot has U = 0 and stays as it is).
template <typename T, typename L>
__device__ __forceinline__ void rank8_update(T (&m)[L::WR][L::WC][2], const T* fw, const T* uw, int p, int bn,
                                             int rowbase, int g, int q) {
#pragma unroll
  for (int a = 0; a < L::WR; ++a)
    if (rowbase + 8 * a == p)
#pragma unroll
      for (int b = 0; b < L::WC; ++b)
#pragma unroll
        for (int e = 0; e < 2; ++e) m[a][b][e] = uw[g * L::UWS + 8 * b + 2 * q + e];
  if constexpr (sizeof(T) == 8) {
#pragma unroll
    for (int s = 0; s < PANEL / 4; ++s) {
      T af[L::WR], bf[L::WC];
#pragma unroll
      for (int a = 0; a < L::WR; ++a) af[a] = -fw[(8 * a + g) * FS + 4 * s + q];
#pragma unroll
      for (int b = 0; b < L::WC; ++b) bf[b] = uw[(4 * s + q) * L::UWS + 8 * b + g];
#pragma unroll
      for (int b = 0; b < L::WC; ++b)
#pragma unroll
        for (int a = 0; a < L::WR; ++a) dmma(m[a][b][0], m[a][b][1], af[a], bf[b]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < PANEL; ++j) {
      if (j < bn) {
        T f[L::WR];
#pragma unroll
        for (int a = 0; a < L::WR; ++a) f[a] = fw[(8 * a + g) * FS + j];
#pragma unroll
        for (int b = 0; b < L::WC; ++b) {
          const float2 u = *reinterpret_cast<const float2*>(uw + j * L::UWS + 8 * b + 2 * q);
#pragma unroll
          for (int a = 0; a < L::WR; ++a) {
            m[a][b][0] = fmadd(-f[a], u.x, m[a][b][0]);
            m[a][b][1] = fmadd(-f[a], u.y, m[a][b][1]);
          }
        }
      }
    }
  }
}

template <typename T, typename L>
__global__ void __launch_bounds__(L::THREADS, min_blocks<T, L>())
    gj_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ X, int batch, int n, int k, int cs) {
  extern __shared__ __align__(16) unsigned char gj_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ws = warp % L::WARPS, slot = warp / L::WARPS;
  const int g = lane >> 2, q = lane & 3;
  if (cs > 1) cluster_arrive_relaxed();  // waited for after the loads
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long sys = L::SPC == 1 ? (long long)(blockIdx.x / cs) : (long long)blockIdx.x * L::SPC + slot;
  const bool valid = sys < batch;
  const int W = n + k;
  const int rowbase = (ws / L::WGC) * L::WROWS;
  const int colbase = (ws % L::WGC) * L::WCOLS;  // in this CTA's columns
  const int gcol0 = rank * L::COLS + colbase;    // in the system's
  T* PC = reinterpret_cast<T*>(gj_smem) + slot * L::SYS_SZ;
  T* DW = PC + 2 * L::PC_SZ;
  T* PR = DW + 2 * L::DW_SZ;
  T* fw = PR + 2 * L::PR_SZ + ws * (L::FW_SZ + L::UW_SZ);
  T* uw = fw + L::FW_SZ;

  T m[L::WR][L::WC][2];
  const T* As = A + (valid ? sys : 0) * (long long)n * n;
  const T* Bs = B + (valid ? sys : 0) * (long long)n * k;
#pragma unroll
  for (int a = 0; a < L::WR; ++a) {
    const int r = rowbase + 8 * a + g;
#pragma unroll
    for (int b = 0; b < L::WC; ++b)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = gcol0 + 8 * b + 2 * q + e;
        T v = T(0);
        if (valid && r < n && c < W) v = c < n ? As[(long long)r * n + c] : Bs[(long long)r * k + (c - n)];
        m[a][b][e] = v;
      }
  }
  if (cs > 1) cluster_wait();
  publish<T, L>(m, PC, DW, PR, 0, n, rank, cs, rowbase, colbase, g, q, lane);
  const int panels = (n + PANEL - 1) / PANEL;
  for (int P = 0; P < panels; ++P) {
    if (cs > 1)
      cluster_barrier();
    else if constexpr (L::WARPS == 1)
      __syncwarp();  // a system per warp
    else
      __syncthreads();
    const int p = P * PANEL, bn = min(PANEL, n - p);
    if (gcol0 + L::WCOLS <= p + bn) continue;  // every column of this warp is eliminated
    const int cur = P & 1, nxt = cur ^ 1;
    panel_factors<T, L>(PC + cur * L::PC_SZ, PR + cur * L::PR_SZ, DW + cur * L::DW_SZ, fw, uw, p, bn, rowbase,
                        colbase, gcol0, lane);
    __syncwarp();
    rank8_update<T, L>(m, fw, uw, p, bn, rowbase, g, q);
    if (P + 1 < panels)
      publish<T, L>(m, PC + nxt * L::PC_SZ, DW + nxt * L::DW_SZ, PR + nxt * L::PR_SZ, p + PANEL, n, rank, cs,
                    rowbase, colbase, g, q, lane);
  }
  if (cs > 1) cluster_barrier();  // no CTA leaves while another may store into it
  if (!valid) return;
  T* Xs = X + sys * (long long)n * k;
#pragma unroll
  for (int a = 0; a < L::WR; ++a) {
    const int r = rowbase + 8 * a + g;
#pragma unroll
    for (int b = 0; b < L::WC; ++b)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = gcol0 + 8 * b + 2 * q + e;
        if (r < n && c >= n && c < W) Xs[(long long)r * k + (c - n)] = m[a][b][e];
      }
  }
}

// ------------------------------------------------------------------ host
enum Kind { KIND_S40 = 0, KIND_L64 = 1, KIND_T64 = 2 };

// the CTA shape and the CTAs per system (cluster size); false if n, k are not taken
template <typename T>
bool choose(int n, int k, int* kind, int* cs) {
  const int W = n + k;
  if (n <= S40<T>::ROWS && W <= S40<T>::COLS) {
    *kind = KIND_S40;
    *cs = 1;
    return true;
  }
  if (n > T64::ROWS || W > MAX_CLUSTER * L64::COLS) return false;
  *kind = n <= L64::ROWS ? KIND_L64 : KIND_T64;
  *cs = (W + L64::COLS - 1) / L64::COLS;
  return true;
}

template <typename T, typename L>
size_t smem_bytes() { return (size_t)L::SYS_SZ * L::SPC * sizeof(T); }

template <typename T, typename L>
cudaError_t prepare() {
  static bool done[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(gj_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<T, L>());
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return err;
}

template <typename L>
long long grid_size(int batch, int cs) {
  return L::SPC == 1 ? (long long)batch * cs : ((long long)batch + L::SPC - 1) / L::SPC;
}

template <typename T, typename L>
cudaLaunchConfig_t launch_config(int batch, int cs, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid_size<L>(batch, cs));
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = smem_bytes<T, L>();
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return cfg;
}

template <typename T, typename L>
int launch_tile(const T* A, const T* B, T* X, int batch, int n, int k, int cs, cudaStream_t stream) {
  cudaError_t err = prepare<T, L>();
  if (err != cudaSuccess) return (int)err;
  if (grid_size<L>(batch, cs) > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<T, L>(batch, cs, stream, attr);
  err = cudaLaunchKernelEx(&cfg, gj_kernel<T, L>, A, B, X, batch, n, k, cs);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch(const void* A, const void* B, void* X, int batch, int n, int k, void* stream) {
  if (batch <= 0 || k <= 0 || n <= 0) return 0;
  int kind = 0, cs = 1;
  if (!choose<T>(n, k, &kind, &cs)) return (int)cudaErrorInvalidValue;
  const T *a = (const T*)A, *b = (const T*)B;
  T* x = (T*)X;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == KIND_S40) return launch_tile<T, S40<T>>(a, b, x, batch, n, k, cs, st);
  if (kind == KIND_L64) return launch_tile<T, L64>(a, b, x, batch, n, k, cs, st);
  return launch_tile<T, T64>(a, b, x, batch, n, k, cs, st);
}

// out: kind, CTAs per system, systems per CTA, threads per CTA, CTAs, shared
// bytes per CTA, resident CTAs per SM, co-resident clusters on the device (0
// without a cluster), registers per thread, local (spill) bytes per thread,
// panels, rows, columns per CTA
template <typename T, typename L>
int describe_tile(int kind, int batch, int n, int cs, long long* out) {
  cudaError_t err = prepare<T, L>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, gj_kernel<T, L>);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gj_kernel<T, L>, L::THREADS, smem_bytes<T, L>());
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  if (cs > 1) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config<T, L>(batch, cs, 0, attr);
    err = cudaOccupancyMaxActiveClusters(&clusters, gj_kernel<T, L>, &cfg);
    if (err != cudaSuccess) return (int)err;
  }
  const long long v[13] = {kind, cs, L::SPC, L::THREADS, grid_size<L>(batch, cs), (long long)smem_bytes<T, L>(),
                           per_sm, clusters, fa.numRegs, (long long)fa.localSizeBytes, (n + PANEL - 1) / PANEL,
                           L::ROWS, L::COLS};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}

template <typename T>
int describe(int batch, int n, int k, long long* out) {
  int kind = 0, cs = 1;
  if (batch <= 0 || n <= 0 || k <= 0 || !choose<T>(n, k, &kind, &cs)) return (int)cudaErrorInvalidValue;
  if (kind == KIND_S40) return describe_tile<T, S40<T>>(kind, batch, n, cs, out);
  if (kind == KIND_L64) return describe_tile<T, L64>(kind, batch, n, cs, out);
  return describe_tile<T, T64>(kind, batch, n, cs, out);
}

}  // namespace

// the launch's shape for (batch, n, k) in float32 (4) or float64 (8), 13
// values into out (see describe_tile), or a CUDA error
extern "C" int gauss_jordan_config(int dtype_bytes, int batch, int n, int k, long long* out) {
  return dtype_bytes == 4 ? describe<float>(batch, n, k, out) : describe<double>(batch, n, k, out);
}

// the largest n and n + k the kernel takes, into out[0], out[1]
extern "C" void gauss_jordan_limits(long long* out) {
  out[0] = T64::ROWS;
  out[1] = MAX_CLUSTER * L64::COLS;
}

#define GJ_ENTRY(NAME, T)                                                                          \
  extern "C" int NAME(const void* A, const void* B, void* X, int batch, int n, int k, void* stream) { \
    return launch<T>(A, B, X, batch, n, k, stream);                                                \
  }

GJ_ENTRY(gauss_jordan_f32, float)
GJ_ENTRY(gauss_jordan_f64, double)
