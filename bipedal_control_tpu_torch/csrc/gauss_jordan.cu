// K5: batched pivot-free Gauss-Jordan solve A X = B of quasi-definite systems.
//
// Replaces the TPU kernel _gj_kernel of bipedal_control_tpu/ops/pallas_gj.py
// (pallas_call in gauss_jordan_solve_pallas).  The TPU kernel padded each
// augmented system to (8, 128) tiles, eliminated a tile of systems in VMEM
// and picked pivot rows and columns with one-hot masked reductions.  Its
// caller here is the device WBC's QP (wbc/qp.py): the inverse of its
// (128 x 128) KKT at G1's widths, B = eye(128), one system per controller
// tick and 256 under wbc_update_batch.
//
// Layout: one thread block per (system, tile of GJ_COL_TILE right-hand-side
// columns).  The block loads the system's n x n matrix and its column tile
// into shared memory as one augmented n x (n + tile) matrix, eliminates it
// and writes its tile of X.  Tiling the columns is what lets a float64
// (128 | 128) system run at all: the whole augmented matrix would take
// 268,288 B of shared memory, over the 227 KB a block may have; a tile of
// 32 takes 168,448 B.  It also gives a single system four blocks.  The
// price is that every tile repeats the elimination of A's n x n part.
//
// Elimination: for each pivot i, aug -= (aug[:, i] - e_i) (aug[i, :] / aug[i, i])
// on the columns right of i (the columns left of it are never read again).
// Lanes of a warp take neighbouring columns (conflict-free shared-memory
// rows), warps take rows; each lane divides its column's pivot-row entry
// once per pivot.  The pivot row and column of step i + 1 are written to
// double buffers as step i produces them, so each pivot costs one
// __syncthreads().
//
// Bound: operations.  A system moves (n^2 + 2 n k) values through device
// memory once and needs about 2 n^2 (n + 2k) / 2 flops: at (128 | 128) that
// is ~64 flops per byte in float32, above the card's float32 flop-to-byte
// ratio (~20).  In practice the n pivots, each ending in a barrier, and the
// tiles' repeated elimination of A set the time.
#include <cuda_runtime.h>

#define GJ_COL_TILE 32
#define GJ_WARPS 8

namespace {

__host__ __device__ inline int col_tile(int k) { return k < GJ_COL_TILE ? k : GJ_COL_TILE; }

template <typename T>
__global__ void __launch_bounds__(32 * GJ_WARPS)
    gj_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ X, int n, int k) {
  extern __shared__ __align__(16) unsigned char gj_smem[];
  const int kt = col_tile(k);
  const int tiles = (k + kt - 1) / kt;
  const size_t sys = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * kt;
  const int kw = min(kt, k - c0);  // this tile's columns
  const int W = n + kw;
  T* aug = reinterpret_cast<T*>(gj_smem);
  T* rowb = aug + n * W;   // 2*W   pivot row, double-buffered
  T* colb = rowb + 2 * W;  // 2*n   pivot column, double-buffered
  const T* As = A + sys * n * n;
  const T* Bs = B + sys * n * k + c0;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int idx = tid; idx < n * W; idx += 32 * GJ_WARPS) {
    const int r = idx / W, c = idx % W;
    const T v = c < n ? As[r * n + c] : Bs[r * k + (c - n)];
    aug[idx] = v;
    if (r == 0) rowb[c] = v;
    if (c == 0) colb[r] = v;
  }
  __syncthreads();
  const int lane = threadIdx.x, warp = threadIdx.y;
  for (int i = 0; i < n; ++i) {
    const T* row = rowb + (i & 1) * W;
    const T* colv = colb + (i & 1) * n;
    T* nrow = rowb + ((i + 1) & 1) * W;
    T* ncol = colb + ((i + 1) & 1) * n;
    const T piv = row[i];
    for (int c = i + 1 + lane; c < W; c += 32) {
      const T norm = row[c] / piv;
      for (int r = warp; r < n; r += GJ_WARPS) {
        const T f = colv[r] - (r == i ? T(1) : T(0));
        const T v = aug[r * W + c] - f * norm;
        aug[r * W + c] = v;
        if (c == i + 1) ncol[r] = v;
        if (r == i + 1) nrow[c] = v;
      }
    }
    __syncthreads();
  }
  T* Xs = X + sys * n * k + c0;
  for (int idx = tid; idx < n * kw; idx += 32 * GJ_WARPS) {
    const int r = idx / kw, c = idx % kw;
    Xs[r * k + c] = aug[r * W + n + c];
  }
}

template <typename T>
size_t smem_bytes(int n, int k) {
  const size_t W = (size_t)n + col_tile(k);
  return ((size_t)n * W + 2 * W + 2 * (size_t)n) * sizeof(T);
}

template <typename T>
int launch(const void* A, const void* B, void* X, int batch, int n, int k, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const size_t smem = smem_bytes<T>(n, k);
  cudaError_t err = cudaFuncSetAttribute(gj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int kt = col_tile(k);
  const long long blocks = (long long)batch * ((k + kt - 1) / kt);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  gj_kernel<T><<<(unsigned)blocks, dim3(32, GJ_WARPS), smem, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)B, (T*)X, n, k);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int n, int k) {
  const size_t smem = smem_bytes<T>(n, k);
  cudaError_t err = cudaFuncSetAttribute(gj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int b = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, gj_kernel<T>, 32 * GJ_WARPS, smem);
  return err == cudaSuccess ? b : -(int)err;
}

}  // namespace

extern "C" int gauss_jordan_block_threads() { return 32 * GJ_WARPS; }
// right-hand-side columns per block for k columns (blocks per system: ceil(k / tile))
extern "C" int gauss_jordan_col_tile(int k) { return col_tile(k); }
// resident blocks per SM for n x (n | k) systems in float32 (4) or float64 (8), or -(CUDA error)
extern "C" int gauss_jordan_blocks_per_sm(int dtype_bytes, int n, int k) {
  return dtype_bytes == 4 ? blocks_per_sm<float>(n, k) : blocks_per_sm<double>(n, k);
}

#define GJ_ENTRY(NAME, T)                                                                          \
  extern "C" int NAME(const void* A, const void* B, void* X, int batch, int n, int k, void* stream) { \
    return launch<T>(A, B, X, batch, n, k, stream);                                                \
  }

GJ_ENTRY(gauss_jordan_f32, float)
GJ_ENTRY(gauss_jordan_f64, double)
