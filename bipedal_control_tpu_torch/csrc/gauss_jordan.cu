// Batched pivot-free Gauss-Jordan solve A X = B, one thread block per system.
//
// Replaces the TPU kernel _gj_kernel of bipedal_control_tpu/ops/pallas_gj.py
// (pallas_call in gauss_jordan_solve_pallas).  The TPU kernel padded each
// augmented system to (8, 128) tiles, eliminated a tile of systems in VMEM
// and picked pivot rows and columns with one-hot masked reductions (Mosaic
// refused unaligned dynamic slices).  Here a block loads one system's
// augmented n x (n + k) matrix into shared memory, runs the elimination of
// gauss_jordan.cuh (the same one riccati.cu runs on the stage KKT: pivot
// row and column double-buffered, one __syncthreads() per pivot) and writes
// the last k columns.  No padding: every block is a real system.
//
// Bound: bytes, nearly balanced.  Each system moves (n^2 + 2 n k) values
// through device memory once and does 3 flops (divide, multiply, subtract)
// per updated element, n per column right of each pivot; at the stage-KKT
// shape (n = 38, k = 23) that is ~14 flops per byte in float32,
// just under the card's float32 flop-to-byte ratio (~20).  In practice the
// n pivots, each ending in a barrier, set the time.
#include <cuda_runtime.h>

#include "gauss_jordan.cuh"

namespace {

template <typename T>
__global__ void gj_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ X, int n, int k) {
  extern __shared__ __align__(16) unsigned char gj_smem[];
  T* aug = reinterpret_cast<T*>(gj_smem);
  const int W = n + k;
  T* rowb = aug + n * W;  // 2*W   pivot row, double-buffered
  T* colb = rowb + 2 * W; // 2*n   pivot column, double-buffered
  const size_t sys = blockIdx.x;
  const T* As = A + sys * n * n;
  const T* Bs = B + sys * n * k;
  for (int idx = threadIdx.x; idx < n * W; idx += blockDim.x) {
    const int r = idx / W, c = idx % W;
    const T v = c < n ? As[r * n + c] : Bs[r * k + (c - n)];
    aug[idx] = v;
    if (r == 0) rowb[c] = v;
    if (c == 0) colb[r] = v;
  }
  __syncthreads();
  gauss_jordan_eliminate(aug, rowb, colb, n, W);
  T* Xs = X + sys * n * k;
  for (int idx = threadIdx.x; idx < n * k; idx += blockDim.x) {
    const int r = idx / k, c = idx % k;
    Xs[idx] = aug[r * W + n + c];
  }
}

template <typename T>
size_t smem_bytes(int n, int k) {
  return ((size_t)n * (n + k) + 2 * (size_t)(n + k) + 2 * (size_t)n) * sizeof(T);
}

template <typename T>
int launch(const void* A, const void* B, void* X, int batch, int n, int k, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem = smem_bytes<T>(n, k);
  cudaError_t err = cudaFuncSetAttribute(gj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gj_kernel<T><<<batch, 256, smem, (cudaStream_t)stream>>>((const T*)A, (const T*)B, (T*)X, n, k);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int n, int k) {
  const size_t smem = smem_bytes<T>(n, k);
  cudaError_t err = cudaFuncSetAttribute(gj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int b = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, gj_kernel<T>, 256, smem);
  return err == cudaSuccess ? b : -(int)err;
}

}  // namespace

extern "C" int gauss_jordan_block_threads() { return 256; }
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
