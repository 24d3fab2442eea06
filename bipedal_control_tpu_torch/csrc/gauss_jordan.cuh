// Pivot-free Gauss-Jordan elimination by one thread block on an augmented
// matrix in shared memory (ops/linalg.py gauss_jordan_solve):
//   for each pivot i:  aug -= (aug[:, i] - e_i) (aug[i, :] / aug[i, i])
// Safe without pivoting for the quasi-definite systems the solver builds.
//
// K5's alone (gauss_jordan.cu): riccati.cu keeps its stage KKT in registers
// and takes two pivots per barrier.
//
// aug is rows x W, row-major; pivots run over i = 0..rows-1.  Column i of
// aug is not updated by pivot i (only columns i+1.. are read afterwards).
// The pivot row and column of step i are read from double buffers that
// step i-1 fills as it produces them, so each pivot costs one
// __syncthreads().  On entry rowb[0..W) must hold row 0 and colb[0..rows)
// column 0, and the block must be synchronised.
#pragma once

template <typename T>
__device__ void gauss_jordan_eliminate(T* aug, T* rowb, T* colb, int rows, int W) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = 0; i < rows; ++i) {
    const T* row = rowb + (i & 1) * W;
    const T* colv = colb + (i & 1) * rows;
    T* nrow = rowb + ((i + 1) & 1) * W;
    T* ncol = colb + ((i + 1) & 1) * rows;
    const T piv = row[i];
    const int wc = W - i - 1;  // columns i+1..W-1 (eliminated ones stay unit)
    for (int idx = tid; idx < rows * wc; idx += nth) {
      const int r = idx / wc, col = i + 1 + idx % wc;
      const T norm = row[col] / piv;
      const T f = colv[r] - (r == i ? T(1) : T(0));
      const T v = aug[r * W + col] - f * norm;
      aug[r * W + col] = v;
      if (col == i + 1) ncol[r] = v;
      if (r == i + 1) nrow[col] = v;
    }
    __syncthreads();
  }
}
