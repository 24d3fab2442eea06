// Constrained Riccati backward sweep + forward rollout, one CTA per scenario,
// with the stage shapes compiled in (RICCATI_NX, RICCATI_NU, RICCATI_NE).
//
// Replaces the TPU kernels of bipedal_control_tpu/ops/pallas_riccati.py:
// _backward_kernel (:72, K2) and _forward_kernel (:206, K3), reached through
// riccati_backward_pallas / riccati_solve_pallas (and their prelaned
// entries).  Stage math is that of solver/riccati.py::_stage_kkt and
// riccati_plain:
//
//   H_xx = Qxx + A'SA,  H_uu = Quu + B'SB,  H_ux = Qux + B'SA,
//   h_x = qx + A'(S c + s),  h_u = qu + B'(S c + s)
//   [H_uu + r I  D' | H_ux  h_u]      pivot-free Gauss-Jordan (quasi-definite)
//   [D       -Reg  | C     e  ]  ->  K, k
//   U = H_xx + K'H_uu K - K'H_ux - H_ux'K,  S = (U + U')/2,  s = ...
//   forward: du = -K dx - k,  dx' = A dx + B du + c
//
// Bound.  At B = 256, N = 67 (nx = nu = 22, ne = 16) the sweep needs 5.26 G
// operations and 259 MB of traffic: 0.079 ms at the card's float32 rate (at
// G1's shapes, nx = nu = 24, and B = 4096: 1.57 ms).  At B = 1 the time is one
// CTA's serial chain of 67 stages, each a run of barrier-separated steps of a
// few hundred operations per thread: latency, so the design shortens each
// step rather than adding parallelism.  At large B it is the SM's issue slots
// and shared-memory accesses, shared by the chains resident on it, which run
// in waves.
//
// Two builds of one kernel, riccati_kernel<T, NTH>: NTH = 256 or 128 threads
// per scenario, with the same tiles as wide as NTH threads need (Tiles<NTH>),
// so every output element gets the same operations in the same order and the
// two give the same bits.  At G1's shapes in float32 the 256-thread build
// holds 2 CTAs per SM (16 warps) and takes the shorter chain alone (B = 1:
// 0.77 ms on an H100); the 128-thread build holds 4 (16 warps; 55,984 B of
// shared memory a CTA, at most 128 registers a thread as the launch bound
// asks), so that four independent chains, not two, share each SM: at B = 4096, 8
// waves of 528 in place of 16 of 264 (its chain alone: 0.84 ms).  Its stage
// loop is unrolled only in part (Tiles::kPivotUnroll, kDotUnroll): four CTAs
// at different points of the fully unrolled loop outrun the instruction
// cache.  ops/riccati_kernel.py picks the build per launch from the CUDA
// occupancy query.  The 128-thread build is compiled in float32 only
// (kWideBuild): in float64 a 128-thread CTA would hold no more per SM than a
// 256-thread one (2, by shared memory), so the 256-thread build serves every
// float64 batch.
//
// Design (one CTA per scenario).
// - Shapes are compile-time: every loop has constant bounds, every thread has a
//   fixed (row, column) tile, dot products of length NX or NU are unrolled (in
//   part at 128 threads), and
//   no index inside the stage or rollout loops is divided by a runtime value.
// - Small products are register-tiled: a thread owns 2 rows x a few columns of
//   its output and reuses each operand it reads from shared memory across the
//   tile (P = S [B | A | c] + [0 | 0 | s] is 253 tiles of 2 x 2 at H1's shapes).
//   H_uu, H_ux and h_u are written straight into their blocks of the
//   augmented KKT in shared memory, beside the stage's D', D, C, e and -Reg.
// - The elimination is register-resident: thread (cg, rg) loads rows 2rg,
//   2rg+1 x columns CT cg .. CT cg + CT-1 of the NKP x W augmented matrix (2 x 6
//   at H1's shapes, 209 threads, column-group major so that whole warps fall
//   idle as their columns are eliminated) and keeps them in registers through
//   all NKP pivots, taken in order without pivoting as solver/riccati.py's
//   plain version takes them: aug -= (col_i - e_i) (row_i / piv_i).  Two pivots
//   go per barrier: only the pair's two rows and two columns, as they stand
//   before the first, and the pair's two reciprocals go through
//   double-buffered shared buffers, and every thread brings the second pivot's
//   row and column through the first itself, in the same operations as their
//   owners, so a pair is exactly two single pivots (19 barriers at H1's shapes
//   instead of 38).  Each pivot's reciprocal is taken once, by the thread that
//   holds the pair's 2 x 2 block, and every update multiplies by it, as the TPU
//   kernel multiplies by 1 / piv (pallas_riccati.py:179).  The 256-thread
//   build does not update eliminated columns; the 128-thread build updates
//   them too (their values are never read again), which saves a test per
//   column.  Why pairs, and not a 2 x 2 block inverse: the stage KKT
//   of a redundant contact set is near-singular (condition ~1e9 with
//   dual_eps), and an explicit 2 x 2 inverse there cancels catastrophically
//   where two successive pivots do not.
// - Stage inputs are prefetched: once stage t's K is out, lane 0 of the last
//   warp starts bulk copies (cp.async.bulk completing on an mbarrier) of stage
//   t-1's pieces whose size is a multiple of 16 bytes into the other half of a
//   double-buffered stage area, and the warp copies the other pieces (in
//   float32 c, qx, qu: 88 B) with element-sized cp.async; meanwhile the other
//   warps compute G and H_xx, in which, at 256 threads, the last warp has no
//   tile (at G1's shapes in float32 every piece is a bulk copy, so the warp
//   spends a few instructions on the copies before its tile).  The rollout
//   keeps the inputs of RD - 1 steps in flight (A, B, K, c, k; RD = 4
//   sub-slots laid over the stage area), started by the same warp, which the
//   rollout leaves idle.
// - S is kept unsymmetrized (U, with s as its last column) and symmetrized as
//   P's product reads it, which saves a pass and a barrier.
// - H_xx | h_x lives in U's storage (Smem::Hxx), which takes the 128-thread
//   build under the 56 KB a CTA that four CTAs per SM allow: U's last read is
//   P's product at the stage's start, H_xx is written after K, and U's
//   product reads each element of H_xx in the thread that then writes the
//   same element of U.
// - Shared-memory accesses are the chain's cost, so two neighbouring elements
//   at an even index go as one access wherever a thread reads or writes such a
//   pair (pivot rows, the 2-row tiles' operand pairs); the working arrays'
//   row strides are padded to even for it.
// Barriers per stage: NKP / 2 + 5 (24 at H1's shapes): after P, after the H
// blocks, after the KKT load, NKP / 2 - 1 pivot pairs, after K, after H_xx and
// H_uu K - H_ux, after U.  The rollout takes 2 per step.
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(RICCATI_NX) || !defined(RICCATI_NU) || !defined(RICCATI_NE)
#error "compile with RICCATI_NX, RICCATI_NU and RICCATI_NE defined (ops/riccati_kernel.py::build)"
#endif

namespace {

constexpr int NX = RICCATI_NX, NU = RICCATI_NU, NE = RICCATI_NE;
constexpr int NK = NU + NE;         // KKT rows
constexpr int NKP = 2 * ((NK + 1) / 2);  // KKT rows padded to whole pivot pairs (an identity row if odd)
constexpr int W = NKP + NX + 1;     // augmented columns: KKT | state | rhs
constexpr int NXP = NX + 1;         // [state | rhs]: columns of K|k, U|s, H_xx|h_x, H_ux|h_u
constexpr int LDP = NU + NX + 1;    // columns of P = S [B | A | c]
// even row strides of the NXP- and LDP-wide working arrays, so that a pair of
// neighbouring columns at an even index is one aligned shared-memory access
constexpr int LDX = NXP + (NXP & 1);
constexpr int LDPP = LDP + (LDP & 1);

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// columns per thread so that 2-row tiles of a rows x cols output fit in n threads
__host__ __device__ constexpr int tile_cols(int rows, int cols, int n) {
  int c = 1;
  while (cdiv(rows, 2) * cdiv(cols, c) > n) ++c;
  return c;
}
// elimination tile: 2 x c, c even so a pivot pair's columns share a tile
__host__ __device__ constexpr int elim_cols(int n) {
  int c = 2;
  while (cdiv(NKP, 2) * cdiv(W, c) > n) c += 2;
  return c;
}
// G = H_uu [K|k] - [H_ux|h_u] and [H_xx|h_x] side by side in n threads
__host__ __device__ constexpr int g_cols(int n) {
  int c = 1;
  while (cdiv(NU, 2) * cdiv(NXP, c) + cdiv(NX, 2) * cdiv(NXP, c) > n) ++c;
  return c;
}

// The thread -> tile maps of one block size NTH: the same tiles as wide as
// NTH threads need, so each output element gets the same operations in the
// same order in every build.
template <int NTH>
struct Tiles {
  static constexpr int CT = elim_cols(NTH);
  static constexpr int CG = cdiv(W, CT);
  static constexpr int WP = CT * CG;  // pivot row length, padded to whole tiles
  static constexpr int P2_CT = tile_cols(NU, LDP, NTH);  // [H_uu | H_ux | h_u]
  static constexpr int P2_CG = cdiv(LDP, P2_CT);
  static constexpr int P1_CT = tile_cols(NX, LDP, NTH);
  static constexpr int P1_CG = cdiv(LDP, P1_CT);
  static constexpr int P4_CT = g_cols(NTH);
  static constexpr int P4_CG = cdiv(NXP, P4_CT);
  static constexpr int P4_NA = cdiv(NU, 2) * P4_CG;  // threads of G; the next ones take H_xx
  static constexpr int P5_CT = tile_cols(NX, NXP, NTH);
  static constexpr int P5_CG = cdiv(NXP, P5_CT);
  // The warp that starts the asynchronous copies: the last, which the
  // rollout (max(NX, NU) threads) leaves idle, and at 256 threads the phase
  // after K too (176 threads at H1's shapes)
  static constexpr int kCopyWarp = NTH / 32 - 1;
  // Unrolling of the pivot-pair loop and of the products' k loops, and
  // whether a tile skips its eliminated columns: at 256 threads the whole
  // stage unrolled, for the shortest chain alone; at 128 threads the four
  // CTAs of an SM run different parts of the stage loop at once, and the
  // loop fully unrolled (~134 KB of code at G1's shapes) outruns the
  // instruction cache, so it is unrolled in part, and a tile updates its
  // eliminated columns too (never read again) rather than test each column
  static constexpr int kPivotUnroll = NTH == 256 ? NKP / 2 : 2;
  static constexpr int kDotUnroll = NTH == 256 ? (NX > NU ? NX : NU) : 8;
  static constexpr bool kSkipEliminated = NTH == 256;
  static_assert(NTH % 32 == 0, "whole warps");
  static_assert(CT <= 2048 / NTH && P1_CT <= 2048 / NTH && P2_CT <= 2048 / NTH && P4_CT <= 2048 / NTH &&
                    P5_CT <= 2048 / NTH,
                "stage shapes too large for this block size");
  static_assert(NX <= NTH && NU <= NTH, "rollout takes one thread per row");
};

// --- the stage area: pieces of one stage, each at a 16-byte aligned offset
enum Piece { kA, kB, kQxx, kQuu, kQux, kC, kD, kE, kMask, kc, kqx, kqu, kPieces };
__host__ __device__ constexpr int piece_elems(int p) {
  return p == kA || p == kQxx ? NX * NX : p == kB ? NX * NU : p == kQuu ? NU * NU : p == kQux ? NU * NX
       : p == kC ? NE * NX : p == kD ? NE * NU : p == kE || p == kMask ? NE : p == kqu ? NU : NX;
}
template <typename T> __host__ __device__ constexpr int padded(int n) {
  return cdiv(n * (int)sizeof(T), 16) * (16 / (int)sizeof(T));
}
template <typename T> __host__ __device__ constexpr bool is_bulk(int p) { return piece_elems(p) * sizeof(T) % 16 == 0; }
template <typename T> __host__ __device__ constexpr int piece_off(int p) {
  int o = 0;
  for (int q = 0; q < p; ++q) o += padded<T>(piece_elems(q));
  return o;
}

// --- working set after the two stage slots (offsets in elements)
template <typename T> constexpr int kSlot = piece_off<T>(kPieces);
template <typename T, int NTH> struct Smem {
  static constexpr int WP = Tiles<NTH>::WP;
  static constexpr int slot = kSlot<T>;
  static constexpr int U = 2 * slot;                          // NX x NXP (stride LDX): unsymmetrized S | s
  // H_xx | h_x in U's storage (Design, above); a tile of U's product whose
  // padding columns are clamped reads column NX, which the same tile holds
  static constexpr int Hxx = U;
  static constexpr int P = U + padded<T>(NX * LDX);           // NX x LDP (stride LDPP): S B | S A | S c + s
  static constexpr int Aug = P + padded<T>(NX * LDPP);        // NKP x WP: the augmented KKT (H_uu unregularized)
  static constexpr int Kx = Aug + padded<T>(NKP * WP);        // NU x NXP (stride LDX): K | k
  static constexpr int G = Kx + padded<T>(NU * LDX);          // NU x NXP (stride LDX): H_uu [K|k] - [H_ux|h_u]
  static constexpr int row = G + padded<T>(NU * LDX);         // 2 x 2 x WP: the pivot pair's rows
  static constexpr int col = row + padded<T>(4 * WP);         // 2 x NKP x 2: the pivot pair's columns
  static constexpr int rinv = col + padded<T>(4 * NKP);       // 2 x 2: the pivots' reciprocals
  static constexpr int dx = rinv + padded<T>(4);              // 2 x NX: rollout state
  static constexpr int du = dx + padded<T>(2 * NX);           // NU
  static constexpr int total = du + padded<T>(NU);
  static constexpr size_t bytes = (size_t)total * sizeof(T) + 64;  // + the mbarriers
};

// CTAs per SM the build is compiled for: as many as 128 registers a thread
// allow (2 of 256 threads, 4 of 128), or as many as the SM's 233,472 B of
// shared memory hold at 1 KB reserved per CTA, if fewer (then its registers
// are not cut to 128)
template <typename T, int NTH> __host__ __device__ constexpr int min_blocks() {
  const int by_regs = 65536 / (128 * NTH);
  const int by_smem = (int)(233472 / (Smem<T, NTH>::bytes + 1024));
  return by_smem < 1 ? 1 : by_smem < by_regs ? by_smem : by_regs;
}

// The rollout's step inputs A, B, K, c, k, in a ring of RD sub-slots laid
// over the two stage slots (K in Qux's shape, k in qu's)
template <typename T> __host__ __device__ constexpr int roll_off(int q) {  // A, B, K, c, k
  return (q > 0 ? padded<T>(NX * NX) : 0) + (q > 1 ? padded<T>(NX * NU) : 0) + (q > 2 ? padded<T>(NU * NX) : 0) +
         (q > 3 ? padded<T>(NX) : 0) + (q > 4 ? padded<T>(NU) : 0);
}
template <typename T> constexpr int kRollFit = 2 * kSlot<T> / roll_off<T>(5);  // sub-slots that fit
template <typename T> constexpr int RD = kRollFit<T> < 4 ? kRollFit<T> : 4;

// --- asynchronous copies and barriers (PTX)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// spins until the phase completes; a copy that never lands traps (~2 s)
// rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const long long t0 = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(BYTES) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait_group() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
// order this thread's generic-proxy global writes before later bulk (async-proxy) reads
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// 1/x rounded to nearest, without the general division's slow path
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }
// two neighbouring elements at an even index, in one shared-memory access
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };
template <typename T>
__device__ __forceinline__ void load2(const T* p, T& a, T& b) {
  const typename Pair<T>::type x = *reinterpret_cast<const typename Pair<T>::type*>(p);
  a = x.x, b = x.y;
}
// p[0], p[1]: one access where the caller knows p is pair-aligned, else two
template <bool Aligned, typename T>
__device__ __forceinline__ void load_pair(const T* p, T& a, T& b) {
  if constexpr (Aligned) load2(p, a, b);
  else a = p[0], b = p[1];
}
template <typename T>
__device__ __forceinline__ void store2(T* p, T a, T b) {
  typename Pair<T>::type x;
  x.x = a, x.y = b;
  *reinterpret_cast<typename Pair<T>::type*>(p) = x;
}

// Copy stage st of the listed pieces to slot + offs[q]: lane 0 of the copy
// warp arms the mbarrier with the bulk copies' bytes and starts them; the
// warp copies the pieces that are not a multiple of 16 bytes element by
// element (cp.async) and commits them as one group, empty when !active.
template <typename T, int NTH, int NP>
__device__ __forceinline__ void start_copies(T* slot, const int (&pieces)[NP], const int (&offs)[NP],
                                             const T* const (&src)[NP], size_t st, uint64_t* bar, bool active) {
  const int lane = threadIdx.x - 32 * Tiles<NTH>::kCopyWarp;
  if (lane == 0 && active) {
    uint32_t bytes = 0;
#pragma unroll
    for (int q = 0; q < NP; ++q)
      if (is_bulk<T>(pieces[q])) bytes += piece_elems(pieces[q]) * sizeof(T);
    mbar_expect(bar, bytes);
#pragma unroll
    for (int q = 0; q < NP; ++q)
      if (is_bulk<T>(pieces[q]))
        bulk_copy(slot + offs[q], src[q] + st * piece_elems(pieces[q]), piece_elems(pieces[q]) * sizeof(T), bar);
  }
  if (lane >= 0 && lane < 32) {
    if (active) {
#pragma unroll
      for (int q = 0; q < NP; ++q)
        if (!is_bulk<T>(pieces[q])) {
          const int n = piece_elems(pieces[q]);
          for (int i = lane; i < n; i += 32) cp_async<sizeof(T)>(slot + offs[q] + i, src[q] + st * n + i);
        }
    }
    cp_async_commit();
  }
}

template <typename T>
struct StageInputs {
  const T* p[kPieces];  // A, B, Qxx, Quu, Qux, C, D, e, mask, c, qx, qu: (Bn, N, ...) each
};

template <typename T, int NTH>
__global__ void __launch_bounds__(NTH, min_blocks<T, NTH>())
    riccati_kernel(const StageInputs<T> in, const T* __restrict__ dx0, T* __restrict__ Kout, T* __restrict__ kout,
                   T* __restrict__ dxout, T* __restrict__ duout, int N, T dual_eps, T huu_reg) {
  using L = Smem<T, NTH>;
  using TL = Tiles<NTH>;
  constexpr int CT = TL::CT, CG = TL::CG, WP = TL::WP, P1_CT = TL::P1_CT, P1_CG = TL::P1_CG, P2_CT = TL::P2_CT,
                P2_CG = TL::P2_CG, P4_CT = TL::P4_CT, P4_CG = TL::P4_CG, P4_NA = TL::P4_NA, P5_CT = TL::P5_CT,
                P5_CG = TL::P5_CG, kCopyWarp = TL::kCopyWarp, kPivotUnroll = TL::kPivotUnroll,
                kDotUnroll = TL::kDotUnroll;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + (size_t)L::total * sizeof(T));
  T* const U = sm + L::U;
  T* const P = sm + L::P;
  T* const Aug = sm + L::Aug;  // row stride WP; H_uu and [H_ux | h_u] are its blocks
  T* const Huu = Aug;
  T* const Hux = Aug + NKP;
  T* const Hxx = sm + L::Hxx;
  T* const Kx = sm + L::Kx;
  T* const G = sm + L::G;
  T* const rowb = sm + L::row;
  T* const colb = sm + L::col;
  T* const rinvb = sm + L::rinv;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t sb = (size_t)b * N;

  // fixed thread -> tile maps (divisions by compile-time constants, once)
  const bool el_on = tid < NKP / 2 * CG;
  // column-group major, so that whole warps fall idle as columns are eliminated
  const int er0 = 2 * (tid % (NKP / 2)), ec0 = CT * (tid / (NKP / 2));
  const bool p1_on = tid < cdiv(NX, 2) * P1_CG;
  const int p1r = 2 * (tid / P1_CG), p1c = P1_CT * (tid % P1_CG);
  const bool p2_on = tid < cdiv(NU, 2) * P2_CG;
  const int p2r = 2 * (tid / P2_CG), p2c = P2_CT * (tid % P2_CG);
  const bool p4a_on = tid < P4_NA;
  const bool p4b_on = !p4a_on && tid < P4_NA + cdiv(NX, 2) * P4_CG;
  const int p4t = p4a_on ? tid : tid - P4_NA;
  const int p4r = 2 * (p4t / P4_CG), p4c = P4_CT * (p4t % P4_CG);
  const bool p5_on = tid < cdiv(NX, 2) * P5_CG;
  const int p5r = 2 * (tid / P5_CG), p5c = P5_CT * (tid % P5_CG);

  // P's column j reads [B | A | c] from the slot at xoff + k * xstr
  int xoff[P1_CT], xstr[P1_CT];
#pragma unroll
  for (int j = 0; j < P1_CT; ++j) {
    const int c = p1c + j;
    if (c < NU) xoff[j] = piece_off<T>(kB) + c, xstr[j] = NU;
    else if (c < NU + NX) xoff[j] = piece_off<T>(kA) + c - NU, xstr[j] = NX;
    else xoff[j] = piece_off<T>(kc), xstr[j] = 1;  // c, or padding (not stored)
  }
  T v[2][CT];  // this thread's tile of the augmented KKT
  // hand pivots q, q+1 to the block through shared buffer `buf`: their rows
  // and columns as they stand before pivot q, and both reciprocals, taken
  // once by the thread that holds the 2 x 2 block (the tile's copies of
  // eliminated columns go along unread)
  auto hand_off = [&](int q, int buf) {
    if (er0 == q) {
#pragma unroll
      for (int j = 0; j < CT; j += 2) {
        store2(rowb + (2 * buf) * WP + ec0 + j, v[0][j], v[0][j + 1]);
        store2(rowb + (2 * buf + 1) * WP + ec0 + j, v[1][j], v[1][j + 1]);
      }
    }
    const int jn = q - ec0;
    if (jn >= 0 && jn < CT) {
      T c00 = v[0][0], c01 = v[0][1], c10 = v[1][0], c11 = v[1][1];
#pragma unroll
      for (int j = 2; j < CT; j += 2)
        if (jn == j) c00 = v[0][j], c01 = v[0][j + 1], c10 = v[1][j], c11 = v[1][j + 1];
      T* cb = colb + (buf * NKP + er0) * 2;
      cb[0] = c00, cb[1] = c01, cb[2] = c10, cb[3] = c11;
      if (er0 == q) {  // pivot q+1 as pivot q leaves it, exactly as its owner will update it
        const T r0 = rcp(c00);
        rinvb[2 * buf] = r0;
        rinvb[2 * buf + 1] = rcp(fma(-c10, c01 * r0, c11));
      }
    }
  };

  for (int i = tid; i < NX * LDX; i += NTH) U[i] = T(0);
  // the KKT's blocks that no stage writes: the -Reg block off its diagonal,
  // the padding, and the padding row's identity pivot when NK is odd
  for (int i = tid; i < NKP * WP; i += NTH) Aug[i] = i == NK * WP + NK ? T(1) : T(0);
  if (tid == 0) {
    for (int q = 0; q < 2 + RD<T>; ++q) mbar_init(&bars[q]);
    mbar_fence_init();
  }
  __syncthreads();

  constexpr int stage_pieces[kPieces] = {kA, kB, kQxx, kQuu, kQux, kC, kD, kE, kMask, kc, kqx, kqu};
  constexpr int stage_offs[kPieces] = {piece_off<T>(kA), piece_off<T>(kB), piece_off<T>(kQxx), piece_off<T>(kQuu),
                                       piece_off<T>(kQux), piece_off<T>(kC), piece_off<T>(kD), piece_off<T>(kE),
                                       piece_off<T>(kMask), piece_off<T>(kc), piece_off<T>(kqx), piece_off<T>(kqu)};
  start_copies<T, NTH>(sm, stage_pieces, stage_offs, in.p, sb + N - 1, &bars[0], true);
  if (tid / 32 == kCopyWarp) cp_async_wait_all();
  __syncthreads();

  for (int it = 0; it < N; ++it) {
    const int t = N - 1 - it;
    const size_t st = sb + t;
    T* const cur = sm + (it & 1) * L::slot;
    mbar_wait(&bars[it & 1], (it >> 1) & 1);

    // the stage's constraint blocks into the KKT: D' | D, C, e, -Reg's diagonal
    {
      const T* Ds = cur + piece_off<T>(kD);
      const T* Cs = cur + piece_off<T>(kC);
      for (int i = tid; i < NE * NU; i += NTH) {
        const int q = i / NU, c = i % NU;  // compile-time divisor
        Aug[(NU + q) * WP + c] = Ds[i];
        Aug[c * WP + NU + q] = Ds[i];
      }
      for (int i = tid; i < NE * NX; i += NTH) {
        const int q = i / NX, c = i % NX;
        Aug[(NU + q) * WP + NKP + c] = Cs[i];
      }
      if (tid < NE) {
        const T m = cur[piece_off<T>(kMask) + tid];
        Aug[(NU + tid) * WP + NU + tid] = -(m * dual_eps + (T(1) - m));
        Aug[(NU + tid) * WP + NKP + NX] = cur[piece_off<T>(kE) + tid];
      }
    }
    // P = S [B | A | c] + [0 | 0 | s],  S = (U + U')/2
    if (p1_on) {
      T acc[2][P1_CT];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < P1_CT; ++j) acc[a][j] = T(0);
      const int r0 = p1r, r1 = p1r + 1 < NX ? p1r + 1 : NX - 1;
#pragma unroll(kDotUnroll)
      for (int k = 0; k < NX; ++k) {
        T u0, u1;  // U[k][r0], U[k][r0 + 1] (a padding column when r0 + 1 == NX)
        load2(U + k * LDX + r0, u0, u1);
        const T s0 = T(0.5) * (U[r0 * LDX + k] + u0);
        const T s1 = T(0.5) * (U[r1 * LDX + k] + u1);
#pragma unroll
        for (int j = 0; j < P1_CT; ++j) {
          const T x = cur[xoff[j] + k * xstr[j]];
          acc[0][j] += s0 * x;
          acc[1][j] += s1 * x;
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < P1_CT; ++j) {
          const int r = p1r + a, c = p1c + j;
          if (r < NX && c < LDP) P[r * LDPP + c] = c == NU + NX ? acc[a][j] + U[r * LDX + NX] : acc[a][j];
        }
    }
    __syncthreads();

    // [H_uu | H_ux | h_u] = [Quu | Qux | qu] + B' [S B | S A | S c + s]
    if (p2_on) {
      const T* Bs = cur + piece_off<T>(kB);
      const int r0 = p2r;
      int cc[P2_CT];
#pragma unroll
      for (int j = 0; j < P2_CT; ++j) cc[j] = p2c + j < LDP ? p2c + j : LDP - 1;
      T acc[2][P2_CT];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < P2_CT; ++j) acc[a][j] = T(0);
#pragma unroll(kDotUnroll)
      for (int k = 0; k < NX; ++k) {
        T b0, b1;  // B[k][r0], B[k][r0 + 1] (rows past NU are never stored)
        load_pair<NU % 2 == 0>(Bs + k * NU + r0, b0, b1);
        T x[P2_CT];
#pragma unroll
        for (int j = 0; j + 1 < P2_CT; j += 2) load_pair<P2_CT % 2 == 0>(P + k * LDPP + p2c + j, x[j], x[j + 1]);
        if (P2_CT % 2) x[P2_CT - 1] = P[k * LDPP + cc[P2_CT - 1]];
#pragma unroll
        for (int j = 0; j < P2_CT; ++j) {
          acc[0][j] += b0 * x[j];
          acc[1][j] += b1 * x[j];
        }
      }
      const T* Quu = cur + piece_off<T>(kQuu);
      const T* Qux = cur + piece_off<T>(kQux);
      const T* qu = cur + piece_off<T>(kqu);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < P2_CT; ++j) {
          const int r = p2r + a, c = p2c + j;
          if (r < NU && c < LDP) {
            if (c < NU) Huu[r * WP + c] = Quu[r * NU + c] + acc[a][j];
            else Hux[r * WP + c - NU] = (c < NU + NX ? Qux[r * NX + c - NU] : qu[r]) + acc[a][j];
          }
        }
    }
    __syncthreads();

    // the augmented KKT [H_uu + r I, D' | H_ux, h_u ; D, -Reg | C, e], built
    // into this thread's registers
    if (el_on) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int r = er0 + a, c = ec0 + j;
          v[a][j] = Aug[r * WP + c] + (r == c && r < NU ? huu_reg : T(0));
        }
      hand_off(0, 0);
    }
    __syncthreads();

    // pivot-free Gauss-Jordan, aug -= (col_i - e_i) (row_i / piv_i) for pivots
    // i = 0 .. NKP-1 in order, two pivots per barrier: every thread brings
    // pivot p+1's row and column through pivot p itself from the buffers
    // (p+1's row: R1 - C_p[p+1] n0, its column: C1 - e0 n0[p+1]), in the same
    // operations as their owners, so the pair is exactly two single pivots
#pragma unroll(kPivotUnroll)
    for (int p = 0; p < NKP; p += 2) {
      const int cb = (p >> 1) & 1;
      if (el_on && ec0 + CT > p + 2) {  // tiles of eliminated columns are done
        const T* R0 = rowb + (2 * cb) * WP;
        const T* R1 = R0 + WP;
        const T* Cc = colb + cb * NKP * 2;
        const T rinv0 = rinvb[2 * cb], rinv1 = rinvb[2 * cb + 1];
        const T cp1 = Cc[2 * (p + 1)];     // aug[p+1][p]
        const T np1 = R0[p + 1] * rinv0;  // row p / piv_p at column p+1
        T e0[2], e1[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int r = er0 + a;
          e0[a] = Cc[2 * r] - (r == p ? T(1) : T(0));
          e1[a] = fma(-e0[a], np1, Cc[2 * r + 1]) - (r == p + 1 ? T(1) : T(0));
        }
        T x0[CT], x1[CT];
#pragma unroll
        for (int j = 0; j < CT; j += 2) {
          load2(R0 + ec0 + j, x0[j], x0[j + 1]);
          load2(R1 + ec0 + j, x1[j], x1[j + 1]);
        }
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const T n0 = x0[j] * rinv0;
          const T n1 = fma(-cp1, n0, x1[j]) * rinv1;
          if (!TL::kSkipEliminated || ec0 + j >= p + 2) {
#pragma unroll
            for (int a = 0; a < 2; ++a) v[a][j] = fma(-e1[a], n1, fma(-e0[a], n0, v[a][j]));
          }
        }
        if (p + 2 < NKP) hand_off(p + 2, cb ^ 1);
      }
      if (p + 2 < NKP) __syncthreads();
    }

    // K | k: the solution columns of the first NU rows
    if (el_on) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int r = er0 + a, c = ec0 + j;
          if (r < NU && c >= NKP && c < W) {
            Kx[r * LDX + c - NKP] = v[a][j];
            if (c < NKP + NX) Kout[st * (NU * NX) + r * NX + c - NKP] = v[a][j];
            else kout[st * NU + r] = v[a][j];
          }
        }
    }
    __syncthreads();

    // stage t-1's inputs, started by the copy warp while the others compute G and H_xx
    if (it + 1 < N)
      start_copies<T, NTH>(sm + ((it + 1) & 1) * L::slot, stage_pieces, stage_offs, in.p, st - 1,
                           &bars[(it + 1) & 1], true);

    // G = H_uu [K | k] - [H_ux | h_u]  beside  [H_xx | h_x] = [Qxx | qx] + A' [S A | S c + s]
    if (p4a_on || p4b_on) {
      const int nr = p4a_on ? NU : NX;
      const int r0 = p4r, r1 = p4r + 1 < nr ? p4r + 1 : nr - 1;
      T acc[2][P4_CT];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < P4_CT; ++j) acc[a][j] = T(0);
      int cc[P4_CT];
#pragma unroll
      for (int j = 0; j < P4_CT; ++j) cc[j] = p4c + j < NXP ? p4c + j : NX;
      if (p4a_on) {
#pragma unroll(kDotUnroll)
        for (int k = 0; k < NU; ++k) {
          const T h0 = Huu[r0 * WP + k], h1 = Huu[r1 * WP + k];
#pragma unroll
          for (int j = 0; j < P4_CT; ++j) {
            const T x = Kx[k * LDX + cc[j]];
            acc[0][j] += h0 * x;
            acc[1][j] += h1 * x;
          }
        }
      } else {
        const T* As = cur + piece_off<T>(kA);
#pragma unroll(kDotUnroll)
        for (int k = 0; k < NX; ++k) {
          T a0, a1;  // A[k][r0], A[k][r0 + 1]
          load_pair<NX % 2 == 0>(As + k * NX + r0, a0, a1);
#pragma unroll
          for (int j = 0; j < P4_CT; ++j) {
            const T x = P[k * LDPP + NU + cc[j]];
            acc[0][j] += a0 * x;
            acc[1][j] += a1 * x;
          }
        }
      }
      const T* Qxx = cur + piece_off<T>(kQxx);
      const T* qx = cur + piece_off<T>(kqx);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < P4_CT; ++j) {
          const int r = p4r + a, c = p4c + j;
          if (r < nr && c < NXP) {
            if (p4a_on) G[r * LDX + c] = acc[a][j] - Hux[r * WP + c];
            else Hxx[r * LDX + c] = (c < NX ? Qxx[r * NX + c] : qx[r]) + acc[a][j];
          }
        }
    }
    __syncthreads();

    // U = [H_xx | h_x] + K' G - H_ux' [K | k]  (the last column is s)
    if (p5_on) {
      const int r0 = p5r, r1 = p5r + 1 < NX ? p5r + 1 : NX - 1;
      int cc[P5_CT];
#pragma unroll
      for (int j = 0; j < P5_CT; ++j) cc[j] = p5c + j < NXP ? p5c + j : NX;
      T acc[2][P5_CT];
#pragma unroll
      for (int j = 0; j < P5_CT; ++j) acc[0][j] = Hxx[r0 * LDX + cc[j]], acc[1][j] = Hxx[r1 * LDX + cc[j]];
#pragma unroll(kDotUnroll)
      for (int k = 0; k < NU; ++k) {
        T k0, k1, h0, h1;  // K[k][r0], K[k][r0 + 1], H_ux[k][r0], H_ux[k][r0 + 1]
        load2(Kx + k * LDX + r0, k0, k1);
        load2(Hux + k * WP + r0, h0, h1);
#pragma unroll
        for (int j = 0; j < P5_CT; ++j) {
          const T g = G[k * LDX + cc[j]], kj = Kx[k * LDX + cc[j]];
          acc[0][j] += k0 * g - h0 * kj;
          acc[1][j] += k1 * g - h1 * kj;
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < P5_CT; ++j) {
          const int r = p5r + a, c = p5c + j;
          if (r < NX && c < NXP) U[r * LDX + c] = acc[a][j];
        }
    }
    if (tid / 32 == kCopyWarp) cp_async_wait_all();
    __syncthreads();
  }

  // forward rollout (K3): du = -K dx - k, dx' = A dx + B du + c, with the
  // inputs of steps t+1 .. t+RD-1 in flight while step t computes
  fence_proxy_async();  // K, k were written by this block: order them before the bulk reads
  __syncthreads();
  constexpr int R = RD<T>;
  static_assert(R >= 2, "the rollout ring needs two sub-slots");
  constexpr int roll_pieces[5] = {kA, kB, kQux, kc, kqu};
  constexpr int roll_offs[5] = {roll_off<T>(0), roll_off<T>(1), roll_off<T>(2), roll_off<T>(3), roll_off<T>(4)};
  const T* const roll_src[5] = {in.p[kA], in.p[kB], Kout, in.p[kc], kout};
  uint64_t* const rbars = bars + 2;
#pragma unroll
  for (int q = 0; q < R - 1; ++q)
    start_copies<T, NTH>(sm + q * roll_off<T>(5), roll_pieces, roll_offs, roll_src, sb + q, &rbars[q], q < N);
  T* const dxs = sm + L::dx;
  T* const dus = sm + L::du;
  T* const dxo = dxout + (size_t)b * (N + 1) * NX;
  if (tid < NX) {
    dxs[tid] = dx0[(size_t)b * NX + tid];
    dxo[tid] = dxs[tid];
  }
  if (tid / 32 == kCopyWarp) cp_async_wait_group<R - 2>();
  __syncthreads();
  for (int t = 0; t < N; ++t) {
    const size_t st = sb + t;
    const int q = t % R, qn = (t + R - 1) % R;  // compile-time divisor
    T* const cur = sm + q * roll_off<T>(5);
    start_copies<T, NTH>(sm + qn * roll_off<T>(5), roll_pieces, roll_offs, roll_src, st + R - 1, &rbars[qn],
                         t + R - 1 < N);
    mbar_wait(&rbars[q], (t / R) & 1);
    const T* x = dxs + (t & 1) * NX;
    T* xn = dxs + ((t + 1) & 1) * NX;
    if (tid < NU) {
      const T* Kt = cur + roll_off<T>(2);
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += Kt[tid * NX + j] * x[j];
      const T d = -acc - cur[roll_off<T>(4) + tid];
      dus[tid] = d;
      duout[st * NU + tid] = d;
    }
    __syncthreads();
    if (tid < NX) {
      const T* At = cur + roll_off<T>(0);
      const T* Bt = cur + roll_off<T>(1);
      T acc = T(0), acc2 = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += At[tid * NX + j] * x[j];
#pragma unroll
      for (int a = 0; a < NU; ++a) acc2 += Bt[tid * NU + a] * dus[a];
      const T d = acc + acc2 + cur[roll_off<T>(3) + tid];
      xn[tid] = d;
      dxo[(size_t)(t + 1) * NX + tid] = d;
    }
    if (tid / 32 == kCopyWarp) cp_async_wait_group<R - 2>();  // step t+1's element copies
    __syncthreads();
  }
}

// The 128-thread build exists in float32 only (the header's second paragraph)
template <typename T> constexpr bool kWideBuild = sizeof(T) == 4;

template <typename T, int NTH>
int launch_build(const StageInputs<T>& in, const void* dx0, void* K, void* k, void* dx, void* du, int Bn, int N,
                 double dual_eps, double huu_reg, void* stream) {
  const size_t smem = Smem<T, NTH>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(riccati_kernel<T, NTH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  riccati_kernel<T, NTH><<<Bn, NTH, smem, (cudaStream_t)stream>>>(in, (const T*)dx0, (T*)K, (T*)k, (T*)dx, (T*)du,
                                                                   N, (T)dual_eps, (T)huu_reg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* ins, const void* dx0, void* K, void* k, void* dx, void* du, int Bn, int N,
           double dual_eps, double huu_reg, int threads, void* stream) {
  StageInputs<T> in;
  for (int p = 0; p < kPieces; ++p) in.p[p] = static_cast<const T*>(ins[p]);
  if (threads == 256) return launch_build<T, 256>(in, dx0, K, k, dx, du, Bn, N, dual_eps, huu_reg, stream);
  if constexpr (kWideBuild<T>)
    if (threads == 128) return launch_build<T, 128>(in, dx0, K, k, dx, du, Bn, N, dual_eps, huu_reg, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int NTH>
int occupancy() {
  const size_t smem = Smem<T, NTH>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(riccati_kernel<T, NTH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, riccati_kernel<T, NTH>, NTH, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// Inputs in the order A, B, Qxx, Quu, Qux, C, D, e, mask, c, qx, qu, each
// (Bn, N, ...) contiguous and 16-byte aligned; the shapes are the compiled
// ones; threads is the build: 256 or 128 threads per scenario.
#define RICCATI_ENTRY(NAME, T)                                                                                \
  extern "C" int NAME(const void* const* ins, const void* dx0, void* K, void* k, void* dx, void* du, int Bn, \
                      int N, double dual_eps, double huu_reg, int threads, void* stream) {                   \
    return launch<T>(ins, dx0, K, k, dx, du, Bn, N, dual_eps, huu_reg, threads, stream);                     \
  }

RICCATI_ENTRY(riccati_solve_f32, float)
RICCATI_ENTRY(riccati_solve_f64, double)

// shared bytes per CTA of the float32 (f64 = 0) or float64 build of `threads`, 0 for no such build
extern "C" int riccati_smem_bytes(int f64, int threads) {
  if (threads == 256) return (int)(f64 ? Smem<double, 256>::bytes : Smem<float, 256>::bytes);
  if (threads == 128) return f64 ? 0 : (int)Smem<float, 128>::bytes;
  return 0;
}
extern "C" int riccati_block_threads(int threads) { return threads == 256 || threads == 128 ? threads : 0; }
// resident CTAs per SM of the float32 (4) or float64 (8) build of `threads`,
// 0 for no such build (float64 at 128 threads), or -(CUDA error)
extern "C" int riccati_blocks_per_sm(int dtype_bytes, int threads) {
  if (threads == 256) return dtype_bytes == 4 ? occupancy<float, 256>() : occupancy<double, 256>();
  if (threads == 128) return dtype_bytes == 4 ? occupancy<float, 128>() : 0;
  return -(int)cudaErrorInvalidValue;
}
