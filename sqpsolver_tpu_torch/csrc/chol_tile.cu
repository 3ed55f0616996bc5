// Batched Cholesky of small SPD tiles (n <= 128), float32, for Hopper (sm_90a).
//
// What it replaces: the Pallas kernel `_diag_kernel` of the JAX package's
// ops/chol_blocked.py, launched by its `chol_diag128` (the pallas_call at line
// 116).  That kernel factors a (B, 128, 128) batch held in TPU VMEM, vectorized
// over the batch, in 128 masked one-hot column steps; matrices with n < 128 are
// padded with identity first.  This kernel computes the same function without
// the padding: the lower factor L of each n x n tile, rsqrt pivots (a pivot
// d <= 0 gives an inf or NaN that runs through the rest of that tile's factor,
// which is how the caller's regularization ladder sees a failure), an
// exact-zero strict upper triangle.  Only the lower triangle of the input is
// used.
//
// What bounds it on an H100.  By the roofline it is bytes: B*n*n*4 read and as
// many written against B*n^3/3 operations, 0.4 us at (32,72,72) and 0.7 us at
// (32,96,96) at 3.35 TB/s.  That figure is out of reach of any factorization:
// the n column steps depend on each other, and each step is a chain of a
// shared-memory store, a block barrier, a shared-memory load, an rsqrt and one
// multiply-subtract, that no amount of parallel hardware shortens.  So the
// floor is n such chains, a few us, and the design is about keeping
// everything else off that chain (measured on an NVIDIA H100 80GB HBM3 at
// 700 W: 0.13 us per column at n = 96, the launch included).  A batch of 32
// tiles fills 32 of the 132 SMs; one tile is not split across SMs.
//
// The design, one CTA of 256 threads per tile:
//   * The tile lives in registers.  The threads form a 16 x 16 grid; thread
//     (ty, tx) owns the elements (i, k) with i mod 16 == ty and k mod 16 == tx
//     of the lower block triangle, r[a][b] = A[ty + 16a][tx + 16b], b <= a: at
//     most 36 registers at n = 128.  The kernel is a template on T =
//     ceil(n / 16) and the column loop is unrolled over block columns, so every
//     register index is a compile-time constant.  The 2-D cyclic ownership
//     keeps all 256 threads busy while the trailing matrix shrinks, and the
//     upper block triangle is neither held nor computed.  (A tile kept in
//     shared memory instead costs up to 66 KB and one shared read-modify-write
//     per update.)
//   * One barrier per column.  The 16 threads that own column j store its RAW
//     values (pivot included) to a 128-float shared vector; after the barrier
//     every thread reads the pivot, takes rsqrtf itself and scales the <= 8 row
//     values and <= 8 column values it needs: ~16 shared loads for <= 36
//     updates.  Scaling the same value by the same factor gives the same bits
//     in every thread, so nobody waits for a scaled column.  The vector is
//     double-buffered on the parity of j: the writers of column j + 1 need not
//     wait for the readers of column j, and the barrier of step j + 1 orders
//     the readers of j before the writers of j + 2.  (Publishing the scaled
//     column instead takes a second barrier per column.)  Factoring a panel
//     of 2, 4 or 8 columns between two barriers, every thread redoing the
//     panel for its own rows and columns, was tried
//     on the card and was no faster at 2 and slower at 4 and 8: the step is
//     bound as much by the instructions the 8 warps execute as by the barrier's
//     round trip, and the panel trades one for the other.
//   * No division or modulo anywhere in the kernel: ty and tx are a shift and
//     a mask, block indices are compile-time, addresses are i * n + k.
//   * Global accesses: all of a thread's loads are started up front and are
//     independent.  With the cyclic ownership a warp touches two runs of 16
//     consecutive floats (64 bytes) per instruction, so the 32-byte sectors
//     it moves are used in full where n is a multiple of 8 (72, 96 and 128
//     are); float4 would need a thread to own four neighbouring columns, which
//     the cyclic ownership rules out, and would move the same sectors.  Only
//     the lower block triangle is read.
//   * ~1 KB of static shared memory, so no cudaFuncSetAttribute and several
//     CTAs fit on an SM at large batches.
//
// No tensor cores, on purpose: the factor must be true float32.  TF32 keeps
// ten mantissa bits and ruins the factor that seeds the mixed-precision
// refinement, and wgmma has no float32 input type.  A 3xTF32 split of rank-16
// panel updates would be possible, but these tiles are bound by the latency
// chain above, not by their 3-10 MFLOP.
//
// Rounding: products and differences use the _rn intrinsics so that nvcc does
// not contract them into FMAs, and each element has its rank-1 terms
// subtracted in ascending column order.  Every element then sees the same
// operations in the same order as in the plain PyTorch version
// (ops/chol_blocked.py chol_tile_plain) and in the JAX kernel, which round the
// product and the difference separately.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kGridLog2 = 4;
constexpr int kGrid = 1 << kGridLog2;    // the threads form a kGrid x kGrid grid
constexpr int kThreads = kGrid * kGrid;  // 256
constexpr int kMaxT = kMaxN / kGrid;     // block rows/columns of a tile at most

// The column steps of block column JB (j = 16 JB + jt), then those of the
// block columns after it.  JB is a template parameter so that r[a][JB] names
// a register.
template <int T, int JB>
__device__ __forceinline__ void column_steps(float (&r)[T][T], float (*raw)[kMaxN],
                                             const int n, const int ty, const int tx) {
  if constexpr (JB < T) {
    const int j0 = JB * kGrid;
    const int jt_end = min(kGrid, n - j0);
#pragma unroll 2
    for (int jt = 0; jt < jt_end; ++jt) {
      const int j = j0 + jt;
      float* buf = raw[j & 1];
      if (tx == jt) {  // the owners of column j publish its raw values
#pragma unroll
        for (int a = JB; a < T; ++a) {
          buf[ty + a * kGrid] = r[a][JB];
        }
      }
      __syncthreads();
      const float inv_s = rsqrtf(buf[j]);
      float li[T];  // L[i][j] for this thread's rows
      float lk[T];  // L[k][j] for this thread's columns
#pragma unroll
      for (int a = JB; a < T; ++a) {
        li[a] = __fmul_rn(buf[ty + a * kGrid], inv_s);
        lk[a] = __fmul_rn(buf[tx + a * kGrid], inv_s);
      }
      // In block row / block column JB only rows and columns beyond j take
      // part; every later block does.
      const bool row_in = ty > jt;
      const bool col_in = tx > jt;
#pragma unroll
      for (int a = JB; a < T; ++a) {
#pragma unroll
        for (int b = JB; b <= a; ++b) {
          if ((a > JB || row_in) && (b > JB || col_in)) {
            r[a][b] = __fsub_rn(r[a][b], __fmul_rn(li[a], lk[b]));
          }
        }
      }
      if (tx == jt) {  // column j of the factor, diagonal included
#pragma unroll
        for (int a = JB; a < T; ++a) {
          if (a > JB || ty >= jt) {
            r[a][JB] = li[a];
          }
        }
      }
    }
    column_steps<T, JB + 1>(r, raw, n, ty, tx);
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads)
chol_tile_kernel(const float* __restrict__ in, float* __restrict__ out, const int n) {
  __shared__ float raw[2][kMaxN];
  const int tx = threadIdx.x & (kGrid - 1);
  const int ty = threadIdx.x >> kGridLog2;
  const size_t first = static_cast<size_t>(blockIdx.x) * n * n + ty * n + tx;
  const float* src = in + first;   // element (ty, tx) of this CTA's tile
  float* dst = out + first;
  const int block_row = kGrid * n;  // 16 rows down

  float r[T][T] = {};  // only b <= a is ever live
#pragma unroll
  for (int a = 0; a < T; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      if (ty + a * kGrid < n && tx + b * kGrid < n) {
        r[a][b] = src[a * block_row + b * kGrid];
      }
    }
  }

  column_steps<T, 0>(r, raw, n, ty, tx);

#pragma unroll
  for (int a = 0; a < T; ++a) {
#pragma unroll
    for (int b = 0; b < T; ++b) {
      const int i = ty + a * kGrid;
      const int k = tx + b * kGrid;
      if (i < n && k < n) {
        float v = 0.0f;
        if (b <= a) {
          v = (k <= i) ? r[a][b] : 0.0f;
        }
        dst[a * block_row + b * kGrid] = v;
      }
    }
  }
}

template <int T>
cudaError_t launch(const float* in, float* out, int batch, int n, cudaStream_t stream) {
  chol_tile_kernel<T><<<batch, kThreads, 0, stream>>>(in, out, n);
  return cudaGetLastError();
}

}  // namespace

// Factor `batch` contiguous row-major float32 n x n matrices from `in` into
// `out` on `stream`.  Returns the CUDA error code of the launch (0 = success).
extern "C" int sqp_chol_tile_f32(const void* in, void* out, int batch, int n,
                                 void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(kMaxT == 8, "the dispatch below lists T = 1..8");
  cudaError_t err = cudaErrorInvalidValue;
  switch ((n + kGrid - 1) / kGrid) {
    case 1: err = launch<1>(src, dst, batch, n, s); break;
    case 2: err = launch<2>(src, dst, batch, n, s); break;
    case 3: err = launch<3>(src, dst, batch, n, s); break;
    case 4: err = launch<4>(src, dst, batch, n, s); break;
    case 5: err = launch<5>(src, dst, batch, n, s); break;
    case 6: err = launch<6>(src, dst, batch, n, s); break;
    case 7: err = launch<7>(src, dst, batch, n, s); break;
    case 8: err = launch<8>(src, dst, batch, n, s); break;
  }
  return static_cast<int>(err);
}

// Human-readable name of a CUDA error code, for the Python wrapper's message.
extern "C" const char* sqp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
