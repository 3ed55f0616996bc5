// Batched Cholesky of small SPD tiles (n <= 128), float32, for Hopper (sm_90a).
//
// What it replaces: the Pallas kernel `_diag_kernel` of the JAX package's
// ops/chol_blocked.py, launched by its `chol_diag128` (the pallas_call at line
// 116).  That kernel factors a (B, 128, 128) batch held in TPU VMEM, vectorized
// over the batch, in 128 masked column steps; matrices with n < 128 are padded
// with identity first.  This kernel computes the same factor without the
// padding: one CTA per matrix holds its n x n tile in dynamic shared memory
// (n * (n + 1) floats, 66 KB at n = 128, so the block's dynamic shared-memory
// limit is raised to that once per device), and for each column j
//   1. every thread reads the pivot d = A[j][j] and takes rsqrtf(d)
//      (d <= 0 gives an inf or NaN that runs through the rest of the factor,
//      which is how the caller's regularization ladder sees a failure),
//   2. the column below the diagonal is scaled into a shared vector,
//   3. all threads apply the rank-1 update to the trailing LOWER triangle,
// with a barrier after steps 2 and 3.  The output is L with an exact-zero
// strict upper triangle.  Products and differences use the _rn intrinsics so
// that nvcc does not contract them into FMAs: the factor then rounds like the
// plain PyTorch version (ops/chol_blocked.py chol_tile_plain) and the JAX
// kernel, which round the product and the difference separately.  No tensor
// cores and no TF32 anywhere.
//
// What bounds it on an H100: latency, not FLOPs or bytes.  A factor is n
// dependent column steps, each ending in a block-wide barrier; at n = 96 that
// is ~30 kFLOP per step for 256 threads.  The slice's batch of 32 fills only
// 32 of the 132 SMs.  The shared tile is padded to a row stride of n + 1 so
// the column reads of step 2 hit 32 different banks.  Making it fast (several
// matrices per CTA, warp-level column steps, fusing the triangular inverse)
// is left to later work.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 256;
constexpr int kMaxSmem = (kMaxN * (kMaxN + 1) + kMaxN) * sizeof(float);
constexpr int kMaxDevices = 64;

// Whether the kernel's shared-memory limit was raised on each device.
std::atomic<bool> g_smem_raised[kMaxDevices];

__global__ void __launch_bounds__(kThreads)
chol_tile_kernel(const float* __restrict__ in, float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* A = smem;             // n rows of stride ld; only the lower part is used
  float* col = smem + n * ld;  // the scaled pivot column
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  const float* src = in + off;
  float* dst = out + off;
  const int tid = threadIdx.x;

  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n;
    A[i * ld + (e - i * n)] = src[e];
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const float inv_s = rsqrtf(A[j * ld + j]);
    for (int i = j + tid; i < n; i += kThreads) {
      col[i] = __fmul_rn(A[i * ld + j], inv_s);
    }
    __syncthreads();
    for (int i = j + tid; i < n; i += kThreads) {
      A[i * ld + j] = col[i];
    }
    const int r = n - j - 1;  // trailing size
    for (int e = tid; e < r * r; e += kThreads) {
      const int ii = e / r;
      const int kk = e - ii * r;
      if (kk <= ii) {
        const int i = j + 1 + ii;
        const int k = j + 1 + kk;
        A[i * ld + k] = __fsub_rn(A[i * ld + k], __fmul_rn(col[i], col[k]));
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n;
    const int k = e - i * n;
    dst[e] = (k <= i) ? A[i * ld + k] : 0.0f;
  }
}

}  // namespace

// Factor `batch` contiguous row-major float32 n x n matrices from `in` into
// `out` on `stream`.  Returns the CUDA error code of the launch (0 = success).
extern "C" int sqp_chol_tile_f32(const void* in, void* out, int batch, int n,
                                 void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (dev >= kMaxDevices || !g_smem_raised[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(chol_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (dev < kMaxDevices) {
      g_smem_raised[dev].store(true, std::memory_order_release);
    }
  }
  const int smem = static_cast<int>((n * (n + 1) + n) * sizeof(float));
  chol_tile_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Human-readable name of a CUDA error code, for the Python wrapper's message.
extern "C" const char* sqp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
