// ldl_block: pivot-free LDL^T of a batch of symmetric (NB, NB) f32 blocks,
// NB <= 64: the diagonal-block factor of the polish's blocked LDL^T.
//
// Replaces allocnet_tpu/ops/ldl.py:37 `_ldl_unblocked`, a lax.fori_loop
// over the block's columns inside each jitted solve and tick.  It has no
// Pallas kernel; the eager port ran the loop as ~15 elementwise launches
// per column (~960 per 64-column block, 4 blocks per polish factorization
// at the deploy point, 7 at ten segments).  This kernel factors a block in
// one launch.  For column j = 0 .. NB-1 (ops/ldl.ldl_block_reference):
//
//   dj   = |K[j,j]| >= reg ? K[j,j] : sign[j] * reg     (bump small pivots)
//   l_i  = K[i,j] / dj                  for i > j       (column j of L)
//   K[i,k] -= (dj * l_i) * l_k          for j < k <= i  (trailing update)
//
// then L = the strict lower triangle with a unit diagonal, d = diag(K).
// d keeps each pivot's unbumped value: the bumped dj is never written back
// to K[j,j], as in the JAX loop and the plain operator.  The strict lower
// triangle and the diagonal depend on themselves only, so the kernel
// updates only those (the plain operator updates the whole square, whose
// upper triangle it then drops).  The arithmetic is the plain operator's,
// in its order, with IEEE divide, multiply and subtract intrinsics and no
// contraction into FMAs (also built with -fmad=false), so on finite input
// the kernel equals the plain operator run on the same card bit for bit.
//
// Non-finite input: the plain operator's masked products (0 * NaN) spread
// a non-finite entry over the whole block or a row and column of it,
// depending on where it lies.  Here a scenario with a non-finite entry
// anywhere in its block, or a non-finite value in its factor (overflow),
// gets NaN in every entry of d and of L's strict lower triangle (L keeps
// its unit diagonal and zero upper triangle); the other scenarios of the
// launch are untouched.
//
// What bounds it on an H100.  A 64-column block needs ~0.13 MFLOP (3 per
// trailing-update entry, sum over j of (NB-j)(NB-j-1)/2, plus NB(NB-1)/2
// divides) and moves ~33 KB (K read once, L and d written once): at
// B=1024 ~10 us at 3.35 TB/s against ~2 us at the 67 TFLOP/s f32 peak, so
// bytes bound it (chip_smoke.ldl_work).  In practice the column loop's
// dependency chain bounds it: 2 block-wide barriers per column, and each
// column's work shrinks with the trailing triangle.
//
// What the design does about it: one block of 256 threads per scenario,
// the block in shared memory (64 rows of stride 65 floats, so a column
// read hits 32 banks; 16.9 KB with the column vector and the signs, no
// opt-in), up to 8 scenarios resident per SM so that one's barrier waits
// overlap another's work (B = 1024 is one wave on 132 SMs).  The update
// gives a warp 32 consecutive entries of one row (no bank conflicts; l_i
// is a broadcast).  A simple kernel first: no tensor cores, no TMA.

#include <cuda_runtime.h>
#include <math.h>

#define LDL_MAX_NB 64
#define LDL_STRIDE 65
#define LDL_TX 64
#define LDL_TY 4

__global__ void __launch_bounds__(LDL_TX * LDL_TY)
ldl_block_kernel(int NB, float reg, const float* __restrict__ K,
                 const float* __restrict__ sign, float* __restrict__ L,
                 float* __restrict__ d) {
  __shared__ float Ks[LDL_MAX_NB * LDL_STRIDE];
  __shared__ float lc[LDL_MAX_NB];
  __shared__ float sg[LDL_MAX_NB];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * LDL_TX + tx, nt = LDL_TX * LDL_TY;
  const int nn = NB * NB;
  const size_t base = (size_t)blockIdx.x * nn;

  int bad = 0;
  for (int e = tid; e < nn; e += nt) {
    const float v = K[base + e];
    bad |= !isfinite(v);
    Ks[(e / NB) * LDL_STRIDE + e % NB] = v;
  }
  for (int i = tid; i < NB; i += nt) sg[i] = sign[i];
  bad = __syncthreads_or(bad);   // uniform over the block

  if (!bad) {
    for (int j = 0; j < NB; ++j) {
      const float a = Ks[j * LDL_STRIDE + j];
      const float dj = fabsf(a) >= reg ? a : __fmul_rn(sg[j], reg);
      for (int i = j + 1 + tid; i < NB; i += nt) {
        const float c = __fdiv_rn(Ks[i * LDL_STRIDE + j], dj);
        lc[i] = c;
        Ks[i * LDL_STRIDE + j] = c;
      }
      __syncthreads();
      const int k = tx;
      if (k > j && k < NB) {
        const float lk = lc[k];
        for (int i = j + 1 + ty; i < NB; i += LDL_TY) {
          if (k <= i) {
            const float t = __fmul_rn(dj, lc[i]);
            Ks[i * LDL_STRIDE + k] =
                __fsub_rn(Ks[i * LDL_STRIDE + k], __fmul_rn(t, lk));
          }
        }
      }
      __syncthreads();
    }
    int over = 0;
    for (int e = tid; e < nn; e += nt) {
      const int i = e / NB, c = e % NB;
      if (c <= i) over |= !isfinite(Ks[i * LDL_STRIDE + c]);
    }
    bad = __syncthreads_or(over);
  }

  const float nan = __int_as_float(0x7fc00000);
  for (int e = tid; e < nn; e += nt) {
    const int i = e / NB, c = e % NB;
    L[base + e] = c < i ? (bad ? nan : Ks[i * LDL_STRIDE + c])
                        : (c == i ? 1.0f : 0.0f);
  }
  for (int i = tid; i < NB; i += nt)
    d[(size_t)blockIdx.x * NB + i] = bad ? nan : Ks[i * LDL_STRIDE + i];
}

extern "C" {

// Launches one block per scenario on `stream`; returns cudaGetLastError(),
// or cudaErrorInvalidValue (without launching) when NB is not in 1..64.
// All pointers are device, contiguous, f32, with the shapes of the Python
// wrapper (allocnet_tpu_torch/ops/ldl.py): K and L (B, NB, NB), sign (NB),
// d (B, NB).
int ldl_block_launch(int B, int NB, float reg, const float* K,
                     const float* sign, float* L, float* d, void* stream) {
  if (NB < 1 || NB > LDL_MAX_NB || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  ldl_block_kernel<<<B, dim3(LDL_TX, LDL_TY), 0, (cudaStream_t)stream>>>(
      NB, reg, K, sign, L, d);
  return (int)cudaGetLastError();
}

const char* ldl_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
