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
// d keeps each pivot's unbumped value: the bumped dj is never written back,
// as in the JAX loop and the plain operator.  The strict lower triangle and
// the diagonal depend on themselves only (the plain operator updates the
// whole square, whose upper triangle it then drops).  Every entry receives
// the plain operator's IEEE operations in its order: the divide, the two
// products (dj * l_i first) and the difference, column by column, with
// __fdiv_rn / __fmul_rn / __fsub_rn and no contraction into FMAs (also
// built with -fmad=false).  L's strict lower entries get + 0, which turns
// a -0 into +0 as the plain operator's tril(K, -1) + eye does.  So on
// finite input the kernel equals the plain operator run on the same card
// bit for bit (a pivot of exactly -0 could come out as +0 in the plain
// operator, which keeps subtracting masked zeros from it).
//
// Non-finite input: the plain operator's masked products (0 * NaN) spread
// a non-finite entry over the whole block or a row and column of it,
// depending on where it lies.  Here a scenario with a non-finite entry
// anywhere in its block, or a non-finite value in its factor (overflow),
// gets NaN in every entry of d and of L's strict lower triangle (L keeps
// its unit diagonal and zero upper triangle); the other scenarios of the
// launch, those of its own thread block included, are untouched.
//
// What bounds it on an H100.  A 64-column block needs ~0.13 MFLOP and
// moves ~33 KB (K read once, L and d written once): at B=1024 ~10 us of
// bytes at 3.35 TB/s against ~2 us of operations at 67 TFLOP/s, so bytes
// bound the batch (chip_smoke.ldl_work).  One scenario, one warp, is bound
// by latency instead: column j+1's pivot needs column j's divide, 64 times
// in a row (a shared read, the compare, an IEEE divide, which is a chain
// of dependent instructions with a slow-path branch, two products and a
// difference: the latency floor, PERF.md), and a lone warp waits on each
// of its shared-memory accesses and divides in turn.
//
// What the design does about it:
// - One warp per scenario, LDL_WARPS scenarios per thread block, each
//   warp's block in its own shared memory (64 rows of 68 floats: rows are
//   16-byte aligned, and 16-byte accesses of one column group by lanes
//   t..t+7 or their rows 63-t.. hit all 32 banks).  B=1024 is 256 thread
//   blocks (2 resident per SM), B <= 4 one.  No block-wide barrier: one
//   __syncwarp per column, the column's l in shared memory.  A warp past
//   the batch returns at once; a scenario's non-finite flag is its own
//   warp's vote (__any_sync), so a short last thread block and a NaN
//   neighbour neither stall nor poison the others.
// - Lane t owns rows t and NB-1-t, whose lower parts add up to NB+1
//   entries.
// - Panels of LDL_PANEL = 8 columns (ldl_columns): the lane's rows' panel
//   entries and the panel's pivots live in registers while the panel's
//   columns are factored, and one pass then applies the panel's 8 columns,
//   in order, to each 16-byte group of the rows below, so a group is read
//   and written once per 8 columns.  Every lane computes each pivot
//   itself; each column's l reach the other lanes through shared memory.
// - Straight-line code in the column loop: a row that is not below the
//   column divides 1 by the pivot and stores nothing (predicated stores);
//   a zero dividend takes a product, not the divide's slow path (ldl_div).
//   Rows t < 32 end at column 31 and take no divide past it.
// - The pass updates whole 16-byte groups, entries right of a row's
//   diagonal included: those are scratch, never read for the lower
//   triangle.
// - K comes in with cp.async, 16 bytes a lane on neighbouring addresses
//   (NB % 4 == 0 and 16-byte aligned K and L; else 4 bytes a lane), and L
//   goes out the same way from shared memory.
// No tensor cores and no TMA: the work is a dependent scalar chain.  On
// the card, panels of 4, 12 or 16 columns, shuffles for the l, and rows
// held in registers under a fully unrolled column loop (straight-line code
// that runs once and misses the instruction cache) were all slower.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LDL_MAX_NB 64
#define LDL_STRIDE 68                          // floats per shared row
#define LDL_WARPS 4                            // scenarios per thread block
#define LDL_BLOCK_FLOATS (LDL_MAX_NB * LDL_STRIDE)
#define LDL_PANEL 8                            // columns per panel
// one warp's shared memory: the block, l of a panel's columns, the bumped
// and the unbumped pivots
#define LDL_WARP_FLOATS (LDL_BLOCK_FLOATS + (LDL_PANEL + 2) * LDL_MAX_NB)
#define LDL_SMEM_BYTES (LDL_WARPS * LDL_WARP_FLOATS * (int)sizeof(float))
#define LDL_MAX_DEVICES 64
#define LDL_FULL 0xffffffffu

// v -= t * l, entry by entry (the plain operator's product, then difference)
__device__ __forceinline__ float4 ldl_update(float4 v, float t, float4 l) {
  v.x = __fsub_rn(v.x, __fmul_rn(t, l.x));
  v.y = __fsub_rn(v.y, __fmul_rn(t, l.y));
  v.z = __fsub_rn(v.z, __fmul_rn(t, l.z));
  v.w = __fsub_rn(v.w, __fmul_rn(t, l.w));
  return v;
}

// shared-memory stores under a per-lane predicate, without a branch: the
// loads and products before them stay straight-line code
__device__ __forceinline__ void ldl_st_if(bool p, float* a, float v) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
               "@q st.shared.f32 [%1], %2;\n\t}"
               :: "r"((int)p), "r"((unsigned)__cvta_generic_to_shared(a)),
                  "f"(v) : "memory");
}

__device__ __forceinline__ void ldl_st4_if(bool p, float4* a, float4 v) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
               "@q st.shared.v4.f32 [%1], {%2, %3, %4, %5};\n\t}"
               :: "r"((int)p), "r"((unsigned)__cvta_generic_to_shared(a)),
                  "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// a / b (__fdiv_rn).  A zero dividend (common in the polish's sparse
// blocks) takes __fmul_rn(a, b) instead: for a finite non-zero b that is
// the divide's own result, the signed zero, without the divide's slow
// path, which a zero dividend takes.  b is the bumped pivot; a non-finite
// one flags the scenario.
__device__ __forceinline__ float ldl_div(float a, float b) {
  const float q = __fdiv_rn(a == 0.0f ? 1.0f : a, b);
  return a == 0.0f ? __fmul_rn(a, b) : q;
}

__device__ __forceinline__ bool ldl_nonfinite4(float4 v) {
  return !isfinite(v.x) || !isfinite(v.y) || !isfinite(v.z) ||
         !isfinite(v.w);
}

// entry (i, c) of L from the factored block's entry v.  z is +0, or NaN
// for a non-finite scenario; v + 0 turns a -0 into +0, as the plain
// operator's tril(K, -1) + eye does
__device__ __forceinline__ float ldl_out(float v, int c, int i, float z) {
  const float lower = __fadd_rn(v, z), upper = c == i ? 1.0f : 0.0f;
  return c < i ? lower : upper;
}

__device__ __forceinline__ void ldl_cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

// The column loop: one warp factors the block in shared memory, in panels
// of W = LDL_PANEL columns (c0 = W m .. c0 + W - 1).  Lane t owns rows t
// and NB-1-t.  For each panel the lane's rows' W panel entries come into
// registers; column by column every lane computes the pivot itself (from
// the panel's diagonal entry, with the l of the pivot row for the panel's
// earlier columns applied in column order), the lane divides its rows'
// entries, the column's l (zero for rows not below the column) go to
// shared memory and one __syncwarp follows; then each later panel column
// of the lane's rows and each later pivot takes that column's update.
// Last, one pass applies the panel's W columns, in order, to the rest of
// the lane's rows below the panel: a 16-byte group is read and written
// once per panel instead of once per column.  NBC = 64 fixes NB at 64 (a
// specialisation of the same code).  Returns whether the factor has a
// non-finite entry (the warp's vote).
template <int NBC>
__device__ __forceinline__ bool ldl_columns(int nb, float reg, float* Ks,
                                            float* lc, const float* bump,
                                            float* dsm) {
  constexpr int W = LDL_PANEL, G = W / 4;      // panel columns, groups
  const int NB = NBC ? NBC : nb;
  const int lane = threadIdx.x & 31;
  const int h = (NB + 1) >> 1;                 // lanes that own a row A
  const int ra = lane, rb = NB - 1 - lane;     // the lane's rows A and B
  const bool hasA = lane < h, hasB = 2 * lane + 1 < NB;
  // a lane without a row reads row 0 in its place and writes nothing
  float4* A4 = reinterpret_cast<float4*>(Ks + (hasA ? ra : 0) * LDL_STRIDE);
  float4* B4 = reinterpret_cast<float4*>(Ks + (hasB ? rb : 0) * LDL_STRIDE);
  const float4* l4 = reinterpret_cast<const float4*>(lc);   // W x 64 l
  // last 16-byte group with lower entries of a row A, of any row
  const int gA = (h - 1) >> 2, gB = (NB - 1) >> 2;
  bool over = false;

  for (int c0 = 0; c0 < NB; c0 += W) {
    const int m = c0 / W;
    float xa[W], xb[W], pv[W];                 // panel entries, pivots
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float4 pa = A4[G * m + u], pb = B4[G * m + u];
      xa[4 * u] = pa.x; xa[4 * u + 1] = pa.y; xa[4 * u + 2] = pa.z; xa[4 * u + 3] = pa.w;
      xb[4 * u] = pb.x; xb[4 * u + 1] = pb.y; xb[4 * u + 2] = pb.z; xb[4 * u + 3] = pb.w;
    }
#pragma unroll
    for (int q = 0; q < W; ++q) pv[q] = Ks[(c0 + q) * (LDL_STRIDE + 1)];
    float ta[W], tb[W], qa[W], qb[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {              // column c = c0 + q
      const int c = c0 + q;
      qa[q] = qb[q] = ta[q] = tb[q] = 0.0f;
      if (c >= NB) continue;                   // past a short last panel
      const float p = pv[q];
      const float d = fabsf(p) >= reg ? p : bump[c];
      ldl_st_if(lane == 0, dsm + c, p);
      const bool la = hasA && ra > c, lb = hasB && rb > c;  // rows below c
      qb[q] = ldl_div(lb ? xb[q] : 1.0f, d);
      if (c < h - 1) qa[q] = ldl_div(la ? xa[q] : 1.0f, d); // a row A below
      ta[q] = __fmul_rn(d, qa[q]);
      tb[q] = __fmul_rn(d, qb[q]);
      over |= !isfinite(p) | (la & !isfinite(qa[q])) | (lb & !isfinite(qb[q]));
      ldl_st_if(hasA, lc + q * LDL_MAX_NB + ra, la ? qa[q] : 0.0f);
      ldl_st_if(hasB, lc + q * LDL_MAX_NB + rb, lb ? qb[q] : 0.0f);
      __syncwarp();                            // column c's l, for all
      // column c's update of the panel's later columns: the lane's rows
      // and, in every lane, the pivot rows' diagonal entries
#pragma unroll
      for (int s = q + 1; s < W; ++s) {
        const float l = lc[q * LDL_MAX_NB + c0 + s];   // l of row c0 + s
        pv[s] = __fsub_rn(pv[s], __fmul_rn(__fmul_rn(d, l), l));
        xa[s] = __fsub_rn(xa[s], __fmul_rn(ta[q], l));
        xb[s] = __fsub_rn(xb[s], __fmul_rn(tb[q], l));
      }
    }
    // the panel's L entries of the lane's rows (other entries as they are)
#pragma unroll
    for (int u = 0; u < G; ++u) {
      float va[4], vb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 4 * u + e;
        va[e] = ra > c0 + q ? qa[q] : xa[q];
        vb[e] = rb > c0 + q ? qb[q] : xb[q];
      }
      ldl_st4_if(hasA, A4 + G * m + u, make_float4(va[0], va[1], va[2], va[3]));
      ldl_st4_if(hasB, B4 + G * m + u, make_float4(vb[0], vb[1], vb[2], vb[3]));
    }
    // the panel's W columns, in order, on the columns right of the panel
    // of the rows below it (whole groups: entries right of a row's
    // diagonal are scratch, never read for the lower triangle)
    const bool la = hasA && ra >= c0 + W, lb = hasB && rb >= c0 + W;
    for (int g = G * (m + 1); g <= gB; ++g) {
      float4 lv[W];
#pragma unroll
      for (int q = 0; q < W; ++q) lv[q] = l4[16 * q + g];
      float4 vb = B4[g];
#pragma unroll
      for (int q = 0; q < W; ++q) vb = ldl_update(vb, tb[q], lv[q]);
      if (g <= gA) {
        float4 va = A4[g];
#pragma unroll
        for (int q = 0; q < W; ++q) va = ldl_update(va, ta[q], lv[q]);
        ldl_st4_if(la, A4 + g, va);
      }
      ldl_st4_if(lb, B4 + g, vb);
    }
    __syncwarp();                              // the pass, before new l
  }
  return __any_sync(LDL_FULL, over);
}

// One scenario, one warp.  NBC = 64: NB = 64 with 16-byte I/O (index math
// by shifts); NBC = 0: any NB, 16-byte I/O where `vec`.  Ks: the warp's
// shared memory (LDL_WARP_FLOATS).
template <int NBC>
__device__ __forceinline__ void ldl_scenario(
    int nb, bool vec, float reg, const float* __restrict__ Kg,
    const float* __restrict__ sign, float* __restrict__ Lg,
    float* __restrict__ dg, float* Ks) {
  const int NB = NBC ? NBC : nb;
  const bool v16 = NBC ? true : vec;
  const int lane = threadIdx.x & 31;
  float* lc = Ks + LDL_BLOCK_FLOATS;           // l of a panel's columns
  float* bump = lc + LDL_PANEL * LDL_MAX_NB;   // sign[j] * reg
  float* dsm = bump + LDL_MAX_NB;              // the unbumped pivots, d

  // ---- K into shared memory; any non-finite entry? -----------------------
  bool bad = false;
  if (v16) {
    // float4 e of the block: row e / q, columns 4 (e % q) ..
    const unsigned q = NB >> 2, n4 = NB * q;
#pragma unroll 8
    for (unsigned e = lane; e < n4; e += 32)
      ldl_cp_async16(Ks + (e / q) * LDL_STRIDE + 4 * (e % q), Kg + 4 * e);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll 8
    for (unsigned e = lane; e < n4; e += 32)   // the lane's own copies
      bad |= ldl_nonfinite4(*reinterpret_cast<const float4*>(
          Ks + (e / q) * LDL_STRIDE + 4 * (e % q)));
  } else {
    for (int e = lane; e < NB * NB; e += 32) {
      const float v = Kg[e];
      bad |= !isfinite(v);
      Ks[(e / NB) * LDL_STRIDE + e % NB] = v;
    }
  }
  for (int i = lane; i < NB; i += 32) bump[i] = __fmul_rn(sign[i], reg);
  bad = __any_sync(LDL_FULL, bad);
  __syncwarp();                                // the block, for every lane

  // ---- the column loop ----------------------------------------------------
  if (!bad) bad = ldl_columns<NBC>(NB, reg, Ks, lc, bump, dsm);
  __syncwarp();                                // every row, for every lane

  // ---- L and d out ----------------------------------------------------------
  const float z = bad ? __int_as_float(0x7fc00000) : 0.0f;
  if (v16) {
    const unsigned q = NB >> 2, n4 = NB * q;
    float4* L4 = reinterpret_cast<float4*>(Lg);
#pragma unroll 8
    for (unsigned e = lane; e < n4; e += 32) {
      const int i = e / q, c = 4 * (e % q);
      float4 v = *reinterpret_cast<const float4*>(Ks + i * LDL_STRIDE + c);
      v.x = ldl_out(v.x, c, i, z);
      v.y = ldl_out(v.y, c + 1, i, z);
      v.z = ldl_out(v.z, c + 2, i, z);
      v.w = ldl_out(v.w, c + 3, i, z);
      L4[e] = v;
    }
  } else {
    for (int e = lane; e < NB * NB; e += 32) {
      const int i = e / NB, c = e % NB;
      Lg[e] = ldl_out(Ks[i * LDL_STRIDE + c], c, i, z);
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  for (int i = lane; i < NB; i += 32) dg[i] = bad ? nan : dsm[i];
}

__global__ void __launch_bounds__(32 * LDL_WARPS)
ldl_block_kernel(int B, int NB, float reg, int vec,
                 const float* __restrict__ K, const float* __restrict__ sign,
                 float* __restrict__ L, float* __restrict__ d) {
  extern __shared__ float4 ldl_smem[];
  const int w = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * LDL_WARPS + w;
  if (b >= B) return;                          // nothing waits for this warp
  float* Ks = reinterpret_cast<float*>(ldl_smem) + w * LDL_WARP_FLOATS;
  const size_t nn = (size_t)NB * NB;
  if (NB == LDL_MAX_NB && vec)
    ldl_scenario<LDL_MAX_NB>(NB, true, reg, K + b * nn, sign, L + b * nn,
                             d + b * NB, Ks);
  else
    ldl_scenario<0>(NB, vec != 0, reg, K + b * nn, sign, L + b * nn,
                    d + b * NB, Ks);
}

// The opt-in to LDL_SMEM_BYTES of dynamic shared memory, once per device.
static cudaError_t ldl_opt_in() {
  static bool done[LDL_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < LDL_MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ldl_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LDL_SMEM_BYTES);
  if (err == cudaSuccess && dev < LDL_MAX_DEVICES) done[dev] = true;
  return err;
}

extern "C" {

// Launches one warp per scenario, LDL_WARPS scenarios per thread block, on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue (without
// launching) when NB is not in 1..64.  All pointers are device,
// contiguous, f32, with the shapes of the Python wrapper
// (allocnet_tpu_torch/ops/ldl.py): K and L (B, NB, NB), sign (NB),
// d (B, NB).
int ldl_block_launch(int B, int NB, float reg, const float* K,
                     const float* sign, float* L, float* d, void* stream) {
  if (NB < 1 || NB > LDL_MAX_NB || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaError_t err = ldl_opt_in();
  if (err != cudaSuccess) return (int)err;
  const int vec = NB % 4 == 0 && (uintptr_t)K % 16 == 0 &&
                  (uintptr_t)L % 16 == 0;
  ldl_block_kernel<<<(B + LDL_WARPS - 1) / LDL_WARPS, 32 * LDL_WARPS,
                     LDL_SMEM_BYTES, (cudaStream_t)stream>>>(
      B, NB, reg, vec, K, sign, L, d);
  return (int)cudaGetLastError();
}

// The launch geometry on the current device: info[0] scenarios (warps) per
// thread block, info[1] dynamic shared memory per thread block (bytes),
// info[2] thread blocks resident per SM, info[3] registers per thread,
// info[4] local memory per thread (bytes; 0 without spills).  Returns a
// cudaError_t.
int ldl_block_geometry(int* info) {
  cudaError_t err = ldl_opt_in();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, ldl_block_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ldl_block_kernel, 32 * LDL_WARPS, LDL_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  info[0] = LDL_WARPS;
  info[1] = LDL_SMEM_BYTES;
  info[2] = per_sm;
  info[3] = a.numRegs;
  info[4] = (int)a.localSizeBytes;
  return 0;
}

const char* ldl_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
