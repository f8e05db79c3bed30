// admm_chunk: n_iters fused OSQP-style ADMM iterations for a batch of
// corridor-constrained min-snap QPs, all iteration state in shared memory.
//
// Replaces the TPU kernel allocnet_tpu/ops/pallas/admm_tiled.py::_kernel
// (launched by run_chunk, admm_tiled.py:209/236).  Same math, laid out from
// the math rather than from the TPU's padded (64, 128) slabs:
//
//   x    (n)          flat scaled coefficients, n = S*3*D, order (s, j, d)
//   z, yh (S*R, C)    inequality slots and SCALED duals (yh = y / rho_i):
//                     row = (segment s, sample r), C = F + 12 slots:
//                     F corridor faces, then box slot j*4 + t with
//                     t in {+vel, +acc, -vel, -acc} (ops/qp.apply_A order)
//   yeh  (m)          scaled equality dual (y_eq / rho_e)
//   Kx   (n, n)       the x-update matrix (2 Minv - Minv M Minv)^T
//   Aeq  (m, n)       dense equality rows
//
// One iteration (admm.admm_solve, in scaled-dual form):
//   rrow = sigma x + rho_e Aeq^T (beq - yeh) + rho_i G^T (z - yh)
//   xt   = clip(Kx rrow, +-1e6)
//   x    = alpha xt + (1 - alpha) x
//   v    = alpha G xt + (1 - alpha) z + yh;  z = min(v, h);
//   yh   = clip(v - z, +-1e6 / rho_i)
//   yeh  = clip(yeh + alpha (Aeq xt - beq), +-1e6 / rho_e)
//
// G is never built (the TPU kernel's 128 x 1152 sampling operator Cbig is
// block-sparse: three R x D basis matrices per (segment, axis)).  G x is,
// per (segment, sample), pos/vel/acc = B{0,1,2}[r] . x[s, j, :] followed by
// face dot products a_f . pos and the +-vel/acc box slots; G^T w mirrors it.
//
// What bounds it on an H100: per iteration and scenario the dense products
// are n^2 = 14.4 k multiply-adds for Kx, 2 m n = 15.8 k for Aeq^T and Aeq,
// and 2 (S R 3 F + S R 9 D) = 44.4 k for G^T and G (deploy shape: S=5,
// R=20, F=50, D=8, n=120, m=66), plus ~16 FLOP per inequality slot, 249
// kFLOP in all.  The data needs far less: padded segments' variables stay
// zero, Aeq is sparse and corridors leave most face slots empty, so on the
// deploy batch chip_smoke.py counts ~58 kFLOP per iteration and scenario,
// ~9e9 FLOP per launch at B=1024 and 150
// iterations: ~0.13 ms at the 67 TFLOP/s f32 peak of the CUDA cores,
// against 0.20 GB of dense inputs and outputs (~0.06 ms at 3.35 TB/s).  So
// operations bound it, and in practice the instructions it issues: every
// multiply-add loads its operands from shared memory, and four phases per
// iteration are separated by block-wide barriers.
//
// What the design does about it: one block per scenario keeps all of a
// scenario's state (~155 KB at the deploy shape) in shared memory for the
// whole chunk, so device memory is touched once per launch.  That allows
// one block per SM, so the block is wide (kThreads = 1024, 32 warps) to
// hide shared-memory and FMA latency, and every phase spreads its work over
// all of them: the Kx and Aeq products one warp per row (lanes over
// columns, shuffle reduction), rrow eight lanes per output, and the
// inequality update one warp per (segment, sample) row, which also reduces
// the row's G^T contributions for the next iteration, so z and yh are read
// once per iteration.  It does the dense work; skipping padded segments,
// padded faces and Aeq's zeros, register-resident Kx, tensor cores
// (wgmma), TMA and several scenarios per block are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kParts = 8;         // lanes that share one rrow output
constexpr int kBoxSlots = 12;

struct Dims {
  int S, R, F, D, n, m, NR, C;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Clip to [lo, hi], passing NaN through as torch.clamp does (fminf and
// fmaxf would replace it).
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// out[row] = A[row, :] . v for rows [0, rows); one warp per row, lanes over
// columns; clipped to +-clip when clip > 0.
__device__ __forceinline__ void warp_rows_matvec(const float* A, const float* v,
                                                 float* out, int rows, int cols,
                                                 int warp, int lane, float clip) {
  for (int row = warp; row < rows; row += kWarps) {
    const float* a = A + row * cols;
    float acc = 0.f;
    for (int c = lane; c < cols; c += 32) acc = fmaf(a[c], v[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[row] = clip > 0.f ? clampf(acc, -clip, clip) : acc;
  }
}

// W[row, 0:9] for the rows of this warp: per axis j, the face sum of
// u a_f[j] (0..2), the box differences (u_{+v} - u_{-v}) (3..5) and
// (u_{+a} - u_{-a}) (6..8), masked by the segment; u = z - yh.  With
// `update`, first apply the relaxation/projection/dual update to the row.
__device__ __forceinline__ void rows_update_and_reduce(
    const Dims& dm, bool update, float* z, float* yh, const float* h,
    const float* nrm, const float* sm, const float* Pv, float* W,
    float alpha, float yci, int warp, int lane) {
  const int R = dm.R, F = dm.F, C = dm.C;
  for (int row = warp; row < dm.NR; row += kWarps) {
    const int s = row / R;
    const float* p = Pv + row * 9;
    float w[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) w[k] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int slot = lane + 32 * half;
      if (slot < C) {
        const int e = row * C + slot;
        float u;
        if (slot < F) {
          const float* a = nrm + (s * F + slot) * 3;
          if (update) {
            const float vi = p[0] * a[0] + p[1] * a[1] + p[2] * a[2];
            const float v = alpha * vi + (1.f - alpha) * z[e] + yh[e];
            const float hs = h[s * C + slot];
            const float zn = v > hs ? hs : v;
            const float yn = clampf(v - zn, -yci, yci);
            z[e] = zn;
            yh[e] = yn;
            u = zn - yn;
          } else {
            u = z[e] - yh[e];
          }
          w[0] = fmaf(u, a[0], w[0]);
          w[1] = fmaf(u, a[1], w[1]);
          w[2] = fmaf(u, a[2], w[2]);
        } else {
          const int bx = slot - F, j = bx >> 2, t = bx & 3;
          if (update) {
            const float val = (t & 1) ? p[6 + j] : p[3 + j];
            const float vi = ((t >= 2) ? -val : val) * sm[s];
            const float v = alpha * vi + (1.f - alpha) * z[e] + yh[e];
            const float hs = h[s * C + slot];
            const float zn = v > hs ? hs : v;
            const float yn = clampf(v - zn, -yci, yci);
            z[e] = zn;
            yh[e] = yn;
            u = zn - yn;
          } else {
            u = z[e] - yh[e];
          }
          u = ((t >= 2) ? -u : u) * sm[s];
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            if (jj == j) {
              if (t & 1) w[6 + jj] += u;
              else w[3 + jj] += u;
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) w[k] = warp_sum(w[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) W[row * 9 + k] = w[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
admm_chunk_kernel(Dims dm, int n_iters, float sigma, float alpha,
                  const float* __restrict__ g_kx, const float* __restrict__ g_aeq,
                  const float* __restrict__ g_beq, const float* __restrict__ g_nrm,
                  const float* __restrict__ g_h, const float* __restrict__ g_sm,
                  const float* __restrict__ g_rhoi, const float* __restrict__ g_rhoe,
                  const float* __restrict__ g_bas,
                  const float* __restrict__ g_x, const float* __restrict__ g_z,
                  const float* __restrict__ g_yh, const float* __restrict__ g_yeh,
                  float* __restrict__ o_x, float* __restrict__ o_z,
                  float* __restrict__ o_yh, float* __restrict__ o_yeh) {
  extern __shared__ float smem[];
  const int S = dm.S, R = dm.R, F = dm.F, D = dm.D, n = dm.n, m = dm.m;
  const int NR = dm.NR, C = dm.C, NZ = NR * C;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  float* kx = smem;               // n * n
  float* aeq = kx + n * n;        // m * n
  float* z = aeq + m * n;         // NR * C
  float* yh = z + NZ;             // NR * C
  float* nrm = yh + NZ;           // S * F * 3
  float* h = nrm + S * F * 3;     // S * C
  float* bas = h + S * C;         // 3 * R * D
  float* x = bas + 3 * R * D;     // n
  float* rrow = x + n;            // n
  float* xt = rrow + n;           // n
  float* beq = xt + n;            // m
  float* yeh = beq + m;           // m
  float* q = yeh + m;             // m
  float* veq = q + m;             // m
  float* W = veq + m;             // NR * 9: G^T partials per row
  float* Pv = W + NR * 9;         // NR * 9: pos/vel/acc per row and axis
  float* sm = Pv + NR * 9;        // S

  {
    const float* s_kx = g_kx + (size_t)b * n * n;
    for (int i = tid; i < n * n; i += kThreads) kx[i] = s_kx[i];
    const float* s_aeq = g_aeq + (size_t)b * m * n;
    for (int i = tid; i < m * n; i += kThreads) aeq[i] = s_aeq[i];
    const float* s_z = g_z + (size_t)b * NZ;
    const float* s_yh = g_yh + (size_t)b * NZ;
    for (int i = tid; i < NZ; i += kThreads) { z[i] = s_z[i]; yh[i] = s_yh[i]; }
    for (int i = tid; i < S * F * 3; i += kThreads) nrm[i] = g_nrm[(size_t)b * S * F * 3 + i];
    for (int i = tid; i < S * C; i += kThreads) h[i] = g_h[(size_t)b * S * C + i];
    for (int i = tid; i < 3 * R * D; i += kThreads) bas[i] = g_bas[i];
    for (int i = tid; i < n; i += kThreads) x[i] = g_x[(size_t)b * n + i];
    for (int i = tid; i < m; i += kThreads) {
      beq[i] = g_beq[(size_t)b * m + i];
      yeh[i] = g_yeh[(size_t)b * m + i];
      q[i] = beq[i] - yeh[i];
    }
    for (int i = tid; i < S; i += kThreads) sm[i] = g_sm[(size_t)b * S + i];
  }
  const float rho_i = g_rhoi[b], rho_e = g_rhoe[b];
  const float yci = 1e6f / rho_i, yce = 1e6f / rho_e;
  const float* B0 = bas;
  const float* B1 = bas + R * D;
  const float* B2 = bas + 2 * R * D;
  __syncthreads();
  // the G^T partials of the initial state
  rows_update_and_reduce(dm, false, z, yh, h, nrm, sm, Pv, W, alpha, yci, warp, lane);
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // (1) rrow = sigma x + rho_e Aeq^T q + rho_i G^T (z - yh), kParts lanes
    // per output, each over every kParts-th sample and equality row
    for (int base = 0; base < n * kParts; base += kThreads) {
      const int idx = (base + tid) / kParts, part = tid % kParts;
      float g = 0.f, e = 0.f;
      if (idx < n) {
        const int d = idx % D, sj = idx / D, j = sj % 3, s = sj / 3;
        for (int r = part; r < R; r += kParts) {
          const float* w = W + (s * R + r) * 9;
          g = fmaf(B0[r * D + d], w[j], g);
          g = fmaf(B1[r * D + d], w[3 + j], g);
          g = fmaf(B2[r * D + d], w[6 + j], g);
        }
        for (int k = part; k < m; k += kParts) e = fmaf(aeq[k * n + idx], q[k], e);
      }
      float t = rho_e * e + rho_i * g;
#pragma unroll
      for (int off = kParts / 2; off > 0; off >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, off);
      if (idx < n && part == 0) rrow[idx] = sigma * x[idx] + t;
    }
    __syncthreads();

    // (2) xt = clip(Kx rrow)
    warp_rows_matvec(kx, rrow, xt, n, n, warp, lane, 1e6f);
    __syncthreads();

    // (3) Aeq xt; pos/vel/acc of xt at every (segment, sample); relaxed x
    warp_rows_matvec(aeq, xt, veq, m, n, warp, lane, 0.f);
    for (int t = tid; t < NR * 9; t += kThreads) {
      const int row = t / 9, k = t - row * 9, c = k / 3, j = k - c * 3;
      const int s = row / R, r = row - s * R;
      const float* bc = bas + (c * R + r) * D;
      const float* xs = xt + (s * 3 + j) * D;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(bc[d], xs[d], acc);
      Pv[t] = acc;
    }
    for (int i = tid; i < n; i += kThreads) x[i] = alpha * xt[i] + (1.f - alpha) * x[i];
    __syncthreads();

    // (4) relaxation, projection and scaled-dual updates; the next
    // iteration's G^T partials and equality residual q
    rows_update_and_reduce(dm, true, z, yh, h, nrm, sm, Pv, W, alpha, yci, warp, lane);
    for (int k = tid; k < m; k += kThreads) {
      yeh[k] = clampf(yeh[k] + alpha * (veq[k] - beq[k]), -yce, yce);
      q[k] = beq[k] - yeh[k];
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) o_x[(size_t)b * n + i] = x[i];
  for (int i = tid; i < NZ; i += kThreads) {
    o_z[(size_t)b * NZ + i] = z[i];
    o_yh[(size_t)b * NZ + i] = yh[i];
  }
  for (int i = tid; i < m; i += kThreads) o_yeh[(size_t)b * m + i] = yeh[i];
}

size_t smem_floats(const Dims& d) {
  return (size_t)d.n * d.n + (size_t)d.m * d.n + 2 * (size_t)d.NR * d.C +
         (size_t)d.S * d.F * 3 + (size_t)d.S * d.C + 3 * (size_t)d.R * d.D +
         3 * (size_t)d.n + 4 * (size_t)d.m + 18 * (size_t)d.NR + d.S;
}

}  // namespace

extern "C" {

// Launches one block per scenario on `stream`; returns cudaGetLastError(),
// or cudaErrorInvalidValue (without launching) when the shape does not fit:
// F + 12 <= 64 inequality slots (two per lane in the row update), and one
// scenario's state in the shared memory a block may opt in to.  All
// pointers are device f32, contiguous, with the shapes of the Python
// wrapper (allocnet_tpu_torch/ops/admm_chunk.py).
int admm_chunk_launch(int B, int S, int R, int F, int D, int m, int n_iters,
                      float sigma, float alpha,
                      const float* kx, const float* aeq, const float* beq,
                      const float* nrm, const float* h, const float* sm,
                      const float* rhoi, const float* rhoe, const float* bas,
                      const float* x, const float* z, const float* yh,
                      const float* yeh, float* ox, float* oz, float* oyh,
                      float* oyeh, void* stream) {
  Dims d{S, R, F, D, S * 3 * D, m, S * R, F + kBoxSlots};
  if (d.C > 64) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats(d) * sizeof(float);
  // above 48 KB a launch is refused unless the kernel opts in (per device,
  // so on every launch; it fails for more than a block may use)
  cudaError_t err = cudaFuncSetAttribute(
      admm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  admm_chunk_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      d, n_iters, sigma, alpha, kx, aeq, beq, nrm, h, sm, rhoi, rhoe, bas, x, z,
      yh, yeh, ox, oz, oyh, oyeh);
  return (int)cudaGetLastError();
}

// Dynamic shared memory one launch asks for, in bytes.
size_t admm_chunk_smem_bytes(int S, int R, int F, int D, int m) {
  return smem_floats(Dims{S, R, F, D, S * 3 * D, m, S * R, F + kBoxSlots}) *
         sizeof(float);
}

const char* admm_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
