// admm_chunk: n_iters fused OSQP-style ADMM iterations for a batch of
// corridor-constrained min-snap QPs, all iteration state on chip.
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
//   Aeq  (m, 2, D)    structured equality rows: each row is nonzero on at
//                     most two (segment, axis) blocks of D coefficients,
//                     given as their block indices (m, 2) and values
//
// One iteration (admm.admm_solve, in scaled-dual form):
//   rrow = sigma x + rho_e Aeq^T (beq - yeh) + rho_i G^T (z - yh)
//   xt   = clip(Kx rrow, +-1e6)
//   x    = alpha xt + (1 - alpha) x
//   v    = alpha G xt + (1 - alpha) z + yh;  z = min(v, h);
//   yh   = clip(v - z, +-1e6 / rho_i)
//   yeh  = clip(yeh + alpha (Aeq xt - beq), +-1e6 / rho_e)
//
// G is never built: G x is, per (segment, sample), pos/vel/acc =
// B{0,1,2}[r] . x[s, j, :] followed by the face dot products a_f . pos and
// the +-vel/acc box slots; G^T w mirrors it.
//
// What bounds it on an H100.  The data needs ~58 kFLOP per iteration and
// scenario on the deploy batch (chip_smoke.chunk_work: products over active
// segments, Aeq's nonzeros, live face slots), ~9e9 FLOP per launch at
// B=1024 and 150 iterations: ~0.13 ms at the 67 TFLOP/s f32 peak of the
// CUDA cores, against ~0.2 GB of inputs and outputs (~0.06 ms at 3.35
// TB/s).  So operations bound it.  In practice each iteration is three
// dependent phases between block-wide barriers, and a phase lasts as long
// as its slowest warp's chain of shared-memory loads, FMAs and shuffles
// (the profile build's per-warp counts: the slowest warp is busy ~85-90%
// of every phase even with one block per SM).
//
// What the design does about it:
//   * Only work the data needs, and only where skipping it is exact.  At
//     load each block checks its scenario: trailing segments with
//     seg_mask 0, zero normals, zero x/z/yh and h >= 0, whose Kx rows and
//     columns to the other segments are exact zeros and whose equality rows
//     carry zero beq and yeh, stay exactly zero under the dense iteration,
//     so they are skipped; so are face slots with a zero normal, h >= 0 and
//     z = yh = 0 in every sample (they stay (0, 0) and add nothing to
//     G^T).  Where a check fails (a warm start with nonzero padded state, a
//     non-finite input) the block keeps those parts live and does the dense
//     work for them.  Aeq arrives structured, so Aeq xt and Aeq^T q cost at
//     most 2 D multiply-adds per row or block entry.
//     ops/admm_chunk.live_parts states the same rule in PyTorch.
//   * Layout for the SM.  512 threads and at most ~113 KB of shared memory
//     per scenario up to 7 segments at the deploy widths, so two scenarios
//     are resident per SM and one's barrier waits overlap the other's work
//     (registers capped at 64 a thread).  From 8 segments (n >= 192) one
//     scenario's fixed part and slots alone outgrow half an SM, so a block
//     takes up to the whole opt-in (~227 KB) and runs alone on its SM.
//     Kx's live block sits in shared memory as f64 where the scenario's
//     live state fits so (up to 4 live segments at the deploy widths), else
//     as f32, else Kx is read from device memory (same kernel, L1/L2-
//     cached; at n = 240 a dense Kx is ~230 KB a scenario, ~30 MB for 132
//     resident blocks, inside the 50 MB L2); rows are 16-byte aligned and
//     strided so the 8 rows a quarter-warp loads hit 32 banks.  z and yh
//     hold live slots only, slot-major with a row stride of 8 (mod 32), so
//     4 lanes x 8 rows of a warp hit 32 banks.  Each sample row has 4 lanes: lanes 0-2 own axis
//     j's pos/vel/acc and its 4 box slots (no cross-lane sum for the box
//     partials of G^T), faces are spread over all 4 and their 3 partials
//     reduced over 2 shuffle levels.  D = 8 and R = 20 (the deploy shape)
//     are compiled into one instance of the kernel; other shapes take the
//     generic one.
//   * Three barriers per iteration: (A) rrow, (B) xt and the relaxed x,
//     (C) the row updates, which compute their own pos/vel/acc from xt,
//     with the equality rows' dual update on otherwise idle warps.
//   * Kx rrow is accumulated in f64 (f32 operands, f64 products and sum):
//     rho_e = 100 rho_i makes the sum cancel, and an f32 sum there carries
//     most of an f32 chunk's roundoff (the plain version does the same).
//   * At 10 segments (n = 240) with every segment live a block runs alone
//     on its SM and reads Kx from L2 each iteration: ~13-15 ms per launch
//     at B=1024 x 150 on an H100 (700 W) against a ~0.6-1.1 ms bound, a
//     latency-bound shape that a cluster holding Kx in two SMs' shared
//     memory would address.
//   * Tensor cores are not used: each scenario's Kx and Aeq are its own and
//     an iteration has one right-hand side, so every product is a
//     matrix-vector product, and the solve must run in full f32 or better
//     (TF32 makes it diverge; utils/device.py turns TF32 off).
//   * No cp.async or TMA for the per-scenario load: the block reads every
//     input once through registers because it checks each value (zero,
//     finite) as it copies it, and that load is ~5% of a block's cycles
//     (profile build); an asynchronous copy would need a second pass for
//     the checks.  The co-resident block computes while one loads.

#include <cuda_runtime.h>

// Per-phase cycle counts: built with -DADMM_CHUNK_PROFILE, thread 0 of
// every block adds clock64() differences between the block-wide barriers
// that close each phase into prof[block][phase] (the phase's wall time);
// for the three phases of an iteration, lane 0 of every warp also measures
// the warp's own busy time (from the barrier that opens the phase to its
// arrival at the one that closes it), and prof[block][5 + phase] and
// prof[block][10 + phase] sum the slowest warp's and all warps' busy
// cycles.  The default build compiles this out.
#define ADMM_PHASES "load,rrow,xt,rows,store"
#ifdef ADMM_CHUNK_PROFILE
constexpr int kPhases = 5;
// pacc (shared, 64-bit): [0, 5) wall, [5, 10) slowest warp, [10, 15) all
// warps, [15] thread 0's last clock64(); pmisc (shared, 32-bit): [0, 8)
// this phase's slowest warp, [8, 16) its warps' sum
#define PROF_MARK(k)                                  \
  if (tid == 0) {                                     \
    const long long t_ = clock64();                   \
    pacc[k] += t_ - pacc[15];                         \
    pacc[15] = t_;                                    \
    pacc[kPhases + k] += pmisc[k];                    \
    pacc[2 * kPhases + k] += pmisc[8 + k];            \
    pmisc[k] = 0;                                     \
    pmisc[8 + k] = 0;                                 \
  }
#define PROF_WARP_START const unsigned warp_t0_ = (unsigned)clock64();
#define PROF_WARP_END(k)                                          \
  if ((tid & 31) == 0) {                                          \
    const unsigned d_ = (unsigned)clock64() - warp_t0_;           \
    atomicMax(&pmisc[k], d_);                                     \
    atomicAdd(&pmisc[8 + k], d_);                                 \
  }
#else
#define PROF_MARK(k)
#define PROF_WARP_START
#define PROF_WARP_END(k)
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBoxSlots = 12;
constexpr int kMaxSlots = 64;

struct Dims {
  int S, R, F, D, n, m, NR, C, S3, n8;
};

__host__ __device__ inline int round_up(int v, int k) { return (v + k - 1) / k * k; }

// smallest w >= v with w = r (mod k)
__host__ __device__ inline int round_to_residue(int v, int k, int r) {
  return v + (((r - v) % k) + k) % k;
}

// Slot stride (floats) of z / yh for NRa live sample rows: 8 (mod 32), so
// the 4 consecutive slots x 8 rows a warp touches hit 32 banks.
__host__ __device__ inline int zy_stride(int NRa) { return round_to_residue(NRa, 32, 8); }

// Offsets (in 4-byte words) of the fixed part of shared memory; the live
// z / yh slots and Kx's live block follow at `small`.
struct Layout {
  int x, rrow, xt, beq, yeh, q, aval, ablk, colp, cole, bas, W, nh, hbox, sm,
      colnz, fidx, fcnt, segbad, misc, small;
};

__host__ __device__ inline int take(int& o, int count, int align) {
  o = round_up(o, align);
  const int at = o;
  o += count;
  return at;
}

__host__ __device__ inline Layout layout(const Dims& d) {
  Layout L;
  int o = 0;
  L.x = take(o, d.n8, 4);
  L.rrow = take(o, 2 * (d.n8 + 8), 4);   // doubles
  L.xt = take(o, d.n8, 4);
  L.beq = take(o, d.m, 1);
  L.yeh = take(o, d.m, 1);
  L.q = take(o, d.m, 1);
  L.aval = take(o, 2 * d.m * d.D, 4);
  L.ablk = take(o, 2 * d.m, 1);
  L.colp = take(o, d.S3 + 1, 1);
  L.cole = take(o, 2 * d.m, 1);
  L.bas = take(o, 3 * d.R * d.D, 4);
  L.W = take(o, d.NR * 9, 1);
  L.nh = take(o, d.S * d.F * 4, 4);
  L.hbox = take(o, d.S * kBoxSlots, 1);
  L.sm = take(o, d.S, 1);
  L.colnz = take(o, d.S * d.C, 1);
  L.fidx = take(o, d.S * d.F, 1);
  L.fcnt = take(o, d.S, 1);
  L.segbad = take(o, d.S, 1);
  L.misc = take(o, 64, 2);     // flags; [8, 64) the profile build's counters
  L.small = round_up(o, 4);
  return L;
}

// misc[] words
constexpr int kLs = 0, kBad = 1, kDense = 2, kBadIndex = 3;

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  // NaN passes through, as in torch.clamp (fminf / fmaxf would drop it)
  return v < lo ? lo : (v > hi ? hi : v);
}

// Phase C for the live sample rows: with Update, the relaxation, projection
// and scaled-dual update of every live slot, pos/vel/acc computed from xt;
// then the row's G^T partials W[row][0:9] (face sums of u a_f[j], box
// differences u_{+v} - u_{-v} and u_{+a} - u_{-a} per axis; u = z - yh).
// 4 lanes per row: lanes 0-2 own axis j's pos/vel/acc and its 4 box slots,
// so the box partials need no cross-lane sum; face slots are spread over
// all 4 lanes and their 3 partials reduced over 2 shuffle levels.
template <bool Update, int kD, int kR>
__device__ __forceinline__ void rows_phase(
    const Dims& dm, int NRa, int NRw, int Fw, float* __restrict__ zs,
    float* __restrict__ ys, const float* __restrict__ xt,
    const float* __restrict__ bas, const float4* __restrict__ nh,
    const float* __restrict__ hbox, const float* __restrict__ sm,
    const int* __restrict__ fcnt, float* __restrict__ W, float alpha,
    float yci, int tid) {
  const int R = kR ? kR : dm.R, D = kD ? kD : dm.D;
  const int l = tid & 3;
  const unsigned gmask = 0xfu << ((tid & 31) & ~3);
  for (int row = tid >> 2; row < NRa; row += kThreads / 4) {
    const int s = row / R, r = row - s * R;
    const float smv = sm[s];
    float pos = 0.f, vel = 0.f, acc = 0.f;
    if (Update && l < 3) {
      const float2* xs = reinterpret_cast<const float2*>(xt + (s * 3 + l) * D);
      const float2* b0 = reinterpret_cast<const float2*>(bas + r * D);
      const float2* b1 = reinterpret_cast<const float2*>(bas + (R + r) * D);
      const float2* b2 = reinterpret_cast<const float2*>(bas + (2 * R + r) * D);
#pragma unroll 4
      for (int k = 0; k < D / 2; ++k) {
        const float2 xv = xs[k], a = b0[k], v1 = b1[k], v2 = b2[k];
        pos = fmaf(a.x, xv.x, fmaf(a.y, xv.y, pos));
        vel = fmaf(v1.x, xv.x, fmaf(v1.y, xv.y, vel));
        acc = fmaf(v2.x, xv.x, fmaf(v2.y, xv.y, acc));
      }
    }
    float p0 = 0.f, p1 = 0.f, p2 = 0.f;
    if (Update) {
      p0 = __shfl_sync(gmask, pos, 0, 4);
      p1 = __shfl_sync(gmask, pos, 1, 4);
      p2 = __shfl_sync(gmask, pos, 2, 4);
    }
    float w0 = 0.f, w1 = 0.f, w2 = 0.f;
    const int nf = fcnt[s];
    const float4* nhs = nh + s * dm.F;
    for (int k = l; k < nf; k += 4) {
      const float4 a = nhs[k];          // normal, then the face's h
      const int e = k * NRw + row;
      float u;
      if (Update) {
        const float vi = p0 * a.x + p1 * a.y + p2 * a.z;
        const float v = alpha * vi + (1.f - alpha) * zs[e] + ys[e];
        const float zn = v > a.w ? a.w : v;
        const float yn = clampf(v - zn, -yci, yci);
        zs[e] = zn;
        ys[e] = yn;
        u = zn - yn;
      } else {
        u = zs[e] - ys[e];
      }
      w0 = fmaf(u, a.x, w0);
      w1 = fmaf(u, a.y, w1);
      w2 = fmaf(u, a.z, w2);
    }
    float wv = 0.f, wa = 0.f;
    if (l < 3) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {     // +vel, +acc, -vel, -acc
        const int e = (Fw + 3 * t + l) * NRw + row;
        float u;
        if (Update) {
          const float val = (t & 1) ? acc : vel;
          const float vi = ((t >= 2) ? -val : val) * smv;
          const float v = alpha * vi + (1.f - alpha) * zs[e] + ys[e];
          const float hs = hbox[s * kBoxSlots + l * 4 + t];
          const float zn = v > hs ? hs : v;
          const float yn = clampf(v - zn, -yci, yci);
          zs[e] = zn;
          ys[e] = yn;
          u = zn - yn;
        } else {
          u = zs[e] - ys[e];
        }
        u = ((t >= 2) ? -u : u) * smv;
        if (t & 1) wa += u;
        else wv += u;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      w0 += __shfl_xor_sync(gmask, w0, off, 4);
      w1 += __shfl_xor_sync(gmask, w1, off, 4);
      w2 += __shfl_xor_sync(gmask, w2, off, 4);
    }
    float* Wr = W + row * 9;
    if (l == 3) {
      Wr[0] = w0;
      Wr[1] = w1;
      Wr[2] = w2;
    } else {
      Wr[3 + l] = wv;
      Wr[6 + l] = wa;
    }
  }
}

// Where a block keeps Kx: its live block in shared memory as f64 (converted
// once per launch, so an iteration converts nothing), as f32 (converted
// term by term), or in device memory (read through L1 as f32).
enum KxMode { kKxF64 = 0, kKxF32 = 1, kKxGlobal = 2 };

// Row stride of Kx's live block of na rows in shared memory, in elements:
// f32 rows 4 (mod 8) floats apart and f64 rows 2 (mod 4) doubles apart, so
// the 8 rows a quarter-warp reads with 16-byte loads hit 32 banks.
__host__ __device__ inline int kx_stride(int na, bool f64) {
  return round_up(na, 8) + (f64 ? 2 : 4);
}

// Offset (words) of Kx's live block in shared memory, after the fixed part
// and the z / yh slots of Ls live segments with at most Fw live faces.
__host__ __device__ inline int kx_offset(const Dims& d, const Layout& L, int Ls,
                                         int Fw) {
  return round_up(L.small + 2 * (Fw + kBoxSlots) * zy_stride(Ls * d.R), 4);
}

// Where a block of `cap` words keeps Kx for that live state: f64 if its live
// block fits so after the slots, else f32 if it fits so, else device memory.
__host__ __device__ inline int kx_mode(const Dims& d, const Layout& L, int cap,
                                       int Ls, int Fw) {
  const int na = Ls * 3 * d.D;
  const long long room = cap - (long long)kx_offset(d, L, Ls, Fw);
  return 2LL * na * kx_stride(na, true) <= room          ? kKxF64
         : (long long)na * kx_stride(na, false) <= room ? kKxF32
                                                         : kKxGlobal;
}

// Phase B: xt = clip(Kx rrow) over the na live rows, x relaxed.  The
// products and their sum are taken in f64 from the f32 operands (rrow is
// kept as f64 for it): Kx rrow cancels strongly (rho_e = 100 rho_i puts
// large equality terms into rrow that Kx maps back to a moderate x), and
// an f32 sum there is what carries most of an f32 chunk's error.  4 lanes
// per row (lane = part * 8 + row in warp), reduced over lanes ^8 and ^16;
// kx and ldk as KxMode says (ldk in elements; device memory: stride n).
template <int Mode>
__device__ __forceinline__ void xt_phase(int na, int na8, const void* __restrict__ kx,
                                         int ldk, const double* __restrict__ rrow,
                                         float* __restrict__ xt, float* __restrict__ x,
                                         float alpha, int warp, int lane) {
  const int part = lane >> 3, sub = lane & 7;
  for (int i0 = warp * 8; i0 < na; i0 += kWarps * 8) {
    const int i = i0 + sub;
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
    if (i < na) {
      if (Mode == kKxF64) {
        const double2* kr = static_cast<const double2*>(kx) + i * (ldk / 2);
        const double2* rr = reinterpret_cast<const double2*>(rrow);
        const int nc = na8 / 2;
        for (int c = part; c < nc; c += 8) {
          const double2 k2 = kr[c], r2 = rr[c];
          a0 = fma(k2.x, r2.x, a0);
          a1 = fma(k2.y, r2.y, a1);
          if (c + 4 < nc) {
            const double2 k3 = kr[c + 4], r3 = rr[c + 4];
            a2 = fma(k3.x, r3.x, a2);
            a3 = fma(k3.y, r3.y, a3);
          }
        }
      } else if (Mode == kKxF32) {
        const float4* kr = static_cast<const float4*>(kx) + i * (ldk / 4);
        const double2* rr = reinterpret_cast<const double2*>(rrow);
        for (int c = part; c < na8 / 4; c += 4) {
          const float4 k4 = kr[c];
          const double2 r01 = rr[2 * c], r23 = rr[2 * c + 1];
          a0 = fma((double)k4.x, r01.x, a0);
          a1 = fma((double)k4.y, r01.y, a1);
          a2 = fma((double)k4.z, r23.x, a2);
          a3 = fma((double)k4.w, r23.y, a3);
        }
      } else {
        const float* kr = static_cast<const float*>(kx) + (size_t)i * ldk;
        for (int c = part; c < na; c += 8) {
          a0 = fma((double)__ldg(kr + c), rrow[c], a0);
          if (c + 4 < na) a1 = fma((double)__ldg(kr + c + 4), rrow[c + 4], a1);
        }
      }
    }
    double t = (a0 + a1) + (a2 + a3);
    t += __shfl_xor_sync(0xffffffffu, t, 8);
    t += __shfl_xor_sync(0xffffffffu, t, 16);
    if (i < na && part == 0) {
      const float v = clampf((float)t, -1e6f, 1e6f);
      xt[i] = v;
      x[i] = alpha * v + (1.f - alpha) * x[i];
    }
  }
}

template <int Mode, int kD, int kR>
__device__ __forceinline__ void iterate(
    const Dims& dm, int n_iters, float sigma, float alpha, float rho_i,
    float rho_e, float yci, float yce, int na, int NRa, int NRw, int Fw,
    const void* __restrict__ kx, int ldk, float* __restrict__ smem,
    const Layout& L, float* __restrict__ zs, float* __restrict__ ys, int tid
#ifdef ADMM_CHUNK_PROFILE
    , unsigned* pmisc, long long* pacc
#endif
) {
  const int R = kR ? kR : dm.R, D = kD ? kD : dm.D, m = dm.m;
  const int warp = tid >> 5, lane = tid & 31;
  const int na8 = round_up(na, 8);
  float* x = smem + L.x;
  double* rrow = reinterpret_cast<double*>(smem + L.rrow);
  float* xt = smem + L.xt;
  const float* beq = smem + L.beq;
  float* yeh = smem + L.yeh;
  float* q = smem + L.q;
  const float* aval = smem + L.aval;
  const int* ablk = reinterpret_cast<const int*>(smem + L.ablk);
  const int* colp = reinterpret_cast<const int*>(smem + L.colp);
  const int* cole = reinterpret_cast<const int*>(smem + L.cole);
  const float* bas = smem + L.bas;
  float* W = smem + L.W;
  const float4* nh = reinterpret_cast<const float4*>(smem + L.nh);
  const float* hbox = smem + L.hbox;
  const float* sm = smem + L.sm;
  const int* fcnt = reinterpret_cast<const int*>(smem + L.fcnt);

  for (int it = 0; it < n_iters; ++it) {
    // (A) rrow = sigma x + rho_e Aeq^T q + rho_i G^T (z - yh): 4 lanes per
    // variable (lane = part * 8 + variable in warp), each over a quarter of
    // the samples (R / 4 consecutive ones when R is known, unrolled, else
    // every 4th) and every 4th Aeq entry of the variable's block
    {
      PROF_WARP_START
      const int part = lane >> 3, sub = lane & 7;
      for (int v0 = warp * 8; v0 < na; v0 += kWarps * 8) {
        const int v = v0 + sub;
        float g = 0.f, e = 0.f;
        if (v < na) {
          const int sj = v / D, d = v - sj * D, s = sj / 3, j = sj - s * 3;
          if constexpr (kR > 0 && kR % 4 == 0) {
            constexpr int kRP = kR / 4;
            const int rb = part * kRP;
            const float* w = W + (s * R + rb) * 9;
            float g0 = 0.f, g1 = 0.f, g2 = 0.f;
#pragma unroll
            for (int k = 0; k < kRP; ++k) {
              g0 = fmaf(bas[(rb + k) * D + d], w[k * 9 + j], g0);
              g1 = fmaf(bas[(R + rb + k) * D + d], w[k * 9 + 3 + j], g1);
              g2 = fmaf(bas[(2 * R + rb + k) * D + d], w[k * 9 + 6 + j], g2);
            }
            g = (g0 + g1) + g2;
          } else {
            for (int r = part; r < R; r += 4) {
              const float* w = W + (s * R + r) * 9;
              g = fmaf(bas[r * D + d], w[j], g);
              g = fmaf(bas[(R + r) * D + d], w[3 + j], g);
              g = fmaf(bas[(2 * R + r) * D + d], w[6 + j], g);
            }
          }
          for (int c = colp[sj] + part; c < colp[sj + 1]; c += 4) {
            const int ent = cole[c];
            e = fmaf(aval[ent * D + d], q[ent >> 1], e);
          }
        }
        float t = rho_e * e + rho_i * g;
        t += __shfl_xor_sync(0xffffffffu, t, 8);
        t += __shfl_xor_sync(0xffffffffu, t, 16);
        if (v < na && part == 0) rrow[v] = (double)(sigma * x[v] + t);
      }
      PROF_WARP_END(1)
    }
    __syncthreads();
    PROF_MARK(1)

    // (B) xt = clip(Kx rrow); x relaxed
    {
      PROF_WARP_START
      xt_phase<Mode>(na, na8, kx, ldk, rrow, xt, x, alpha, warp, lane);
      PROF_WARP_END(2)
    }
    __syncthreads();
    PROF_MARK(2)

    // (C) the sample rows' updates and next G^T partials; the equality
    // rows' dual update and residual q on the warps from the top down
    PROF_WARP_START
    rows_phase<true, kD, kR>(dm, NRa, NRw, Fw, zs, ys, xt, bas, nh, hbox, sm, fcnt, W,
                     alpha, yci, tid);
    for (int k = kThreads - 1 - tid; k < m; k += kThreads) {
      float v = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* av = aval + (2 * k + hf) * D;
        const float* xs = xt + ablk[2 * k + hf] * D;
        for (int d = 0; d < D; ++d) v = fmaf(av[d], xs[d], v);
      }
      const float y = clampf(yeh[k] + alpha * (v - beq[k]), -yce, yce);
      yeh[k] = y;
      q[k] = beq[k] - y;
    }
    PROF_WARP_END(3)
    __syncthreads();
    PROF_MARK(3)
  }
}

// kD, kR: the coefficient count D and sample count R fixed at compile time
// (the deploy shape), or 0 to take them from dm.
template <int kD, int kR>
__global__ void __launch_bounds__(kThreads, 2)
admm_chunk_kernel(Dims dm, int n_iters, float sigma, float alpha, int cap,
                  const float* __restrict__ g_kx, const float* __restrict__ g_aval,
                  const int* __restrict__ g_ablk, const float* __restrict__ g_beq,
                  const float* __restrict__ g_nrm, const float* __restrict__ g_h,
                  const float* __restrict__ g_sm, const float* __restrict__ g_rhoi,
                  const float* __restrict__ g_rhoe, const float* __restrict__ g_bas,
                  const float* __restrict__ g_x, const float* __restrict__ g_z,
                  const float* __restrict__ g_yh, const float* __restrict__ g_yeh,
                  float* __restrict__ o_x, float* __restrict__ o_z,
                  float* __restrict__ o_yh, float* __restrict__ o_yeh,
                  long long* __restrict__ prof) {
  extern __shared__ __align__(16) float smem[];
#ifdef ADMM_CHUNK_PROFILE
  unsigned* pmisc = reinterpret_cast<unsigned*>(smem + layout(dm).misc) + 8;
  long long* pacc = reinterpret_cast<long long*>(pmisc + 24);
#endif
  const int S = dm.S, F = dm.F, n = dm.n, m = dm.m;
  const int R = kR ? kR : dm.R, D = kD ? kD : dm.D;
  const int NR = dm.NR, C = dm.C, S3 = dm.S3;
  const int b = blockIdx.x, tid = threadIdx.x;
  const Layout L = layout(dm);
  float* x = smem + L.x;
  double* rrow = reinterpret_cast<double*>(smem + L.rrow);
  float* xt = smem + L.xt;
  float* beq = smem + L.beq;
  float* yeh = smem + L.yeh;
  float* q = smem + L.q;
  float* aval = smem + L.aval;
  int* ablk = reinterpret_cast<int*>(smem + L.ablk);
  int* colp = reinterpret_cast<int*>(smem + L.colp);
  int* cole = reinterpret_cast<int*>(smem + L.cole);
  float* bas = smem + L.bas;
  float4* nh = reinterpret_cast<float4*>(smem + L.nh);
  float* hbox = smem + L.hbox;
  float* sm = smem + L.sm;
  int* colnz = reinterpret_cast<int*>(smem + L.colnz);
  int* fidx = reinterpret_cast<int*>(smem + L.fidx);
  int* fcnt = reinterpret_cast<int*>(smem + L.fcnt);
  int* segbad = reinterpret_cast<int*>(smem + L.segbad);
  int* misc = reinterpret_cast<int*>(smem + L.misc);

  const float* s_kx = g_kx + (size_t)b * n * n;
  const float* s_z = g_z + (size_t)b * NR * C;
  const float* s_yh = g_yh + (size_t)b * NR * C;

  // ---- load: small inputs; flags cleared ---------------------------------
  for (int i = tid; i < dm.n8 + 8; i += kThreads) {
    if (i < dm.n8) {
      x[i] = i < n ? g_x[(size_t)b * n + i] : 0.f;
      xt[i] = 0.f;
    }
    rrow[i] = 0.0;
  }
  for (int i = tid; i < m; i += kThreads) {
    beq[i] = g_beq[(size_t)b * m + i];
    yeh[i] = g_yeh[(size_t)b * m + i];
    q[i] = beq[i] - yeh[i];
  }
  for (int i = tid; i < 2 * m * D; i += kThreads) aval[i] = g_aval[(size_t)b * 2 * m * D + i];
  for (int i = tid; i < 2 * m; i += kThreads) ablk[i] = g_ablk[(size_t)b * 2 * m + i];
  for (int i = tid; i < 3 * R * D; i += kThreads) bas[i] = g_bas[i];
  for (int i = tid; i < S * C; i += kThreads) colnz[i] = 0;
  for (int i = tid; i < S; i += kThreads) {
    sm[i] = g_sm[(size_t)b * S + i];
    segbad[i] = 0;
  }
  if (tid < 64) misc[tid] = 0;
  __syncthreads();
#ifdef ADMM_CHUNK_PROFILE
  if (tid == 0) pacc[15] = clock64();
#endif

  // ---- load: what each segment and face slot needs ------------------------
  // segbad[s]: the segment cannot be skipped; colnz[s][slot]: a nonzero (or
  // non-finite) z or yh in that slot column; misc[kDense]: a non-finite
  // input, after which nothing is skipped (NaN and inf spread through the
  // dense iteration)
  int dense = 0;
  for (int i = tid; i < NR * C; i += kThreads) {
    const float zv = s_z[i], yv = s_yh[i];
    if (zv != 0.f || yv != 0.f) {
      const int row = i / C, s = row / R;
      colnz[s * C + (i - row * C)] = 1;
      segbad[s] = 1;
      dense |= !isfinite(zv) || !isfinite(yv);
    }
  }
  for (int i = tid; i < S * F * 3; i += kThreads) {
    const float a = g_nrm[(size_t)b * S * F * 3 + i];
    const int sf = i / 3;
    reinterpret_cast<float*>(nh)[sf * 4 + (i - sf * 3)] = a;
    if (a != 0.f) segbad[sf / F] = 1;
    dense |= !isfinite(a);
  }
  for (int i = tid; i < S * C; i += kThreads) {
    const float hv = g_h[(size_t)b * S * C + i];
    const int s = i / C, slot = i - s * C;
    if (slot < F) reinterpret_cast<float*>(nh)[(s * F + slot) * 4 + 3] = hv;
    else hbox[s * kBoxSlots + slot - F] = hv;
    if (!(hv >= 0.f)) segbad[s] = 1;
    dense |= !isfinite(hv);
  }
  for (int i = tid; i < n; i += kThreads) {
    if (x[i] != 0.f) segbad[i / (3 * D)] = 1;
    dense |= !isfinite(x[i]);
  }
  for (int i = tid; i < S; i += kThreads)
    if (sm[i] != 0.f) segbad[i] = 1;
  for (int i = tid; i < m; i += kThreads) dense |= !isfinite(beq[i]) || !isfinite(yeh[i]);
  for (int i = tid; i < 2 * m * D; i += kThreads) dense |= !isfinite(aval[i]);
  // an Aeq block index out of range is clamped, and the scenario's outputs
  // are NaN (the plain version raises on it)
  for (int i = tid; i < 2 * m; i += kThreads)
    if (ablk[i] < 0 || ablk[i] >= S3) {
      ablk[i] = 0;
      misc[kBadIndex] = 1;
    }
  __syncthreads();
  if (tid == 0) {
    int Ls = 0;
    for (int s = 0; s < S; ++s)
      if (segbad[s]) Ls = s + 1;
    misc[kLs] = Ls;
  }
  __syncthreads();

  // ---- load: Kx finite, and the skipped segments' coupling to the live
  // ones zero: Kx's blocks between them, and the equality rows that reach
  // a skipped segment carry zero beq and yeh and no live coefficient ------
  {
    const int Lc = misc[kLs], nac = Lc * 3 * D, nb = Lc * 3;
    int bad = 0;
    for (int i = tid; i < n * n; i += kThreads) {
      const float v = s_kx[i];
      const int r = i / n, c = i - r * n;
      dense |= !isfinite(v);
      bad |= (r < nac) != (c < nac) && v != 0.f;
    }
    for (int k = tid; k < m; k += kThreads) {
      bool touches = false, live = false;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        bool nz = false;
        for (int d = 0; d < D; ++d) nz |= aval[(2 * k + hf) * D + d] != 0.f;
        if (ablk[2 * k + hf] >= nb) touches |= nz;
        else live |= nz;
      }
      bad |= touches && (live || beq[k] != 0.f || yeh[k] != 0.f);
    }
    if (dense) misc[kDense] = 1;
    if (bad) misc[kBad] = 1;
  }
  __syncthreads();
  const bool all_live = misc[kDense] != 0;
  const int Ls = (all_live || misc[kBad]) ? S : misc[kLs];

  // ---- load: live face slots, compacted per segment ----------------------
  // fidx[s][k]: the face at live position k; colnz[s][f]: k, or -1
  for (int s = tid; s < Ls; s += kThreads) {
    int k = 0;
    for (int f = 0; f < F; ++f) {
      const float4 a = nh[s * F + f];
      const bool live = all_live || a.x != 0.f || a.y != 0.f || a.z != 0.f ||
                        !(a.w >= 0.f) || colnz[s * C + f] != 0;
      if (live) {
        nh[s * F + k] = a;
        fidx[s * F + k] = f;
      }
      colnz[s * C + f] = live ? k++ : -1;
    }
    fcnt[s] = k;
  }
  // Aeq^T's entries per (segment, axis) block: CSR over entries 2 k + half
  if (tid <= S3) {
    int c = 0;
    for (int e = 0; e < 2 * m; ++e) c += ablk[e] < tid;
    colp[tid] = c;
    if (tid < S3) {
      for (int e = 0; e < 2 * m; ++e)
        if (ablk[e] == tid) cole[c++] = e;
    }
  }
  __syncthreads();
  int Fw = 0;
  for (int s = 0; s < Ls; ++s) Fw = max(Fw, fcnt[s]);
  const int na = Ls * 3 * D, NRa = Ls * R, NRw = zy_stride(NRa);
  const int slots = Fw + kBoxSlots;
  // shared memory after the fixed part: the live z and yh slots, then
  // Kx's live block (kx_mode)
  float* zs = smem + L.small;
  float* ys = zs + slots * NRw;
  float* kxs = smem + kx_offset(dm, L, Ls, Fw);
  const int mode = kx_mode(dm, L, cap, Ls, Fw);
  const int ldk_s = mode == kKxGlobal ? n : kx_stride(na, mode == kKxF64);
#ifdef ADMM_CHUNK_PROFILE
  if (tid == 0) pacc[kPhases] = mode;   // the load phase has no warp count
#endif

  // ---- load: live z / yh slots, Kx's live block ---------------------------
  for (int i = tid; i < slots * NRa; i += kThreads) {
    const int k = i / NRa, row = i - k * NRa, s = row / R;
    int slot = -1;
    if (k >= Fw) {
      const int bx = k - Fw, t = bx / 3, j = bx - t * 3;
      slot = F + j * 4 + t;
    } else if (k < fcnt[s]) {
      slot = fidx[s * F + k];
    }
    const int e = k * NRw + row;
    zs[e] = slot >= 0 ? s_z[row * C + slot] : 0.f;
    ys[e] = slot >= 0 ? s_yh[row * C + slot] : 0.f;
  }
  if (mode != kKxGlobal) {
    const int na8 = round_up(na, 8);
    double* kxd = reinterpret_cast<double*>(kxs);
    for (int i = tid; i < na * na8; i += kThreads) {
      const int r = i / na8, c = i - r * na8;
      const float v = c < na ? s_kx[r * n + c] : 0.f;
      if (mode == kKxF64) kxd[r * ldk_s + c] = (double)v;
      else kxs[r * ldk_s + c] = v;
    }
  }
  const float rho_i = g_rhoi[b], rho_e = g_rhoe[b];
  const float yci = 1e6f / rho_i, yce = 1e6f / rho_e;
  __syncthreads();
  // the G^T partials of the initial state
  rows_phase<false, kD, kR>(dm, NRa, NRw, Fw, zs, ys, xt, bas, nh, hbox, sm, fcnt,
                    smem + L.W, alpha, yci, tid);
  __syncthreads();
  PROF_MARK(0)

#ifdef ADMM_CHUNK_PROFILE
#define ITERATE(M, KX)                                                       \
  iterate<M, kD, kR>(dm, n_iters, sigma, alpha, rho_i, rho_e, yci, yce, na, \
                     NRa, NRw, Fw, KX, ldk_s, smem, L, zs, ys, tid,        \
                     pmisc, pacc)
#else
#define ITERATE(M, KX)                                                       \
  iterate<M, kD, kR>(dm, n_iters, sigma, alpha, rho_i, rho_e, yci, yce, na, \
                     NRa, NRw, Fw, KX, ldk_s, smem, L, zs, ys, tid)
#endif
  if (mode == kKxF64) ITERATE(kKxF64, kxs);
  else if (mode == kKxF32) ITERATE(kKxF32, kxs);
  else ITERATE(kKxGlobal, s_kx);
#undef ITERATE

  // ---- store: live slots from shared memory, the rest as it came in ------
  const float nan_or_0 = misc[kBadIndex] ? nanf("") : 0.f;
  for (int i = tid; i < n; i += kThreads) o_x[(size_t)b * n + i] = x[i] + nan_or_0;
  for (int i = tid; i < NR * C; i += kThreads) {
    const int row = i / C, slot = i - row * C, s = row / R;
    int k = -1;
    if (row < NRa) {
      if (slot >= F) {
        const int bx = slot - F, j = bx >> 2, t = bx & 3;
        k = Fw + 3 * t + j;
      } else {
        k = colnz[s * C + slot];
      }
    }
    const int e = k * NRw + row;
    o_z[(size_t)b * NR * C + i] = (k >= 0 ? zs[e] : s_z[i]) + nan_or_0;
    o_yh[(size_t)b * NR * C + i] = (k >= 0 ? ys[e] : s_yh[i]) + nan_or_0;
  }
  for (int i = tid; i < m; i += kThreads)
    o_yeh[(size_t)b * m + i] = yeh[i] + nan_or_0;
#ifdef ADMM_CHUNK_PROFILE
  __syncthreads();
  PROF_MARK(4)
  if (tid == 0)
    for (int k = 0; k < 3 * kPhases; ++k)
      prof[(size_t)b * 3 * kPhases + k] = pacc[k];
#endif
}

using Kernel = decltype(&admm_chunk_kernel<0, 0>);

// The instance for this shape: the deploy shape's D and R compiled in, or
// the generic one.
Kernel kernel_for(const Dims& d) {
  if (d.D == 8 && d.R == 20) return admm_chunk_kernel<8, 20>;
  return admm_chunk_kernel<0, 0>;
}

Dims make_dims(int S, int R, int F, int D, int m) {
  const int n = S * 3 * D;
  return Dims{S, R, F, D, n, m, S * R, F + kBoxSlots, 3 * S, round_up(n, 8)};
}

// Dynamic shared memory of one launch (bytes), or 0 when the fixed part and
// one scenario's z / yh slots (every slot live) do not fit in what a block
// may opt in to.  The dense state (those and all of Kx as f32) where it fits
// in half an SM; else half an SM where the fixed part and the slots fit
// there (two blocks per SM); else one block per SM, with the dense state or
// all that a block may opt in to.  Kx's live block takes what is left after
// a scenario's live slots (kx_mode), or stays in device memory.
size_t launch_bytes(const Dims& d) {
  const long long slots = layout(d).small + 2LL * d.C * zy_stride(d.NR);
  const long long dense =
      round_up((int)slots, 4) + (long long)d.n * kx_stride(d.n, false);
  int dev = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  const long long most = optin / 4;
  if (slots > most) return 0;
  const long long two = ((long long)per_sm / 2 - reserved) / 16 * 16 / 4;
  const long long words = dense <= two   ? dense
                          : slots <= two ? two
                                         : (dense < most ? dense : most);
  return (size_t)words * 4;
}

}  // namespace

extern "C" {

// Launches one block per scenario on `stream`; returns cudaGetLastError(),
// or cudaErrorInvalidValue (without launching) when the shape does not fit:
// F + 12 <= 64 inequality slots, an even D, and the fixed part and one
// scenario's z / yh slots in the shared memory a block may opt in to (Kx
// may stay in device memory).  All pointers are device, contiguous, with
// the shapes of the Python wrapper (allocnet_tpu_torch/ops/admm_chunk.py):
// f32, and int32 block indices `ablk`.  `prof` is (B, 5) int64 in the profile build, else unused.
int admm_chunk_launch(int B, int S, int R, int F, int D, int m, int n_iters,
                      float sigma, float alpha,
                      const float* kx, const float* aval, const int* ablk,
                      const float* beq, const float* nrm, const float* h,
                      const float* sm, const float* rhoi, const float* rhoe,
                      const float* bas, const float* x, const float* z,
                      const float* yh, const float* yeh, float* ox, float* oz,
                      float* oyh, float* oyeh, long long* prof, void* stream) {
  const Dims d = make_dims(S, R, F, D, m);
  if (d.C > kMaxSlots || D % 2 != 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = launch_bytes(d);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opts in (per device,
  // so on every launch)
  const Kernel kernel = kernel_for(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      d, n_iters, sigma, alpha, (int)(bytes / 4), kx, aval, ablk, beq, nrm, h,
      sm, rhoi, rhoe, bas, x, z, yh, yeh, ox, oz, oyh, oyeh, prof);
  return (int)cudaGetLastError();
}

// Dynamic shared memory one launch asks for, in bytes (0: shape refused).
size_t admm_chunk_smem_bytes(int S, int R, int F, int D, int m) {
  return launch_bytes(make_dims(S, R, F, D, m));
}

// Blocks (scenarios) resident per SM at that shared memory, or -1.
int admm_chunk_blocks_per_sm(int S, int R, int F, int D, int m) {
  const Dims d = make_dims(S, R, F, D, m);
  const size_t bytes = launch_bytes(d);
  const Kernel kernel = kernel_for(d);
  int blocks = -1;
  if (bytes == 0 ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                    bytes) != cudaSuccess)
    return -1;
  return blocks;
}

// Where a block keeps Kx (0: f64 in shared memory, 1: f32 there, 2: device
// memory) for a scenario with Ls live segments and at most Fw live face
// slots in one, at this shape's launch; -1 if the shape is refused.
int admm_chunk_kx_mode(int S, int R, int F, int D, int m, int Ls, int Fw) {
  const Dims d = make_dims(S, R, F, D, m);
  const size_t bytes = launch_bytes(d);
  if (bytes == 0) return -1;
  return kx_mode(d, layout(d), (int)(bytes / 4), Ls, Fw);
}

// Phases of the profile build, comma-separated, in prof's column order.
const char* admm_chunk_phase_names() { return ADMM_PHASES; }

const char* admm_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
