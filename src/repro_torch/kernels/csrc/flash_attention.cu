// Flash attention forward: causal GQA attention with an optional sliding
// window and tanh logit softcap, one online softmax over KV tiles.
//
// Replaces the TPU kernel repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py:127, body _flash_fwd_kernel :34),
// which walks a (batch x head, q block, kv block) grid with the KV axis
// innermost and keeps the output block and the softmax statistics in VMEM
// scratch.  Here the KV axis is a loop inside the block.  For q pre-scaled
// by 1/sqrt(D) in its own dtype (the wrapper does that, as the JAX function
// does before its pallas_call) both kernels of this file compute:
//   * logits = q . k in f32; with softcap > 0, tanh(logits / cap) * cap;
//   * mask: q_pos >= k_pos (q_offset 0), k_pos < Sk, q_pos < Sq, and with
//     window > 0 also q_pos - k_pos < window; masked logits are the finite
//     -1e30 of the reference, never -inf (exp(-inf - -inf) would be NaN);
//   * m starts at -1e30, so a row whose first live tile is all masked gets
//     p = 1 there and a later tile's corr = exp(-1e30 - m) = 0 wipes it, as
//     in the reference;
//   * query head h reads KV head h / (H / KV) (heads-major GQA);
//   * out = acc / max(l, 1e-30), written in q's dtype;
//   * when the caller passes an lse buffer (training: the backward kernel of
//     csrc/flash_attention_bwd.cu reads it), each row's log-sum-exp
//     m + log(max(l, 1e-30)) in natural-log units of the softcapped, masked
//     logits, f32, (B, H, Sq); serving passes none and writes nothing more.
// Layouts: q and out (B, Sq, H, D), k and v (B, Sk, KV, D), contiguous, the
// JAX layout with no transposes; D a multiple of 8 up to 256.
//
// Bound on the H100: operations.  4 * H * D flops per live (q, k) pair on
// the tensor cores' 989 TFLOP/s (bf16), against (2*Sq*H*D + 2*Sk*KV*D) * 2
// bytes at 3.35 TB/s: at Sq = Sk = 7,000, H = 16, KV = 8, D = 256 a global
// layer needs 0.41 ms of operations and 0.05 ms of bytes.
//
// bf16, flash_fwd_wgmma: the tensor-core kernel for Hopper (sm_90a).
//   * One block of 384 threads per (b*h, 128-query tile): warpgroups 0 and
//     1 each own 64 query rows and compute; one thread of warpgroup 2 loads.
//     setmaxnreg gives the consumers 240 registers and the loader 24: the
//     O accumulator alone is 64 x 256 f32 a warpgroup, 128 registers a
//     thread at D = 256.
//   * S = Q . K^T and O += P . V both run as wgmma.mma_async (bf16 in, f32
//     accumulate).  S reads Q and K from shared memory, both K-major.  P
//     stays in registers: the f32 S accumulator's layout is the bf16 A
//     operand's, so P is rounded to bf16 in place and fed as A.  V is the B
//     operand read through the descriptor's transpose (MN-major) bit.
//   * Tiles stay bf16 in shared memory, 128-byte swizzled as wgmma reads
//     them: Q (128 x D, 64 KB at D = 256) once, then K and V tiles of 64
//     keys through a 2-stage ring (2 x (32 + 32) KB), 192 KB in all.  Every
//     tile is cut into 64 x 64 boxes (8 KB, one 128-byte row each).
//   * The loader moves each box with one TMA copy through a 4-D tensor map
//     {D, heads, S, B} over the JAX layout (a head's rows are KV*D apart),
//     box {64, 1, 64, 1}; the map's zero fill pads both the ragged S edge
//     (within its own batch: the batch is a dimension of its own) and
//     D < 64.  Completion lands on mbarriers: full barriers per stage for K
//     and V, an empty barrier per stage that the 8 consumer warps arrive on.
//   * Each block walks only the live 64-key tiles [lo, hi) of its query
//     tile, from the plan the wrapper computes (kernels/flash_attention.py:
//     tile_plan, repro.models.layers._causal_kv_range at 128 x 64 tiles),
//     heaviest tiles first; tiles above the diagonal or wholly outside the
//     window are never loaded.
//   * The softmax runs in registers, in log2 units (logits times log2(e),
//     then exp2f); the causal, window and edge masks only on the tiles that
//     cross them; the softcap as tanh.approx(x * (1 / cap)) on the MUFU.
//     P is rounded to bf16 for P . V (the plain version keeps it f32; held
//     to the bf16 tolerance), l sums the f32 p.
//
// f32, flash_fwd_f32: the scalar kernel (the card has no f32 tensor-core
// rate, and TF32 would break the f32 tolerance).  One block of 256 threads
// per (b*h, 64-query tile), heaviest first; Q, K and V tiles in f32 shared
// memory (rows padded to D + 1 floats), each thread a 4 x 4 micro-tile of
// the logits and 4 rows x D/16 columns of the accumulator in registers,
// plain f32 FMAs on the CUDA cores; expf and tanhf, so results stay within
// a few ulp of the torch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

#define MASKED (-1e30f)

// ===========================================================================
// f32: the scalar kernel
// ===========================================================================

namespace scalar {

#define BQ 64
#define BK 64
#define THREADS 256

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// Rows [0, 64) of D elements, row r at src + r * stride, into dst rows of
// ld floats; rows at or past n_valid are zeros.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int64_t stride, int n_valid,
                                          int D) {
  constexpr int VEC = 4;
  const int per_row = D / VEC;
  for (int idx = threadIdx.x; idx < BK * per_row; idx += THREADS) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * VEC;
    float v[VEC];
    if (r < n_valid) {
      load16(src + r * stride + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * ld + c + e] = v[e];
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int H, int KV, int Sq, int Sk, int D,
              int window, float softcap) {
  constexpr int DJ = DMAX / 16;          // accumulator columns per thread
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int ldp = BK + 1;
  float* Qs = smem;                      // BQ x ld
  float* Ks = Qs + BQ * ld;              // BK x ld
  float* Vs = Ks + BK * ld;              // BK x ld
  float* Ps = Vs + BK * ld;              // BQ x ldp

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qi * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;
  const float* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)kvh * D;
  const float* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)kvh * D;
  load_tile(Qs, ld, q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D,
            q_stride, min(BQ, Sq - q0), D);

  // live KV tiles [lo, hi) (layers._causal_kv_range with q_offset 0; the
  // last query row is capped at Sq - 1)
  const int nk = (Sk + BK - 1) / BK;
  const int hi = min((min(q0 + BQ, Sq) - 1) / BK + 1, nk);
  int lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    lo = first > 0 ? first / BK : 0;
  }

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                     // the last tile's reads are done
    const int n_valid = min(BK, Sk - k0);
    load_tile(Ks, ld, kb + (int64_t)k0 * kv_stride, kv_stride, n_valid, D);
    load_tile(Vs, ld, vb + (int64_t)k0 * kv_stride, kv_stride, n_valid, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        bool live = qp >= kp && kp < Sk && qp < Sq;
        if (window > 0) live = live && qp - kp < window;
        x = live ? x : MASKED;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P . V; keys past Sk have zero V rows
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? Vs[c * ld + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    float* row = o + ((int64_t)b * Sq + qp) * q_stride + (int64_t)h * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = acc[i][j] / denom;
    }
    if (lse != nullptr && tx == 0)
      lse[(int64_t)blockIdx.y * Sq + qp] = m[i] + logf(denom);
  }
}

template <int DMAX>
static int launch(const float* q, const float* k, const float* v, float* o,
                  float* lse, int B, int Sq, int Sk, int H, int KV, int D,
                  int window, float softcap, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_fwd_f32<DMAX><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, H, KV, Sq, Sk, D, window, softcap);
  return (int)cudaGetLastError();
}

#undef BQ
#undef BK
#undef THREADS

}  // namespace scalar

// ===========================================================================
// bf16: the tensor-core kernel (wgmma + TMA)
// ===========================================================================

namespace tc {

using namespace hopper;

constexpr int BK = 64;               // keys a tile
constexpr int THREADS = 384;         // warpgroups 0-1 consume, 2 loads
constexpr int STAGES = 2;            // K/V ring depth
// Dynamic shared memory of a block at padded head dim dp: 1 KB of slack to
// align the tiles to the 1,024-byte swizzle atom, Q (2 x dp/64 panels), K
// and V (STAGES x dp/64 panels each), 7 mbarriers.
constexpr int smem_bytes(int dp) {
  return 1024 + (2 + 2 * STAGES) * (dp / 64) * PANEL + 64;
}

// DP: D padded to a multiple of 64 (64, 128, 192 or 256).  Grid (B*H,
// tiles); plan[3 * blockIdx.y + {0, 1, 2}] = (q0, lo, hi) of the block's
// query tile, heaviest first.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                const int* __restrict__ plan, int H, int KV, int Sq, int Sk,
                int D, int window, float softcap) {
  constexpr int NP = DP / 64;          // 64-column panels of a tile
  constexpr int NO = DP / 2;           // O accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // [2][NP]
  const uint32_t k_s = q_s + 2 * NP * PANEL;                  // [STAGES][NP]
  const uint32_t v_s = k_s + STAGES * NP * PANEL;             // [STAGES][NP]
  const uint32_t q_full = v_s + STAGES * NP * PANEL;
  const uint32_t k_full = q_full + 8;                         // [STAGES]
  const uint32_t v_full = k_full + 8 * STAGES;                // [STAGES]
  const uint32_t kv_empty = v_full + 8 * STAGES;              // [STAGES]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = plan[3 * blockIdx.y];
  const int lo = plan[3 * blockIdx.y + 1];
  const int n = plan[3 * blockIdx.y + 2] - lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 8);  // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- loader: one thread issues every TMA copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * NP * PANEL);
      for (int c = 0; c < 2; ++c)
        for (int p = 0; p < NP; ++p)
          tma_load(q_s + (c * NP + p) * PANEL, &qmap, q_full, 64 * p, h,
                   q0 + 64 * c, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const int k0 = (lo + i) * BK;
        if (i >= STAGES) mbar_wait(kv_empty + 8 * s, (i / STAGES - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, NP * PANEL);
        for (int p = 0; p < NP; ++p)
          tma_load(k_s + (s * NP + p) * PANEL, &kmap, k_full + 8 * s,
                   64 * p, kvh, k0, b);
        mbar_expect_tx(v_full + 8 * s, NP * PANEL);
        for (int p = 0; p < NP; ++p)
          tma_load(v_s + (s * NP + p) * PANEL, &vmap, v_full + 8 * s,
                   64 * p, kvh, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int first = q0 + 64 * wg;                    // warpgroup's rows
    const int r0 = first + 16 * (tid / 32) + lane / 4;  // rows r0, r0 + 8
    const int c0 = 2 * (lane % 4);                      // columns c0, c0 + 1
    const uint32_t qa = q_s + wg * NP * PANEL;
    // accumulator register j holds row r0 + 8 * ((j >> 1) & 1), column
    // 8 * (j / 4) + c0 + (j & 1) of its 64 x N tile
    float acc[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] = 0.0f;
    float m0 = MASKED, m1 = MASKED;    // running row max, log2 units
    float l0 = 0.0f, l1 = 0.0f;        // this thread's part of the row sum
    mbar_wait(q_full, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int ph = (i / STAGES) & 1;
      const int k0 = (lo + i) * BK;

      // S = Q . K^T
      float sc[32];
      mbar_wait(k_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
        wgmma_ss_n64(sc, desc(qa + off, 16, 1024),
                     desc(k_s + s * NP * PANEL + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // logits in log2 units, softcapped, then masked where the tile
      // crosses the diagonal, the window's edge or the ragged S edges
      if (softcap > 0.0f) {
        const float inv_cap = 1.0f / softcap;
        const float cap2 = softcap * LOG2E;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          sc[j] = tanh_approx(sc[j] * inv_cap) * cap2;
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] *= LOG2E;
      }
      const bool edge = k0 + BK - 1 > first || k0 + BK > Sk ||
                        first + 64 > Sq ||
                        (window > 0 && first + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int row = r0 + ((j & 2) ? 8 : 0);
          const int col = k0 + 8 * (j / 4) + c0 + (j & 1);
          bool live = row >= col && col < Sk && row < Sq;
          if (window > 0) live = live && row - col < window;
          if (!live) sc[j] = MASKED;
        }
      }

      // online softmax; the row's 64 keys lie in the 4 lanes of a quad
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j & 2) mx1 = fmaxf(mx1, sc[j]);
        else mx0 = fmaxf(mx0, sc[j]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float corr0 = exp2f(m0 - mx0);
      const float corr1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.0f, rs1 = 0.0f;
      uint32_t pk[16];                 // P in bf16, the A operand's layout
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const float mm = (j & 2) ? m1 : m0;
        const float p0 = exp2f(sc[j] - mm);
        const float p1 = exp2f(sc[j + 1] - mm);
        if (j & 2) rs1 += p0 + p1;
        else rs0 += p0 + p1;
        const __nv_bfloat162 two = __floats2bfloat162_rn(p0, p1);
        pk[j / 2] = *reinterpret_cast<const uint32_t*>(&two);
      }
      l0 = l0 * corr0 + rs0;
      l1 = l1 * corr1 + rs1;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[j] *= (j & 2) ? corr1 : corr0;

      // O += P . V
      mbar_wait(v_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                               pk[4 * kk + 3]};
        wgmma_rs<DP>(acc, a,
                     desc(v_s + s * NP * PANEL + kk * 16 * 128, PANEL, 1024));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(kv_empty + 8 * s);
    }

    // out = acc / max(l, 1e-30), rows past Sq and columns past D dropped
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float den0 = fmaxf(l0, 1e-30f);
    const float den1 = fmaxf(l1, 1e-30f);
    // the row max is in log2 units: m * ln 2 is the natural-log max
    if (lse != nullptr && (lane & 3) == 0) {
      float* lrow = lse + (int64_t)blockIdx.x * Sq;
      if (r0 < Sq) lrow[r0] = m0 * LN2 + logf(den0);
      if (r0 + 8 < Sq) lrow[r0 + 8] = m1 * LN2 + logf(den1);
    }
    const int64_t ld = (int64_t)H * D;
    __nv_bfloat16* row0 = o + ((int64_t)b * Sq + r0) * ld + (int64_t)h * D;
    __nv_bfloat16* row1 = row0 + 8 * ld;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + c0;
      if (col >= D) continue;
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(row0 + col) =
            __floats2bfloat162_rn(acc[4 * c] / den0, acc[4 * c + 1] / den0);
      if (r0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(row1 + col) =
            __floats2bfloat162_rn(acc[4 * c + 2] / den1,
                                  acc[4 * c + 3] / den1);
    }
  }
}

template <int DP>
static int launch(const CUtensorMap& qm, const CUtensorMap& km,
                  const CUtensorMap& vm, void* o, float* lse,
                  const int* plan, int n_tiles, int B, int Sq, int Sk, int H,
                  int KV, int D, int window, float softcap, int smem,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)n_tiles);
  flash_fwd_wgmma<DP><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, lse, plan, H, KV, Sq, Sk, D, window,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ===========================================================================
// C interface
// ===========================================================================

// lse: null, or (B, H, Sq) f32 for each row's log-sum-exp (both launches).
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int Sq, int Sk, int H,
                                          int KV, int D, int window,
                                          float softcap, void* stream) {
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || B * H > 65535 ||
      Sq < 1 || Sk < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v;
  if (D <= 64)
    return scalar::launch<64>(fq, fk, fv, (float*)o, (float*)lse, B, Sq,
                              Sk, H, KV, D, window, softcap, s);
  if (D <= 128)
    return scalar::launch<128>(fq, fk, fv, (float*)o, (float*)lse, B, Sq,
                              Sk, H, KV, D, window, softcap, s);
  return scalar::launch<256>(fq, fk, fv, (float*)o, (float*)lse, B, Sq,
                              Sk, H, KV, D, window, softcap, s);
}

// The geometry comes from the wrapper (kernels/flash_attention.py:
// tma_geometry and tile_plan): q_dims {D, H, Sq, B} and kv_dims
// {D, KV, Sk, B} with their byte strides, the box, the padded head dim and
// the shared-memory bytes; plan is a device array of n_tiles (q0, lo, hi).
// What the kernel is not built for is refused with ERR_GEOMETRY.
extern "C" int flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const int* plan, int n_tiles, int B, int Sq, int Sk, int H, int KV,
    int D, int window, float softcap, const uint64_t* q_dims,
    const uint64_t* q_strides, const uint64_t* kv_dims,
    const uint64_t* kv_strides, const uint32_t* box, int d_pad, int smem,
    void* stream) {
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || Sq < 1 || Sk < 1 ||
      window < 0 || n_tiles < 1 || n_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  if (d_pad != 64 * ((D + 63) / 64) || smem != tc::smem_bytes(d_pad))
    return ERR_GEOMETRY;
  int err = hopper::check_geometry(q_dims, kv_dims, box, B, Sq, Sk, H, KV, D);
  if (err) return err;
  CUtensorMap qm, km, vm;
  err = hopper::encode(&qm, q, q_dims, q_strides, box);
  if (!err) err = hopper::encode(&km, k, kv_dims, kv_strides, box);
  if (!err) err = hopper::encode(&vm, v, kv_dims, kv_strides, box);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d_pad) {
    case 64:
      return tc::launch<64>(qm, km, vm, o, (float*)lse, plan, n_tiles, B,
                            Sq, Sk, H, KV, D, window, softcap, smem, s);
    case 128:
      return tc::launch<128>(qm, km, vm, o, (float*)lse, plan, n_tiles, B,
                            Sq, Sk, H, KV, D, window, softcap, smem, s);
    case 192:
      return tc::launch<192>(qm, km, vm, o, (float*)lse, plan, n_tiles, B,
                            Sq, Sk, H, KV, D, window, softcap, smem, s);
    default:
      return tc::launch<256>(qm, km, vm, o, (float*)lse, plan, n_tiles, B,
                            Sq, Sk, H, KV, D, window, softcap, smem, s);
  }
}

extern "C" const char* flash_attention_error(int err) {
  return hopper::error_string(err);
}
