// Flash attention backward: dQ, dK and dV of causal GQA attention with an
// optional sliding window and tanh logit softcap, recomputing the softmax
// block by block from the forward's per-row log-sum-exp.
//
// The port's counterpart of the JAX custom VJP's backward
// (repro.models.layers._flash_vjp_bwd, src/repro/models/layers.py:268), a
// FlashAttention-2 recompute written in jnp: no Pallas kernel of the JAX
// package does this.  For q pre-scaled by 1/sqrt(D) (the scale is a torch op
// outside, as the JAX multiply is outside _flash), the forward's output o,
// the output's gradient dO and lse = m + log(max(l, 1e-30)) of every row
// (natural-log units, written by the forward kernels of
// csrc/flash_attention.cu), every live (q, k) pair gives
//   raw  = q . k                          (f32)
//   x    = softcap > 0 ? tanh(raw / cap) * cap : raw
//   p    = exp(x - lse)                    (0 where masked)
//   dP   = dO . v
//   dS   = p * (dP - delta),  delta = rowsum(dO * o)
//          times 1 - tanh(raw / cap)^2 with a softcap
//   dV  += p dO,   dK += dS q,   dQ += dS k
// with the forward's masks: q_pos >= k_pos (q_offset 0), k_pos < Sk,
// q_pos < Sq and, with window > 0, q_pos - k_pos < window.  A masked pair
// adds nothing, as the reference's exp(-1e30 - m) = 0 does.
//
// Layouts are the forward's, the JAX layout with no transposes: q, o, dO,
// dQ (B, Sq, H, D), k, v, dK, dV (B, Sk, KV, D), contiguous; lse and delta
// (B, H, Sq) f32.  D a multiple of 8 up to 256.  Outputs in the inputs'
// dtype; dq, dk and dv are written whole (keys no query sees get zeros).
//
// Bound on the H100: operations.  10 * D flops a live (q, k) pair and head
// (S, dP, dV, dK, dQ) on the tensor cores' 989 TFLOP/s, above the bytes of
// q, k, v, o, dO and the three gradients: at gemma3_4b's global layer (B 2,
// S 4,096, H 8, KV 4, D 256) 0.3475 ms of operations, 0.05 ms of bytes.
//
// Every kernel here runs on the caller's stream, with no atomics: the same
// inputs give the same bits, launch after launch (a resumed training run
// equals a straight one).  So dQ, which sums over key tiles, is a pass of
// its own beside dK/dV, which sum over query tiles: the two passes each
// recompute S and dP, 14 * D flops a live pair and head instead of 10 * D.
// First flash_bwd_delta: delta = rowsum(dO * o) in f32, a warp a row.
//
// bf16, the tensor-core kernels for Hopper (sm_90a), after the forward's
// flash_fwd_wgmma: one loader thread issues TMA copies of 64 x 64 bf16
// boxes (8 KB, 128-byte swizzled, zero-filled past S and D) into mbarrier
// full/empty rings; consumer warpgroups run wgmma.mma_async (bf16 in, f32
// accumulate) under setmaxnreg (consumers 240 registers, the loader's
// warpgroup 24); each block walks only the live tiles of a plan that the
// wrapper computes (kernels/flash_attention.py: bwd_tile_plans), heaviest
// blocks first.  Tiles are 64 keys x 64 query rows.  DP is D padded to 64.
//   * flash_bwd_dkdv_wgmma: one block per (b * KV + kv head, 64-key tile),
//     384 threads.  K and V stay in shared memory; the Q and dO tiles of
//     every live query tile of each query head of the GQA group stream
//     through a 2-stage ring.  Keys are the 64-row M side: S^T = K . Q^T and
//     dP^T = V . dO^T come out with P^T and dS^T already in the A operand's
//     register layout, so dV += P^T . dO and dK += dS^T . Q run with A from
//     registers and dO, Q read through the descriptor's transpose bit.  A
//     64 x 256 f32 accumulator is 128 registers a thread, so one
//     warpgroup cannot hold dK and dV: warpgroup 0 computes S^T, P^T and
//     owns dV; warpgroup 1 computes dP^T and owns dK, and takes
//     P^T * (1 - tanh^2) from warpgroup 0 through a 16 KB f32 exchange in
//     shared memory (named barriers 1 and 2 hand it over), so that
//     dS^T = that * (dP^T - delta).  Registers a consumer thread at
//     DP = 256: 128 accumulator + 32 S^T or dP^T + 16 lse or delta + 16
//     packed bf16 operand.  Shared memory at DP = 256: K 32 KB + V 32 KB +
//     2 stages x (Q 32 KB + dO 32 KB) + exchange 16 KB + 1 KB alignment
//     slack + barriers = 214,080 bytes of the 232,448 a block may use.
//   * flash_bwd_dq_wgmma: one block per (b * H + head, 64-row query tile),
//     384 threads.  Q and dO stay in shared memory with the rows' lse and
//     delta in registers; the live K and V tiles stream through a 2-stage
//     ring, stage w for warpgroup w: the two consumer warpgroups take
//     alternate key tiles and each accumulates its own dQ partial
//     (S = Q . K^T and dP = dO . V^T from shared memory, dS in registers,
//     dQ += dS . K with K through the transpose bit).  At the end
//     warpgroup 1 leaves its partial in the drained ring and warpgroup 0
//     adds it: a fixed order.  Registers at DP = 256: 128 accumulator + 32
//     S + 32 dP + 16 packed dS.  Shared memory: Q 32 KB + dO 32 KB + 2
//     stages x (K 32 KB + V 32 KB) + 1 KB + barriers = 197,696 bytes.
//   * P and dS are rounded to bf16 as wgmma operands (the forward rounds
//     P so); S, dP and every sum stay f32.  p is exp2 of the logit in log2
//     units less lse * log2(e); the softcap is tanh.approx on the MUFU, the
//     forward's, so the recomputed x matches the lse it is taken from.
//     The masks run only on tiles that cross the diagonal, the window's
//     edge or the ragged S edges.
//
// f32, the scalar kernels (the card has no f32 tensor-core rate, and TF32
// would break the f32 tolerance): flash_bwd_dkdv (one block per (b * KV +
// kv head, 32-key tile), looping over the G heads of the group and their
// live 32-row query tiles) and flash_bwd_dq (one block per (b * H + head,
// 32-row query tile), heaviest first, looping over the live 32-key tiles);
// 256 threads, each 4 of a tile's 32 x 32 pairs and 4 rows x D/32 columns
// of its accumulators, f32 FMAs on the CUDA cores, tiles in f32 shared
// memory rows of D + 4 floats (16-byte reads, conflict-free).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

#define ERR_BF16_ENTRY 10004  // bf16 goes through the tensor-core launch

__device__ __forceinline__ bool live_pair(int qp, int kp, int Sq, int Sk,
                                          int window) {
  bool live = qp >= kp && kp < Sk && qp < Sq;
  if (window > 0) live = live && qp - kp < window;
  return live;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[(b * H + h) * Sq + i] = sum_d dO[b, i, h, d] * o[b, i, h, d].
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int Sq, int H, int D,
                int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32)
    s += to_f32(orow[d]) * to_f32(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const int64_t bi = row / H;           // b * Sq + i
    const int64_t b = bi / Sq;
    const int i = (int)(bi - b * Sq);
    delta[(b * H + h) * Sq + i] = s;
  }
}

template <typename T>
static int launch_delta(const T* o, const T* dout, float* delta, int B,
                        int Sq, int H, int D, cudaStream_t stream) {
  const int64_t rows = (int64_t)B * Sq * H;
  flash_bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, delta, Sq, H, D, rows);
  return (int)cudaGetLastError();
}

// ===========================================================================
// f32: the scalar kernels
// ===========================================================================

namespace scalar {

constexpr int BQ = 32;        // query rows a tile
constexpr int BKV = 32;       // keys a tile
constexpr int THREADS = 256;  // 8 warps: warp w owns rows w, w + 8, ...

// 32 rows of D floats, row r at src + r * stride, into shared rows of
// ld = D + 4 floats; rows at or past n_valid are zeros.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int64_t stride, int n_valid,
                                          int D) {
  for (int idx = threadIdx.x; idx < 32 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * ld + c] = r < n_valid ? src[r * stride + c] : 0.0f;
  }
}

// lse and delta of the tile's rows [q0, q0 + n_valid) into shared memory.
__device__ __forceinline__ void load_rows(float* ls, float* ds,
                                          const float* lse,
                                          const float* delta, int n_valid) {
  if (threadIdx.x < BQ) {
    const int r = threadIdx.x;
    ls[r] = r < n_valid ? lse[r] : 0.0f;
    ds[r] = r < n_valid ? delta[r] : 0.0f;
  }
}

// s += a . b over 4 elements, in order.
__device__ __forceinline__ float dot4(float s, float4 a, float4 b) {
  s += a.x * b.x;
  s += a.y * b.y;
  s += a.z * b.z;
  s += a.w * b.w;
  return s;
}

// S = Q . K^T and dP = dO . V^T for this thread's 4 pairs: query rows
// ty + 8 i of Qs and dOs (the same for the whole warp: a broadcast), key tx
// of Ks and Vs (a row a lane), 4 columns a read.
__device__ __forceinline__ void dots(const float* Qs, const float* dOs,
                                     const float* Ks, const float* Vs,
                                     int ld, int D, int ty, int tx,
                                     float (&s)[4], float (&dp)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = dp[i] = 0.0f;
  const float4* kr = reinterpret_cast<const float4*>(Ks + tx * ld);
  const float4* vr = reinterpret_cast<const float4*>(Vs + tx * ld);
  const float4* qr = reinterpret_cast<const float4*>(Qs + ty * ld);
  const float4* dr = reinterpret_cast<const float4*>(dOs + ty * ld);
  const int ld4 = ld / 4;
#pragma unroll 2
  for (int d = 0; d < D / 4; ++d) {
    const float4 kd = kr[d];
    const float4 vd = vr[d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = dot4(s[i], qr[8 * i * ld4 + d], kd);
      dp[i] = dot4(dp[i], dr[8 * i * ld4 + d], vd);
    }
  }
}

// p and dS of one pair; both 0 where the pair is masked.
__device__ __forceinline__ void grad_logit(float raw, float dp, float lse,
                                           float delta, bool live,
                                           float softcap, float& p,
                                           float& ds) {
  if (!live) {
    p = 0.0f;
    ds = 0.0f;
    return;
  }
  float x = raw;
  float t = 0.0f;
  if (softcap > 0.0f) {
    t = tanhf(raw / softcap);
    x = t * softcap;
  }
  p = expf(x - lse);
  ds = p * (dp - delta);
  if (softcap > 0.0f) ds *= 1.0f - t * t;
}

// Shared memory of either tile kernel: four 32-row f32 tiles of D + 4,
// two 32 x 33 pair tiles, lse and delta of 32 rows.
size_t smem_bytes(int D) {
  return ((size_t)(2 * BQ + 2 * BKV) * (D + 4) + (size_t)2 * BQ * (BKV + 1) +
          2 * BQ) *
         sizeof(float);
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
               int Sq, int Sk, int D, int window, float softcap) {
  constexpr int DJ = DMAX / 32;          // accumulator columns a thread
  extern __shared__ float smem[];
  const int ld = D + 4;                  // 16-byte rows, 4 mod 8 words
  const int ldp = BKV + 1;
  float* Ks = smem;                      // BKV x ld
  float* Vs = Ks + BKV * ld;             // BKV x ld
  float* Qs = Vs + BKV * ld;             // BQ x ld
  float* dOs = Qs + BQ * ld;             // BQ x ld
  float* Ps = dOs + BQ * ld;             // BQ x ldp, [query][key]
  float* dSs = Ps + BQ * ldp;            // BQ x ldp
  float* Ls = dSs + BQ * ldp;            // BQ
  float* Ds = Ls + BQ;                   // BQ

  const int k0 = blockIdx.x * BKV;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y - b * KV;
  const int G = H / KV;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;
  const int64_t kv_base =
      ((int64_t)b * Sk + k0) * kv_stride + (int64_t)kvh * D;
  load_tile(Ks, ld, k + kv_base, kv_stride, min(BKV, Sk - k0), D);
  load_tile(Vs, ld, v + kv_base, kv_stride, min(BKV, Sk - k0), D);

  // live query tiles [qlo, qhi): the reference's _q_range at q_offset 0
  const int nq = (Sq + BQ - 1) / BQ;
  const int qlo = k0 / BQ;
  const int qhi =
      window > 0 ? min((k0 + BKV + window - 2) / BQ + 1, nq) : nq;

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t row_base = ((int64_t)b * H + h) * Sq;
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q0 = qt * BQ;
      const int nvq = min(BQ, Sq - q0);
      __syncthreads();                   // the last tile's readers are done
      const int64_t q_base = ((int64_t)b * Sq + q0) * q_stride +
                             (int64_t)h * D;
      load_tile(Qs, ld, q + q_base, q_stride, nvq, D);
      load_tile(dOs, ld, dout + q_base, q_stride, nvq, D);
      load_rows(Ls, Ds, lse + row_base + q0, delta + row_base + q0, nvq);
      __syncthreads();

      float s[4], dp[4];
      dots(Qs, dOs, Ks, Vs, ld, D, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 8 * i;
        float p, ds;
        grad_logit(s[i], dp[i], Ls[r], Ds[r],
                   live_pair(q0 + r, k0 + tx, Sq, Sk, window), softcap, p,
                   ds);
        Ps[r * ldp + tx] = p;
        dSs[r * ldp + tx] = ds;
      }
      __syncthreads();

      // dV[key][c] += sum_q P[q][key] dO[q][c]; dK likewise with dS and Q;
      // this thread: keys ty + 8 i, columns tx + 32 j
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * ldp + ty + 8 * i];
          sv[i] = dSs[r * ldp + ty + 8 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int c = tx + 32 * j;
          const float dov = c < D ? dOs[r * ld + c] : 0.0f;
          const float qv = c < D ? Qs[r * ld + c] : 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] += pv[i] * dov;
            dk_acc[i][j] += sv[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = ty + 8 * i;
    if (k0 + kr >= Sk) continue;
    float* dkr = dk + kv_base + kr * kv_stride;
    float* dvr = dv + kv_base + kr * kv_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 32 * j;
      if (c < D) {
        dkr[c] = dk_acc[i][j];
        dvr[c] = dv_acc[i][j];
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int H, int KV, int Sq, int Sk, int D,
             int window, float softcap) {
  constexpr int DJ = DMAX / 32;
  extern __shared__ float smem[];
  const int ld = D + 4;                  // 16-byte rows, 4 mod 8 words
  const int ldp = BKV + 1;
  float* Qs = smem;                      // BQ x ld
  float* dOs = Qs + BQ * ld;             // BQ x ld
  float* Ks = dOs + BQ * ld;             // BKV x ld
  float* Vs = Ks + BKV * ld;             // BKV x ld
  float* dSs = Vs + BKV * ld;            // BQ x ldp
  float* Ls = dSs + 2 * BQ * ldp;        // BQ (after the unused Ps room)
  float* Ds = Ls + BQ;                   // BQ

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int nvq = min(BQ, Sq - q0);
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;
  const int64_t q_base = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
  const int64_t row_base = (int64_t)blockIdx.y * Sq + q0;
  load_tile(Qs, ld, q + q_base, q_stride, nvq, D);
  load_tile(dOs, ld, dout + q_base, q_stride, nvq, D);
  load_rows(Ls, Ds, lse + row_base, delta + row_base, nvq);

  // live KV tiles [klo, khi): the reference's _causal_kv_range at
  // q_offset 0, the last row capped at Sq - 1
  const int nk = (Sk + BKV - 1) / BKV;
  const int khi = min((q0 + nvq - 1) / BKV + 1, nk);
  int klo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    klo = first > 0 ? first / BKV : 0;
  }

  float dq_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq_acc[i][j] = 0.0f;

  for (int kt = klo; kt < khi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                     // the last tile's readers are done
    const int64_t kv_base =
        ((int64_t)b * Sk + k0) * kv_stride + (int64_t)kvh * D;
    load_tile(Ks, ld, k + kv_base, kv_stride, min(BKV, Sk - k0), D);
    load_tile(Vs, ld, v + kv_base, kv_stride, min(BKV, Sk - k0), D);
    __syncthreads();

    float s[4], dp[4];
    dots(Qs, dOs, Ks, Vs, ld, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
      float p, ds;
      grad_logit(s[i], dp[i], Ls[r], Ds[r],
                 live_pair(q0 + r, k0 + tx, Sq, Sk, window), softcap, p, ds);
      dSs[r * ldp + tx] = ds;
    }
    __syncthreads();

    // dQ[row][c] += sum_key dS[row][key] K[key][c]; rows ty + 8 i,
    // columns tx + 32 j
#pragma unroll 2
    for (int kk = 0; kk < BKV; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 8 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 32 * j;
        const float kv = c < D ? Ks[kk * ld + c] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][j] += sv[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    if (r >= nvq) continue;
    float* row = dq + q_base + r * q_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 32 * j;
      if (c < D) row[c] = dq_acc[i][j];
    }
  }
}

template <int DMAX>
static int launch(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dq, float* dk, float* dv, int B, int Sq, int Sk,
                  int H, int KV, int D, int window, float softcap,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;

  const dim3 kv_grid((unsigned)((Sk + BKV - 1) / BKV), (unsigned)(B * KV));
  flash_bwd_dkdv<DMAX><<<kv_grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, KV, Sq, Sk, D, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 q_grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_bwd_dq<DMAX><<<q_grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, H, KV, Sq, Sk, D, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace scalar

// ===========================================================================
// bf16: the tensor-core kernels (wgmma + TMA)
// ===========================================================================

namespace tc {

using namespace hopper;

constexpr int TILE = 64;             // keys and query rows a tile
constexpr int THREADS = 384;         // warpgroups 0-1 consume, 2 loads
constexpr int STAGES = 2;            // ring depth
constexpr int XCH = 32 * 128 * 4;    // the dK/dV exchange: 32 f32 a thread

// Dynamic shared memory at padded head dim dp: 1 KB of slack to align the
// tiles to the 1,024-byte swizzle atom, two resident tiles and STAGES
// stages of two streamed tiles (dp/64 panels each), (dK/dV) the exchange,
// and the mbarriers.
constexpr int dkdv_smem(int dp) {
  return 1024 + (2 + 2 * STAGES) * (dp / 64) * PANEL + XCH + 64;
}
constexpr int dq_smem(int dp) {
  return 1024 + (2 + 2 * STAGES) * (dp / 64) * PANEL + 64;
}

// Accumulator register j of a warpgroup's 64 x N f32 tile lies at row
// r0 + 8 * ((j >> 1) & 1), column 8 * (j / 4) + c0 + (j & 1), with
// r0 = 16 * warp + lane / 4 and c0 = 2 * (lane % 4); pairs (j, j + 1)
// packed to bf16 are the A operand's registers in order.

// K-major product of two resident or streamed 64-row tiles over DP:
// d = A . B^T, both 64 x DP at a and b.
template <int DP>
__device__ __forceinline__ void tile_dots(float (&d)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
    wgmma_ss_n64(d, desc(a + off, 16, 1024), desc(b + off, 16, 1024),
                 kk > 0);
  }
}

// acc (64 x DP) += A (64 x 64, packed bf16 in registers) . B (64 x DP at b,
// read MN-major through the transpose bit).
template <int DP>
__device__ __forceinline__ void tile_update(float (&acc)[DP / 2],
                                            const uint32_t (&pk)[16],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                           pk[4 * kk + 3]};
    wgmma_rs<DP>(acc, a, desc(b + kk * 16 * 128, PANEL, 1024));
  }
}

// Rows [r0, r0 + 8) at row and row + 8 * ld of a 64 x DP accumulator, in
// bf16; rows at or past n_rows and columns at or past D are dropped.
template <int DP>
__device__ __forceinline__ void store_tile(const float (&acc)[DP / 2],
                                           __nv_bfloat16* row, int64_t ld,
                                           int r0, int n_rows, int c0,
                                           int D) {
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    const int col = 8 * c + c0;
    if (col >= D) continue;
    if (r0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(acc[4 * c], acc[4 * c + 1]);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * ld + col) =
          __floats2bfloat162_rn(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

// Grid (B*KV, key tiles); plan[3 * blockIdx.y + {0, 1, 2}] = (k0, qlo, qhi)
// of the block's key tile: its live 64-row query tiles [qlo, qhi), walked
// for each of the G query heads of the group.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     const int* __restrict__ plan, int H, int KV, int Sq,
                     int Sk, int D, int window, float softcap) {
  constexpr int NP = DP / 64;          // 64-column panels of a tile
  constexpr int NA = DP / 2;           // accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t k_s = (base + 1023) & ~1023u;       // [NP]
  const uint32_t v_s = k_s + NP * PANEL;             // [NP]
  const uint32_t q_s = v_s + NP * PANEL;             // [STAGES][NP]
  const uint32_t do_s = q_s + STAGES * NP * PANEL;   // [STAGES][NP]
  const uint32_t x_s = do_s + STAGES * NP * PANEL;   // exchange [32][128]
  const uint32_t kv_full = x_s + XCH;
  const uint32_t full = kv_full + 8;                 // [STAGES]
  const uint32_t empty = full + 8 * STAGES;          // [STAGES]
  float* xch = reinterpret_cast<float*>(smem_raw + (x_s - base));

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int G = H / KV;
  const int k0 = plan[3 * blockIdx.y];
  const int qlo = plan[3 * blockIdx.y + 1];
  const int nqt = plan[3 * blockIdx.y + 2] - qlo;
  const int n = G * nqt;               // (head, query tile) steps, head-major

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);     // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- loader: one thread issues every TMA copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256 && n > 0) {
      mbar_expect_tx(kv_full, 2 * NP * PANEL);
      for (int p = 0; p < NP; ++p) {
        tma_load(k_s + p * PANEL, &kmap, kv_full, 64 * p, kvh, k0, b);
        tma_load(v_s + p * PANEL, &vmap, kv_full, 64 * p, kvh, k0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const int h = kvh * G + i / nqt;
        const int q0 = (qlo + i % nqt) * TILE;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * NP * PANEL);
        for (int p = 0; p < NP; ++p) {
          tma_load(q_s + (s * NP + p) * PANEL, &qmap, full + 8 * s, 64 * p,
                   h, q0, b);
          tma_load(do_s + (s * NP + p) * PANEL, &domap, full + 8 * s,
                   64 * p, h, q0, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 0 S^T, P^T and dV; warpgroup 1 dP^T, dK
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;   // key rows r0, r0 + 8
    const int c0 = 2 * (lane % 4);               // query columns c0, c0 + 1
    // warpgroup 0 multiplies K by Q then P^T by dO; 1 V by dO, dS^T by Q
    const uint32_t a_s = wg == 0 ? k_s : v_s;
    const uint32_t b_s = wg == 0 ? q_s : do_s;
    const uint32_t u_s = wg == 0 ? do_s : q_s;
    const float* rows = wg == 0 ? lse : delta;
    float acc[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[j] = 0.0f;
    if (n > 0) mbar_wait(kv_full, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int ph = (i / STAGES) & 1;
      const int h = kvh * G + i / nqt;
      const int q0 = (qlo + i % nqt) * TILE;

      // S^T = K . Q^T (warpgroup 0) or dP^T = V . dO^T (warpgroup 1)
      float x[32];
      mbar_wait(full + 8 * s, ph);
      wgmma_fence();
      tile_dots<DP>(x, a_s, b_s + s * NP * PANEL);
      wgmma_commit();
      // the tile's lse (in log2 units) or delta at this thread's 16 query
      // columns, loaded while the product runs; 0 past Sq
      float st[16];
      const float* srow = rows + ((int64_t)b * H + h) * Sq + q0;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int col = 8 * (e / 2) + c0 + (e & 1);
        st[e] = q0 + col < Sq ? __ldg(srow + col) : 0.0f;
      }
      wgmma_wait0();
      fence_regs(x);

      uint32_t pk[16];                 // P^T or dS^T in bf16, A's layout
      if (wg == 0) {
        const bool edge = q0 < k0 + TILE - 1 || k0 + TILE > Sk ||
                          q0 + TILE > Sq ||
                          (window > 0 && q0 + TILE - 1 - k0 >= window);
        const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
        const float cap2 = softcap * LOG2E;
        if (i > 0) named_sync(2, 256);   // warpgroup 1 has read the last
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float lse2 = st[2 * (j / 4) + (j & 1)] * LOG2E;
          float p, pc;
          if (softcap > 0.0f) {
            const float t = tanh_approx(x[j] * inv_cap);
            p = exp2f(t * cap2 - lse2);
            pc = p * (1.0f - t * t);
          } else {
            p = pc = exp2f(x[j] * LOG2E - lse2);
          }
          if (edge) {
            const int kp = k0 + r0 + ((j & 2) ? 8 : 0);
            const int qp = q0 + 8 * (j / 4) + c0 + (j & 1);
            if (!live_pair(qp, kp, Sq, Sk, window)) p = pc = 0.0f;
          }
          x[j] = p;
          xch[j * 128 + tid] = pc;
        }
        named_arrive(1, 256);
#pragma unroll
        for (int j = 0; j < 32; j += 2) pk[j / 2] = pack_bf16(x[j], x[j + 1]);
      } else {
        named_sync(1, 256);              // warpgroup 0 has written P^T
#pragma unroll
        for (int j = 0; j < 32; ++j)
          x[j] = xch[j * 128 + tid] * (x[j] - st[2 * (j / 4) + (j & 1)]);
        if (i + 1 < n) named_arrive(2, 256);
#pragma unroll
        for (int j = 0; j < 32; j += 2) pk[j / 2] = pack_bf16(x[j], x[j + 1]);
      }

      // dV += P^T . dO (warpgroup 0) or dK += dS^T . Q (warpgroup 1)
      wgmma_fence();
      tile_update<DP>(acc, pk, u_s + s * NP * PANEL);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    const int64_t ld = (int64_t)KV * D;
    __nv_bfloat16* out = (wg == 0 ? dv : dk) +
                         ((int64_t)b * Sk + k0 + r0) * ld + (int64_t)kvh * D;
    store_tile<DP>(acc, out, ld, k0 + r0, Sk, c0, D);
  }
}

// Grid (B*H, query tiles); plan[3 * blockIdx.y + {0, 1, 2}] = (q0, klo,
// khi) of the block's query tile: its live 64-key tiles [klo, khi).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq,
                   const int* __restrict__ plan, int H, int KV, int Sq,
                   int Sk, int D, int window, float softcap) {
  constexpr int NP = DP / 64;
  constexpr int NA = DP / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t q_s = (base + 1023) & ~1023u;       // [NP]
  const uint32_t do_s = q_s + NP * PANEL;            // [NP]
  const uint32_t k_s = do_s + NP * PANEL;            // [STAGES][NP]
  const uint32_t v_s = k_s + STAGES * NP * PANEL;    // [STAGES][NP]
  const uint32_t qd_full = v_s + STAGES * NP * PANEL;
  const uint32_t full = qd_full + 8;                 // [STAGES]
  const uint32_t empty = full + 8 * STAGES;          // [STAGES]
  // warpgroup 1's dQ partial, [NA][128] f32, in the drained K ring
  float* part = reinterpret_cast<float*>(smem_raw + (k_s - base));

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = plan[3 * blockIdx.y];
  const int lo = plan[3 * blockIdx.y + 1];
  const int n = plan[3 * blockIdx.y + 2] - lo;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);     // the consuming warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- loader: one thread issues every TMA copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qd_full, 2 * NP * PANEL);
      for (int p = 0; p < NP; ++p) {
        tma_load(q_s + p * PANEL, &qmap, qd_full, 64 * p, h, q0, b);
        tma_load(do_s + p * PANEL, &domap, qd_full, 64 * p, h, q0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const int kt0 = (lo + i) * TILE;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * NP * PANEL);
        for (int p = 0; p < NP; ++p) {
          tma_load(k_s + (s * NP + p) * PANEL, &kmap, full + 8 * s, 64 * p,
                   kvh, kt0, b);
          tma_load(v_s + (s * NP + p) * PANEL, &vmap, full + 8 * s, 64 * p,
                   kvh, kt0, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w takes key tiles lo + w, lo + w + 2, ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;   // query rows r0, r0 + 8
    const int c0 = 2 * (lane % 4);               // key columns c0, c0 + 1
    const float* lrow = lse + (int64_t)blockIdx.x * Sq + q0;
    const float* drow = delta + (int64_t)blockIdx.x * Sq + q0;
    const bool in0 = q0 + r0 < Sq, in1 = q0 + r0 + 8 < Sq;
    const float lse0 = in0 ? lrow[r0] * LOG2E : 0.0f;
    const float lse1 = in1 ? lrow[r0 + 8] * LOG2E : 0.0f;
    const float dl0 = in0 ? drow[r0] : 0.0f;
    const float dl1 = in1 ? drow[r0 + 8] : 0.0f;
    const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
    const float cap2 = softcap * LOG2E;
    float acc[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[j] = 0.0f;
    mbar_wait(qd_full, 0);

    for (int i = wg; i < n; i += STAGES) {
      const int s = wg;
      const int ph = (i / STAGES) & 1;
      const int kt0 = (lo + i) * TILE;
      const uint32_t ks = k_s + s * NP * PANEL;

      // S = Q . K^T and dP = dO . V^T
      float x[32], dp[32];
      mbar_wait(full + 8 * s, ph);
      wgmma_fence();
      tile_dots<DP>(x, q_s, ks);
      tile_dots<DP>(dp, do_s, v_s + s * NP * PANEL);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(x);
      fence_regs(dp);

      const bool edge = q0 < kt0 + TILE - 1 || kt0 + TILE > Sk ||
                        q0 + TILE > Sq ||
                        (window > 0 && q0 + TILE - 1 - kt0 >= window);
      uint32_t pk[16];                 // dS in bf16, A's layout
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = j + e;
          const bool hi = (jj & 2) != 0;
          const float lse2 = hi ? lse1 : lse0;
          float p, dsj;
          if (softcap > 0.0f) {
            const float t = tanh_approx(x[jj] * inv_cap);
            p = exp2f(t * cap2 - lse2);
            dsj = p * (dp[jj] - (hi ? dl1 : dl0)) * (1.0f - t * t);
          } else {
            p = exp2f(x[jj] * LOG2E - lse2);
            dsj = p * (dp[jj] - (hi ? dl1 : dl0));
          }
          if (edge) {
            const int qp = q0 + r0 + (hi ? 8 : 0);
            const int kp = kt0 + 8 * (jj / 4) + c0 + (jj & 1);
            if (!live_pair(qp, kp, Sq, Sk, window)) dsj = 0.0f;
          }
          ds[e] = dsj;
        }
        pk[j / 2] = pack_bf16(ds[0], ds[1]);
      }

      // dQ += dS . K
      wgmma_fence();
      tile_update<DP>(acc, pk, ks);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // dQ = warpgroup 0's partial + warpgroup 1's, in that order
    named_sync(1, 256);                // both are done with the ring
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < NA; ++j) part[j * 128 + tid] = acc[j];
    }
    named_sync(1, 256);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[j] += part[j * 128 + tid];
      const int64_t ld = (int64_t)H * D;
      store_tile<DP>(acc, dq + ((int64_t)b * Sq + q0 + r0) * ld +
                              (int64_t)h * D,
                     ld, q0 + r0, Sq, c0, D);
    }
  }
}

template <int DP>
static int launch(const CUtensorMap (&maps)[4], const float* lse,
                  const float* delta, void* dq, void* dk, void* dv,
                  const int* kv_plan, int n_kv_tiles, const int* q_plan,
                  int n_q_tiles, int B, int Sq, int Sk, int H, int KV, int D,
                  int window, float softcap, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkdv_smem(DP));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem(DP));
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)(B * KV), (unsigned)n_kv_tiles);
  flash_bwd_dkdv_wgmma<DP><<<kv_grid, THREADS, dkdv_smem(DP), stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, kv_plan, H, KV, Sq, Sk, D, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 q_grid((unsigned)(B * H), (unsigned)n_q_tiles);
  flash_bwd_dq_wgmma<DP><<<q_grid, THREADS, dq_smem(DP), stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, (__nv_bfloat16*)dq,
      q_plan, H, KV, Sq, Sk, D, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ===========================================================================
// C interface
// ===========================================================================

static bool bad_shape(int B, int Sq, int Sk, int H, int KV, int D,
                      int window) {
  return D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || B < 1 ||
         B * H > 65535 || Sq < 1 || Sk < Sq || window < 0;
}

// The f32 backward (bf16 != 0 is refused with ERR_BF16_ENTRY: bf16 takes
// flash_attention_bwd_bf16_launch, which needs the plans and tensor maps).
// delta is the caller's (B, H, Sq) f32 scratch; lse the forward's.
extern "C" int flash_attention_bwd_launch(
    int bf16, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KV, int D, int window,
    float softcap, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, D, window))
    return (int)cudaErrorInvalidValue;
  if (bf16) return ERR_BF16_ENTRY;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fdo = (const float*)dout,
              *l = (const float*)lse;
  float* dl = (float*)delta;
  int err = launch_delta<float>((const float*)o, fdo, dl, B, Sq, H, D, s);
  if (err) return err;
  if (D <= 64)
    return scalar::launch<64>(fq, fk, fv, fdo, l, dl, (float*)dq, (float*)dk,
                              (float*)dv, B, Sq, Sk, H, KV, D, window,
                              softcap, s);
  if (D <= 128)
    return scalar::launch<128>(fq, fk, fv, fdo, l, dl, (float*)dq,
                               (float*)dk, (float*)dv, B, Sq, Sk, H, KV, D,
                               window, softcap, s);
  return scalar::launch<256>(fq, fk, fv, fdo, l, dl, (float*)dq, (float*)dk,
                             (float*)dv, B, Sq, Sk, H, KV, D, window,
                             softcap, s);
}

// The bf16 backward on the tensor cores.  The geometry comes from the
// wrapper (kernels/flash_attention.py: tma_geometry, bwd_tile_plans):
// q_dims {D, H, Sq, B} (q, o and dO) and kv_dims {D, KV, Sk, B} (k and v)
// with their byte strides, the box, the padded head dim and both kernels'
// shared-memory bytes; kv_plan and q_plan are device arrays of n_kv_tiles
// (k0, qlo, qhi) and n_q_tiles (q0, klo, khi).  What the kernels are not
// built for is refused with ERR_GEOMETRY.
extern "C" int flash_attention_bwd_bf16_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const int* kv_plan, int n_kv_tiles, const int* q_plan,
    int n_q_tiles, int B, int Sq, int Sk, int H, int KV, int D, int window,
    float softcap, const uint64_t* q_dims, const uint64_t* q_strides,
    const uint64_t* kv_dims, const uint64_t* kv_strides, const uint32_t* box,
    int d_pad, int dkdv_smem, int dq_smem, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, D, window) || n_kv_tiles < 1 ||
      n_kv_tiles > 65535 || n_q_tiles < 1 || n_q_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  if (d_pad != 64 * ((D + 63) / 64) || dkdv_smem != tc::dkdv_smem(d_pad) ||
      dq_smem != tc::dq_smem(d_pad))
    return ERR_GEOMETRY;
  int err = hopper::check_geometry(q_dims, kv_dims, box, B, Sq, Sk, H, KV, D);
  if (err) return err;
  CUtensorMap maps[4];                 // q, k, v, dO
  err = hopper::encode(&maps[0], q, q_dims, q_strides, box);
  if (!err) err = hopper::encode(&maps[1], k, kv_dims, kv_strides, box);
  if (!err) err = hopper::encode(&maps[2], v, kv_dims, kv_strides, box);
  if (!err) err = hopper::encode(&maps[3], dout, q_dims, q_strides, box);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  float* dl = (float*)delta;
  err = launch_delta<__nv_bfloat16>((const __nv_bfloat16*)o,
                                    (const __nv_bfloat16*)dout, dl, B, Sq, H,
                                    D, s);
  if (err) return err;
  const float* l = (const float*)lse;
  switch (d_pad) {
    case 64:
      return tc::launch<64>(maps, l, dl, dq, dk, dv, kv_plan, n_kv_tiles,
                            q_plan, n_q_tiles, B, Sq, Sk, H, KV, D, window,
                            softcap, s);
    case 128:
      return tc::launch<128>(maps, l, dl, dq, dk, dv, kv_plan, n_kv_tiles,
                             q_plan, n_q_tiles, B, Sq, Sk, H, KV, D, window,
                             softcap, s);
    case 192:
      return tc::launch<192>(maps, l, dl, dq, dk, dv, kv_plan, n_kv_tiles,
                             q_plan, n_q_tiles, B, Sq, Sk, H, KV, D, window,
                             softcap, s);
    default:
      return tc::launch<256>(maps, l, dl, dq, dk, dv, kv_plan, n_kv_tiles,
                             q_plan, n_q_tiles, B, Sq, Sk, H, KV, D, window,
                             softcap, s);
  }
}

extern "C" const char* flash_attention_bwd_error(int err) {
  if (err == ERR_BF16_ENTRY)
    return "bf16 inputs go through flash_attention_bwd_bf16_launch";
  return hopper::error_string(err);
}
