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
// Three kernels, run in order on the caller's stream, none with atomics, so
// every result is the same bits from run to run:
//   * flash_bwd_delta: delta = rowsum(dO * o) in f32, one warp a row;
//   * flash_bwd_dkdv: one block per (b * KV + kv head, 32-key tile).  It
//     holds its K and V tile and loops over the G query heads of the GQA
//     group and, for each, over the live 32-row query tiles (_q_range of
//     the reference: from the tile's first key's row to the window's end),
//     accumulating dK and dV in registers; each block writes its own tile.
//   * flash_bwd_dq: one block per (b * H + head, 32-row query tile), heaviest
//     (latest) tiles first; it holds its Q and dO tile and loops over the
//     live 32-key tiles (_causal_kv_range), accumulating dQ in registers.
// Each recomputes S and dP for its tile pair, so the pair's logits are
// computed twice (14 D flops a live pair and head instead of 10 D).
//
// Layouts are the forward's, the JAX layout with no transposes: q, o, dO,
// dQ (B, Sq, H, D), k, v, dK, dV (B, Sk, KV, D), contiguous; lse and delta
// (B, H, Sq) f32.  Inputs f32 or bf16, read into f32 shared memory; all
// arithmetic f32; outputs in the inputs' dtype.  D a multiple of 8 up to 256.
//
// Bound on the H100: operations.  10 * D flops a live (q, k) pair and head
// (S, dP, dV, dK, dQ) on the tensor cores' 989 TFLOP/s, against the bytes
// of q, k, v, o, dO and the three gradients.  This first kernel is scalar:
// 256 threads, each 4 of the 32 x 32 pairs of a tile and 4 rows x D/32
// columns of its accumulators, f32 FMAs on the CUDA cores.  Tiles sit in
// shared memory in rows of D + 4 floats: the pairs' dot products read
// 16 bytes a lane (a row a lane for K and V, one row for the whole warp for
// Q and dO), and with the row length 4 mod 8 words each quarter-warp's
// 16-byte reads hit 32 distinct banks.  The tensor-core redesign (wgmma,
// TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;        // query rows a tile
constexpr int BKV = 32;       // keys a tile
constexpr int THREADS = 256;  // 8 warps: warp w owns rows w, w + 8, ...

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 32 rows of D elements, row r at src + r * stride, into f32 shared rows of
// ld = D + 4 floats; rows at or past n_valid are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t stride, int n_valid,
                                          int D) {
  for (int idx = threadIdx.x; idx < 32 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * ld + c] = r < n_valid ? to_f32(src[r * stride + c]) : 0.0f;
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

__device__ __forceinline__ bool live_pair(int qp, int kp, int Sq, int Sk,
                                          int window) {
  bool live = qp >= kp && kp < Sk && qp < Sq;
  if (window > 0) live = live && qp - kp < window;
  return live;
}

// Shared memory of either tile kernel: four 32-row f32 tiles of D + 4,
// two 32 x 33 pair tiles, lse and delta of 32 rows.
size_t smem_bytes(int D) {
  return ((size_t)(2 * BQ + 2 * BKV) * (D + 4) + (size_t)2 * BQ * (BKV + 1) +
          2 * BQ) *
         sizeof(float);
}

// delta[(b * H + h) * Sq + i] = sum_d dO[b, i, h, d] * o[b, i, h, d].
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int Sq, int H, int D,
                int64_t rows) {
  const int64_t row =
      (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s += to_f32(orow[d]) * to_f32(drow[d]);
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

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int Sq,
               int Sk, int D, int window, float softcap) {
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
    T* dkr = dk + kv_base + kr * kv_stride;
    T* dvr = dv + kv_base + kr * kv_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 32 * j;
      if (c < D) {
        store(dkr + c, dk_acc[i][j]);
        store(dvr + c, dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int H, int KV, int Sq, int Sk, int D,
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
    T* row = dq + q_base + r * q_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 32 * j;
      if (c < D) store(row + c, dq_acc[i][j]);
    }
  }
}

template <typename T, int DMAX>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           const float* lse, float* delta, T* dq, T* dk, T* dv, int B,
           int Sq, int Sk, int H, int KV, int D, int window, float softcap,
           cudaStream_t stream) {
  const int64_t rows = (int64_t)B * Sq * H;
  const int64_t delta_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  flash_bwd_delta<T><<<(unsigned)delta_blocks, THREADS, 0, stream>>>(
      o, dout, delta, Sq, H, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_bytes(D);
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;

  const dim3 kv_grid((unsigned)((Sk + BKV - 1) / BKV), (unsigned)(B * KV));
  flash_bwd_dkdv<T, DMAX><<<kv_grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, KV, Sq, Sk, D, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 q_grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_bwd_dq<T, DMAX><<<q_grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, H, KV, Sq, Sk, D, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int Sq, int Sk, int H, int KV, int D,
             int window, float softcap, cudaStream_t s) {
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v,
          *to = (const T*)o, *tdo = (const T*)dout;
  if (D <= 64)
    return launch<T, 64>(tq, tk, tv, to, tdo, lse, delta, (T*)dq, (T*)dk,
                         (T*)dv, B, Sq, Sk, H, KV, D, window, softcap, s);
  if (D <= 128)
    return launch<T, 128>(tq, tk, tv, to, tdo, lse, delta, (T*)dq, (T*)dk,
                          (T*)dv, B, Sq, Sk, H, KV, D, window, softcap, s);
  return launch<T, 256>(tq, tk, tv, to, tdo, lse, delta, (T*)dq, (T*)dk,
                        (T*)dv, B, Sq, Sk, H, KV, D, window, softcap, s);
}

}  // namespace

// ===========================================================================
// C interface
// ===========================================================================

// bf16 != 0: every tensor but lse and delta is bfloat16, else float32.
// delta is the caller's (B, H, Sq) f32 scratch; lse the forward's.  dq, dk
// and dv are written whole (keys no query sees get zeros).
extern "C" int flash_attention_bwd_launch(
    int bf16, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KV, int D, int window,
    float softcap, void* stream) {
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || B < 1 ||
      B * H > 65535 || Sq < 1 || Sk < Sq || window < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, B,
                                   Sq, Sk, H, KV, D, window, softcap, s);
  return launch_d<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, H,
                         KV, D, window, softcap, s);
}

extern "C" const char* flash_attention_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
