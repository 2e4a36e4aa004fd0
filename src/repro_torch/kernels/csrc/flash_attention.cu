// Flash attention forward: causal GQA attention with an optional sliding
// window and tanh logit softcap, one online softmax over KV tiles.
//
// Replaces the TPU kernel repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py, body _flash_fwd_kernel), which
// walks a (batch x head, q block, kv block) grid with the KV axis innermost
// and keeps the output block and the softmax statistics in VMEM scratch.
// On Hopper the KV axis becomes a loop inside the block.  It computes, for
// q pre-scaled by 1/sqrt(D) in its own dtype (the wrapper does that, as the
// JAX function does before its pallas_call):
//   * logits = q . k in f32; with softcap > 0, tanh(logits / cap) * cap;
//   * mask: q_pos >= k_pos (q_offset 0), k_pos < Sk, q_pos < Sq, and with
//     window > 0 also q_pos - k_pos < window; masked logits are the finite
//     -1e30 of the reference, never -inf (exp(-inf - -inf) would be NaN);
//   * m starts at -1e30, so a row whose first live tile is all masked gets
//     p = 1 there and a later tile's corr = exp(-1e30 - m) = 0 wipes it, as
//     in the reference;
//   * query head h reads KV head h / (H / KV) (heads-major GQA);
//   * out = acc / max(l, 1e-30), written in q's dtype.
// expf and tanhf, not the fast intrinsics, so f32 results stay within a few
// ulp of the torch version.
//
// Layouts: q and out (B, Sq, H, D), k and v (B, Sk, KV, D), contiguous, in
// f32 or bf16; D a multiple of 8 up to 256 (16-byte row loads).  Sq and Sk
// are ragged by bounds checks, not by padding copies.
//
// Bound on the H100: operations.  4 * H * D flops per live (q, k) pair on
// the tensor cores' 989 TFLOP/s (bf16), against (2*Sq*H*D + 2*Sk*KV*D) * 2
// bytes at 3.35 TB/s: at Sq = Sk = 7,000, H = 16, KV = 8, D = 256 a global
// layer needs 0.41 ms of operations and 0.05 ms of bytes.
//
// Design (a first kernel that is right; wgmma and TMA come later):
//   * one block of 256 threads per (b*h, 64-query tile), heaviest (last)
//     tiles first so the causal triangle's long rows start early;
//   * a loop over the live 64-key tiles only, [lo, hi) as
//     repro.models.layers._causal_kv_range computes it (the counterpart of
//     pl.when(live)): tiles above the diagonal and, with a window, tiles
//     wholly older than the window are never loaded;
//   * Q, K and V tiles are converted to f32 in dynamic shared memory (rows
//     padded to D + 1 floats, so a column walk hits 16 different banks),
//     214,016 bytes at D = 256, above the 48 KB default, hence
//     cudaFuncSetAttribute;
//   * each thread owns a 4 x 4 micro-tile of the 64 x 64 logits (rows
//     ty + 16 i, columns tx + 16 j) and 4 rows x D/16 columns of the f32
//     accumulator in registers (64 floats at D = 256); row max and row sum
//     reduce over the 16 lanes of a row with xor shuffles; p goes through
//     shared memory to the P.V product;
//   * plain f32 FMAs on the CUDA cores (67 TFLOP/s, not the tensor cores),
//     so the kernel sits far above its operations bound: the gap is the
//     finding a later wgmma kernel starts from.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BQ 64
#define BK 64
#define THREADS 256
#define MASKED (-1e30f)

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);                  // round to nearest even
}

// Rows [0, 64) of D elements, row r at src + r * stride, into dst rows of
// ld floats; rows at or past n_valid are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t stride, int n_valid,
                                          int D) {
  constexpr int VEC = 16 / sizeof(T);
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

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int Sq, int Sk, int D, int window, float softcap) {
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
  const T* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)kvh * D;
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
    T* row = o + ((int64_t)b * Sq + qp) * q_stride + (int64_t)h * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(row + d, acc[i][j] / denom);
    }
  }
}

template <typename T, int DMAX>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int Sq, int Sk, int H, int KV, int D, int window,
                  float softcap, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Sq, Sk, D, window,
      softcap);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Sk, int H, int KV, int D, int window,
                    float softcap, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, D, window, softcap,
                         stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, D, window, softcap,
                          stream);
  return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, D, window, softcap,
                        stream);
}

// dtype: 0 = f32, 1 = bf16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int D, int window, float softcap,
                                      void* stream) {
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || B * H > 65535 ||
      Sq < 1 || Sk < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Sq, Sk, H, KV, D, window, softcap,
                           s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, D, window,
                                   softcap, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
