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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MASKED (-1e30f)

// Errors of this file beside cudaError_t's (see flash_attention_error).
#define ERR_NO_ENCODE 10001   // cuTensorMapEncodeTiled not found
#define ERR_ENCODE 10002      // cuTensorMapEncodeTiled refused the map
#define ERR_GEOMETRY 10003    // the caller's geometry is not the kernel's

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

constexpr int BK = 64;               // keys a tile
constexpr int THREADS = 384;         // warpgroups 0-1 consume, 2 loads
constexpr int STAGES = 2;            // K/V ring depth
constexpr int PANEL = 64 * 64 * 2;   // one 64 x 64 bf16 box (8 KB)
constexpr int BOX[4] = {64, 1, 64, 1};
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared memory of a block at padded head dim dp: 1 KB of slack to
// align the tiles to the 1,024-byte swizzle atom, Q (2 x dp/64 panels), K
// and V (STAGES x dp/64 panels each), 7 mbarriers.
constexpr int smem_bytes(int dp) {
  return 1024 + (2 + 2 * STAGES) * (dp / 64) * PANEL + 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed.  A wait past
// 10 s is a broken pipeline: it traps (the launch then fails) rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major (Q, K): the
// 8-row groups 1,024 bytes apart (SBO), LBO unused.  MN-major (V): LBO is
// the step between 64-column panels, SBO between 8-key groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from reading accumulators before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, shared) . B (64 x 16, shared)^T;
// both operands K-major, 128-byte swizzled.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, shared);
// B MN-major (transposed), 128-byte swizzled.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, shared);
// B MN-major (transposed), 128-byte swizzled.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D (64 x 192, f32) += A (64 x 16, registers) . B (16 x 192, shared);
// B MN-major (transposed), 128-byte swizzled.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, registers) . B (16 x 256, shared);
// B MN-major (transposed), 128-byte swizzled.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123,"
      "%124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}


// tanh on the MUFU (tanh.approx.f32, relative error about 2^-11): the
// library tanhf is a dozen instructions on the FMA pipe for each logit, and
// the softcap layer held the bf16 tolerance with either on every test case.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (DP == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (DP == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
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
        wgmma_pv<DP>(acc, a,
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

// cuTensorMapEncodeTiled is a driver call: taken through the runtime's
// entry-point query, so nothing beyond cudart is linked.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map {D, heads, S, B} (dims innermost first, byte strides of
// dims 1-3), box {64, 1, 64, 1}, 128-byte swizzle, zero fill.
static int encode(CUtensorMap* map, const void* ptr, const uint64_t* dims,
                  const uint64_t* strides, const uint32_t* box) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
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
  if (d_pad != 64 * ((D + 63) / 64) || smem != tc::smem_bytes(d_pad) ||
      q_dims[0] != (uint64_t)D || q_dims[1] != (uint64_t)H ||
      q_dims[2] != (uint64_t)Sq || q_dims[3] != (uint64_t)B ||
      kv_dims[0] != (uint64_t)D || kv_dims[1] != (uint64_t)KV ||
      kv_dims[2] != (uint64_t)Sk || kv_dims[3] != (uint64_t)B)
    return ERR_GEOMETRY;
  for (int i = 0; i < 4; ++i)
    if (box[i] != (uint32_t)tc::BOX[i]) return ERR_GEOMETRY;
  CUtensorMap qm, km, vm;
  int err = tc::encode(&qm, q, q_dims, q_strides, box);
  if (!err) err = tc::encode(&km, k, kv_dims, kv_strides, box);
  if (!err) err = tc::encode(&vm, v, kv_dims, kv_strides, box);
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
  switch (err) {
    case ERR_NO_ENCODE:
      return "cuTensorMapEncodeTiled not found in the driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused the tensor map";
    case ERR_GEOMETRY:
      return "geometry does not match the kernel's (d_pad, smem, dims, box)";
    default:
      return cudaGetErrorString((cudaError_t)err);
  }
}
