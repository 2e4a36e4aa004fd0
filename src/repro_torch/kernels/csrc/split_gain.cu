// Fused split-gain scoring: per (slot k, attribute a) of the frontier
// histogram, the best C4.5 split score and its threshold bin.
//
// Replaces the TPU kernel repro.kernels.split_gain.split_gain
// (src/repro/kernels/split_gain.py, body _gain_kernel), whose body calls the
// JAX scorer per VMEM block.  This kernel writes that math out itself; its
// specification is repro_torch.core.entropy.gains_from_histogram, kept op
// for op:
//   * continuous attribute: inclusive prefix scan over bins per class; for
//     every threshold b < n_bins-1 whose sides both weigh >= min_objs,
//     gain = F * (wi(known) - (wi(left) + wi(right))) / safe_w, with
//     wi(n) = max(xlogx(sum_c n_c) - sum_c xlogx(n_c), 0), class sums in
//     ascending c, F = W_known / W_total; gain ratio divides by the split
//     info of (W_left, W_right); the first maximum wins;
//   * discrete attribute: the multiway split over the bins < n_bins, valid
//     when at least two branches weigh >= min_objs; split_bin = -1.
//   f32 throughout, log2f (not __log2f), built without fused multiply-add
//   contraction so each product rounds as the torch version's does.  The
//   scan and the bin sums add in another order than torch's: exact for
//   integral counts, within f32 rounding otherwise.
//
// Bound on the H100: device-memory bytes, K*A*B*C*4 read once (about 4.7 MB
// at K=256, A=9, B=256, C=2: about 1.4 us at 3.35 TB/s).
//
// Design: one warp per (k, a) row, `warps` rows per block, no block
// barrier.  The warp copies its (B, C) tile (a strided row of the
// (K, A, B+1, C) histogram, read in place) into its own shared memory with
// the widest aligned loads (16, 8 or 4 bytes), as C class planes of 32
// lane segments of `seg` consecutive bins, each segment padded to an odd
// stride so that the 32 lanes of a warp hit 32 banks.  Per class each lane
// sums its segment, a shuffle scan of the lane totals gives its offset and
// the lane scans its segment in place; each lane scores its own bins and a
// shuffle argmax keeps the larger score and, on ties, the lower bin.  The
// discrete branch sums its terms with shuffle reductions.
//
// The logarithms are most of the work, so two exact shortcuts skip them: an
// empty bin (its prefix equals the bin before it, so its score does, and
// the lower bin wins the tie) is not scored, and a threshold whose sides
// weigh less than min_objs scores -inf from the weights alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define EPS_W 1e-7f
#define FULL 0xffffffffu

__device__ __forceinline__ float xlogx(float p) {
  return p > 0.0f ? p * log2f(p) : 0.0f;
}

// max(xlogx(W) - sum_c xlogx(n_c), 0) with W = sum_c n_c, both sums in
// ascending c; n_c = a[c * stride]; W is returned through w_out.
__device__ __forceinline__ float weighted_info(const float* a, int stride,
                                               int n_classes, float* w_out) {
  float w = 0.0f, s = 0.0f;
  for (int c = 0; c < n_classes; ++c) w += a[c * stride];
  for (int c = 0; c < n_classes; ++c) s += xlogx(a[c * stride]);
  *w_out = w;
  return fmaxf(xlogx(w) - s, 0.0f);
}

// weighted_info of right_c = known_c - left_c.
__device__ __forceinline__ float weighted_info_right(const float* known,
                                                     const float* left,
                                                     int stride,
                                                     int n_classes,
                                                     float* w_out) {
  float w = 0.0f, s = 0.0f;
  for (int c = 0; c < n_classes; ++c)
    w += known[c * stride] - left[c * stride];
  for (int c = 0; c < n_classes; ++c)
    s += xlogx(known[c * stride] - left[c * stride]);
  *w_out = w;
  return fmaxf(xlogx(w) - s, 0.0f);
}

// info of a 2-vector (wl, wr): the gain-ratio denominator.
__device__ __forceinline__ float info2(float wl, float wr) {
  const float w = wl + wr;
  const float safe_w = w > EPS_W ? w : 1.0f;
  const float s = xlogx(wl) + xlogx(wr);
  const float ent = log2f(safe_w) - s / safe_w;
  return w > EPS_W ? fmaxf(ent, 0.0f) : 0.0f;
}

// (score, bin) argmax: larger score wins, the lower bin on ties.
__device__ __forceinline__ void take_better(float& s, int& b, float s2,
                                            int b2) {
  if (s2 > s || (s2 == s && b2 < b)) {
    s = s2;
    b = b2;
  }
}

// (score, bin) argmax over the warp, the same pair in every lane.
__device__ __forceinline__ void warp_argmax(float& s, int& b) {
  for (int o = 16; o > 0; o >>= 1) {
    const float s2 = __shfl_xor_sync(FULL, s, o);
    const int b2 = __shfl_xor_sync(FULL, b, o);
    take_better(s, b, s2, b2);
  }
}

// Sum over the warp, the same value in every lane.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The multiway split's score from its warp-summed terms (lane 0 only).
__device__ __forceinline__ float discrete_score(
    float child_info, float w_bins, float w_bins_xlogx, float branches,
    float w_known, float s_parent, float tw_safe, int gain_ratio) {
  const float info_parent = fmaxf(xlogx(w_known) - s_parent, 0.0f);
  const float safe_w = w_known > EPS_W ? w_known : 1.0f;
  float gain = (info_parent - child_info) / safe_w;
  gain = (w_known / tw_safe) * gain;
  gain = w_known > EPS_W ? fmaxf(gain, 0.0f) : 0.0f;
  if (gain_ratio) {
    // split info: the entropy of the branch weights
    const float safe_b = w_bins > EPS_W ? w_bins : 1.0f;
    const float ent = log2f(safe_b) - w_bins_xlogx / safe_b;
    const float denom = w_bins > EPS_W ? fmaxf(ent, 0.0f) : 0.0f;
    gain = denom > EPS_W ? gain / denom : 0.0f;
  }
  return branches >= 2.0f ? gain : -INFINITY;
}

// A continuous threshold's score from its sides' information and weights.
__device__ __forceinline__ float threshold_score(
    float il, float ir, float wl, float wr, float info_parent, float safe_w,
    float f, int gain_ratio) {
  float gain = (info_parent - (il + ir)) / safe_w;
  gain = f * gain;
  if (gain_ratio) {
    const float denom = info2(wl, wr);
    gain = denom > EPS_W ? gain / denom : 0.0f;
  }
  return gain;
}

__global__ void split_gain_kernel(
    const float* __restrict__ hist, int64_t stride_k, int64_t stride_a,
    const float* __restrict__ total_w, const uint8_t* __restrict__ is_cont,
    const int32_t* __restrict__ n_bins, float* __restrict__ score,
    int32_t* __restrict__ split_bin, int n_rows, int n_attrs, int B, int C,
    int seg, int seg_pad, float min_objs, int gain_ratio) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= n_rows) return;                   // warp-uniform
  const int plane = 32 * seg_pad;            // floats per class plane
  float* t = smem + (size_t)warp * C * plane;
  const int k = r / n_attrs;
  const int a = r - k * n_attrs;
  const float* tile = hist + k * stride_k + a * stride_a;

  // the (B, C) tile into class planes: bin b at lane b / seg, slot b % seg
  const int n = B * C;
  const uintptr_t addr = (uintptr_t)tile;
  const int vec = (addr % 16 == 0 && n % 4 == 0) ? 4
                  : (addr % 8 == 0 && n % 2 == 0) ? 2 : 1;
  const bool pow2 = C == 2 && (seg & (seg - 1)) == 0;
  const int seg_shift = __ffs(seg) - 1;
  // each lane issues up to LOADS loads before it stores the first value
  constexpr int LOADS = 8;
  for (int e0 = lane * vec; e0 < n; e0 += 32 * vec * LOADS) {
    float v[LOADS][4];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + u * 32 * vec;
      if (e >= n) break;
      if (vec == 4) {
        const float4 q = *(const float4*)(tile + e);
        v[u][0] = q.x; v[u][1] = q.y; v[u][2] = q.z; v[u][3] = q.w;
      } else if (vec == 2) {
        const float2 q = *(const float2*)(tile + e);
        v[u][0] = q.x; v[u][1] = q.y;
      } else {
        v[u][0] = tile[e];
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + u * 32 * vec;
      if (e >= n) break;
      for (int j = 0; j < vec; ++j) {
        int b, c, l;
        if (pow2) {                          // two classes, seg a power of 2
          b = (e + j) >> 1;
          c = (e + j) & 1;
          l = b >> seg_shift;
        } else {
          b = (e + j) / C;
          c = e + j - b * C;
          l = b / seg;
        }
        t[c * plane + l * seg_pad + (b - l * seg)] = v[u][j];
      }
    }
  }
  __syncwarp();

  const int b0 = lane * seg;                 // this lane's first bin
  int n_own = B - b0;                        // and its number of bins
  n_own = n_own < 0 ? 0 : (n_own > seg ? seg : n_own);
  float* own = t + lane * seg_pad;
  const float tw = total_w[k];
  const float tw_safe = tw > EPS_W ? tw : 1.0f;
  const int nb = n_bins[a];

  if (is_cont[a]) {
    // inclusive prefix over bins, one class plane at a time
    for (int c = 0; c < C; ++c) {
      float* p = own + c * plane;
      float s = 0.0f;
      for (int i = 0; i < n_own; ++i) s += p[i];
      float incl = s;
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += u;
      }
      float run = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) run = 0.0f;
      for (int i = 0; i < n_own; ++i) {
        run += p[i];
        p[i] = run;
      }
    }
    __syncwarp();
    const int lk = (B - 1) / seg;
    const float* known = t + lk * seg_pad + (B - 1 - lk * seg);
    float w_known;
    const float info_parent = weighted_info(known, plane, C, &w_known);
    const float safe_w = w_known > EPS_W ? w_known : 1.0f;
    const float f = w_known / tw_safe;
    float best_s = -INFINITY;
    int best_b = 0x7fffffff;
    for (int i = 0; i < n_own; ++i) {
      const int b = b0 + i;
      const float* left = own + i;
      // an empty bin b > 0 has bin b-1's prefix, so bin b-1's score, and
      // the lower bin wins a tie: skipping it changes no output
      if (b > 0) {
        const float* prev = i > 0 ? left - 1 : left - seg_pad + seg - 1;
        bool same = true;
        for (int c = 0; c < C; ++c)
          same &= left[c * plane] == prev[c * plane];
        if (same) continue;
      }
      // the sides' weights (summed as weighted_info sums them) first: an
      // invalid threshold scores -inf whatever its information
      float wl = 0.0f, wr = 0.0f;
      for (int c = 0; c < C; ++c) wl += left[c * plane];
      for (int c = 0; c < C; ++c) wr += known[c * plane] - left[c * plane];
      if (!(b < nb - 1 && wl >= min_objs && wr >= min_objs)) {
        take_better(best_s, best_b, -INFINITY, b);
        continue;
      }
      const float il = weighted_info(left, plane, C, &wl);
      const float ir = weighted_info_right(known, left, plane, C, &wr);
      take_better(best_s, best_b,
                  threshold_score(il, ir, wl, wr, info_parent, safe_w, f,
                                  gain_ratio), b);
    }
    warp_argmax(best_s, best_b);
    if (lane == 0) {
      score[r] = best_s;
      split_bin[r] = best_b;
    }
    return;
  }

  // discrete: the multiway split over the structural bins b < nb
  float child_info = 0.0f, w_bins = 0.0f, w_bins_xlogx = 0.0f;
  float branches = 0.0f;
  for (int i = 0; i < n_own; ++i) {
    float wb = 0.0f;
    float ib = 0.0f;
    if (b0 + i < nb) ib = weighted_info(own + i, plane, C, &wb);
    child_info += ib;
    w_bins += wb;
    w_bins_xlogx += xlogx(wb);
    branches += wb >= min_objs ? 1.0f : 0.0f;
  }
  child_info = warp_sum(child_info);
  w_bins = warp_sum(w_bins);
  w_bins_xlogx = warp_sum(w_bins_xlogx);
  branches = warp_sum(branches);
  // the parent's class counts over the structural bins, summed into its
  // weight and its xlogx term in ascending c, as weighted_info does
  float w_known = 0.0f, s_parent = 0.0f;
  for (int c = 0; c < C; ++c) {
    float v = 0.0f;
    for (int i = 0; i < n_own && b0 + i < nb; ++i) v += own[c * plane + i];
    v = warp_sum(v);
    w_known += v;
    s_parent += xlogx(v);
  }
  if (lane != 0) return;
  score[r] = discrete_score(child_info, w_bins, w_bins_xlogx, branches,
                            w_known, s_parent, tw_safe, gain_ratio);
  split_bin[r] = -1;
}


// weighted_info of a register vector / of known - left (see above).
template <int C>
__device__ __forceinline__ float winfo(const float (&a)[C], float* w_out) {
  float w = 0.0f, s = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) w += a[c];
#pragma unroll
  for (int c = 0; c < C; ++c) s += xlogx(a[c]);
  *w_out = w;
  return fmaxf(xlogx(w) - s, 0.0f);
}

template <int C>
__device__ __forceinline__ float winfo_right(const float (&known)[C],
                                             const float (&left)[C],
                                             float* w_out) {
  float w = 0.0f, s = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) w += known[c] - left[c];
#pragma unroll
  for (int c = 0; c < C; ++c) s += xlogx(known[c] - left[c]);
  *w_out = w;
  return fmaxf(xlogx(w) - s, 0.0f);
}

// The same function for C classes and B <= 32 * SEG bins, held in
// registers: lane l owns bins [l * SEG, l * SEG + SEG), which are SEG * C
// consecutive floats of the row, loaded 8 bytes at a time where aligned.
// An empty bin (all its counts zero: its prefix is the bin before it) is
// not scored.
template <int C, int SEG>
__global__ void __launch_bounds__(1024) split_gain_regs_kernel(
    const float* __restrict__ hist, int64_t stride_k, int64_t stride_a,
    const float* __restrict__ total_w, const uint8_t* __restrict__ is_cont,
    const int32_t* __restrict__ n_bins, float* __restrict__ score,
    int32_t* __restrict__ split_bin, int n_rows, int n_attrs, int B,
    float min_objs, int gain_ratio) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= n_rows) return;                   // warp-uniform
  const int k = r / n_attrs;
  const int a = r - k * n_attrs;
  const float* tile = hist + k * stride_k + a * stride_a;
  const int b0 = lane * SEG;
  const int e0 = b0 * C, n = B * C;

  float v[SEG][C];                           // raw counts, then prefixes
  float raw[SEG][C];
  if (((uintptr_t)tile & 7) == 0 && (SEG * C) % 2 == 0 && e0 + SEG * C <= n) {
#pragma unroll
    for (int j = 0; j < SEG * C; j += 2) {
      const float2 q = *(const float2*)(tile + e0 + j);
      v[j / C][j % C] = q.x;
      v[(j + 1) / C][(j + 1) % C] = q.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < SEG * C; ++j)
      v[j / C][j % C] = e0 + j < n ? tile[e0 + j] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < SEG; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) raw[i][c] = v[i][c];
  const float tw = total_w[k];
  const float tw_safe = tw > EPS_W ? tw : 1.0f;
  const int nb = n_bins[a];

  if (is_cont[a]) {
    // per class: the lane's total, a shuffle scan of the totals, then the
    // lane's bins from its exclusive offset
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < SEG; ++i) s += v[i][c];
      float incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += u;
      }
      float run = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) run = 0.0f;
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        run += v[i][c];
        v[i][c] = run;
      }
    }
    // known = the prefix at bin B-1, from the lane that owns it
    const int lk = (B - 1) / SEG, ik = (B - 1) - lk * SEG;
    float known[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float kv = 0.0f;
#pragma unroll
      for (int i = 0; i < SEG; ++i) kv = i == ik ? v[i][c] : kv;
      known[c] = __shfl_sync(FULL, kv, lk);
    }
    float w_known;
    const float info_parent = winfo<C>(known, &w_known);
    const float safe_w = w_known > EPS_W ? w_known : 1.0f;
    const float f = w_known / tw_safe;
    float best_s = -INFINITY;
    int best_b = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      const int b = b0 + i;
      if (b >= B) continue;
      bool empty = b > 0;
#pragma unroll
      for (int c = 0; c < C; ++c) empty &= raw[i][c] == 0.0f;
      if (empty) continue;
      float wl = 0.0f, wr = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) wl += v[i][c];
#pragma unroll
      for (int c = 0; c < C; ++c) wr += known[c] - v[i][c];
      if (!(b < nb - 1 && wl >= min_objs && wr >= min_objs)) {
        take_better(best_s, best_b, -INFINITY, b);
        continue;
      }
      const float il = winfo<C>(v[i], &wl);
      const float ir = winfo_right<C>(known, v[i], &wr);
      take_better(best_s, best_b,
                  threshold_score(il, ir, wl, wr, info_parent, safe_w, f,
                                  gain_ratio), b);
    }
    warp_argmax(best_s, best_b);
    if (lane == 0) {
      score[r] = best_s;
      split_bin[r] = best_b;
    }
    return;
  }

  // discrete: the multiway split over the structural bins b < nb
  float child_info = 0.0f, w_bins = 0.0f, w_bins_xlogx = 0.0f;
  float branches = 0.0f;
#pragma unroll
  for (int i = 0; i < SEG; ++i) {
    if (b0 + i >= B) continue;
    float wb = 0.0f;
    float ib = 0.0f;
    if (b0 + i < nb) ib = winfo<C>(v[i], &wb);
    child_info += ib;
    w_bins += wb;
    w_bins_xlogx += xlogx(wb);
    branches += wb >= min_objs ? 1.0f : 0.0f;
  }
  child_info = warp_sum(child_info);
  w_bins = warp_sum(w_bins);
  w_bins_xlogx = warp_sum(w_bins_xlogx);
  branches = warp_sum(branches);
  float w_known = 0.0f, s_parent = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float u = 0.0f;
#pragma unroll
    for (int i = 0; i < SEG; ++i) u += b0 + i < nb ? v[i][c] : 0.0f;
    u = warp_sum(u);
    w_known += u;
    s_parent += xlogx(u);
  }
  if (lane != 0) return;
  score[r] = discrete_score(child_info, w_bins, w_bins_xlogx, branches,
                            w_known, s_parent, tw_safe, gain_ratio);
  split_bin[r] = -1;
}

// The kernel's dynamic shared-memory opt-in, set once per process and
// raised only when a launch needs more than any launch before it.
static int g_smem_attr = 48 * 1024;

extern "C" int split_gain_launch(
    const void* hist, long long stride_k, long long stride_a,
    const void* total_w, const void* is_cont, const void* n_bins, void* score,
    void* split_bin, int n_slots, int n_attrs, int B, int C, float min_objs,
    int gain_ratio, int warps, int regs, int seg, int seg_pad, int smem,
    void* stream) {
  const int n_rows = n_slots * n_attrs;
  const int blocks = (n_rows + warps - 1) / warps;
  cudaStream_t st = (cudaStream_t)stream;
  const float* h = (const float*)hist;
  const float* t = (const float*)total_w;
  const uint8_t* ic = (const uint8_t*)is_cont;
  const int32_t* nb = (const int32_t*)n_bins;
  float* sc = (float*)score;
  int32_t* sb = (int32_t*)split_bin;
  if (regs) {
    // two classes, B <= 32 * seg: the register kernel of that segment
#define REGS_CASE(SEG)                                                      \
  case SEG:                                                                 \
    split_gain_regs_kernel<2, SEG><<<blocks, 32 * warps, 0, st>>>(          \
        h, stride_k, stride_a, t, ic, nb, sc, sb, n_rows, n_attrs, B,       \
        min_objs, gain_ratio);                                              \
    break;
    if (C != 2 || B > 32 * seg) return (int)cudaErrorInvalidValue;
    switch (seg) {
      REGS_CASE(1)
      REGS_CASE(2)
      REGS_CASE(4)
      REGS_CASE(8)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef REGS_CASE
    return (int)cudaGetLastError();
  }
  if (smem > g_smem_attr) {
    cudaError_t err = cudaFuncSetAttribute(
        split_gain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_attr = smem;
  }
  split_gain_kernel<<<blocks, 32 * warps, smem, st>>>(
      h, (int64_t)stride_k, (int64_t)stride_a, t, ic, nb, sc, sb, n_rows,
      n_attrs, B, C, seg, seg_pad, min_objs, gain_ratio);
  return (int)cudaGetLastError();
}

extern "C" const char* split_gain_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
