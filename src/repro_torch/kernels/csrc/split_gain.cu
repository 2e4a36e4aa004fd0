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
//   contraction so each product rounds as the torch version's does.
//
// Bound on the H100: device-memory bytes, K*A*B*C*4 read once (about 4.7 MB
// at K=256, A=9, B=256, C=2: about 1.4 us at 3.35 TB/s).  At that size the
// launch itself costs more than the traffic: the kernel is launch-bound.
//
// Design: one block per (k, a) row.  The block copies the (B, C) tile into
// shared memory (strided rows are allowed, so the (K, A, B+1, C) histogram
// with its unknown bin is read in place), runs a Hillis-Steele scan over
// bins for all classes at once (double-buffered), scores one bin per thread
// per pass, and reduces (score, bin) pairs with warp shuffles, keeping the
// lower bin on ties.  The discrete branch reduces its class and branch sums
// with the same block reduction.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define EPS_W 1e-7f

__device__ __forceinline__ float xlogx(float p) {
  return p > 0.0f ? p * log2f(p) : 0.0f;
}

// max(xlogx(W) - sum_c xlogx(n_c), 0) with W = sum_c n_c, both sums in
// ascending c; W is returned through w_out.
__device__ __forceinline__ float weighted_info(const float* a, int n_classes,
                                               float* w_out) {
  float w = 0.0f, s = 0.0f;
  for (int c = 0; c < n_classes; ++c) w += a[c];
  for (int c = 0; c < n_classes; ++c) s += xlogx(a[c]);
  *w_out = w;
  return fmaxf(xlogx(w) - s, 0.0f);
}

// weighted_info of right_c = known_c - left_c.
__device__ __forceinline__ float weighted_info_right(const float* known,
                                                     const float* left,
                                                     int n_classes,
                                                     float* w_out) {
  float w = 0.0f, s = 0.0f;
  for (int c = 0; c < n_classes; ++c) w += known[c] - left[c];
  for (int c = 0; c < n_classes; ++c) s += xlogx(known[c] - left[c]);
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

__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();                           // scratch reuse across calls
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int i = 0; i < n_warps; ++i) t += scratch[i];
  return t;
}

// (score, bin) argmax: larger score wins, the lower bin on ties.
__device__ __forceinline__ void take_better(float& s, int& b, float s2,
                                            int b2) {
  if (s2 > s || (s2 == s && b2 < b)) {
    s = s2;
    b = b2;
  }
}

__global__ void split_gain_kernel(
    const float* __restrict__ hist, int64_t stride_k, int64_t stride_a,
    const float* __restrict__ total_w, const uint8_t* __restrict__ is_cont,
    const int32_t* __restrict__ n_bins, float* __restrict__ score,
    int32_t* __restrict__ split_bin, int n_attrs, int B, int C,
    float min_objs, int gain_ratio) {
  extern __shared__ float smem[];
  float* buf0 = smem;                        // (B, C) tile / scan ping
  float* buf1 = smem + B * C;                // scan pong
  float* scratch = smem + 2 * B * C;         // 32 floats
  int* scratch_i = (int*)(scratch + 32);     // 32 ints

  const int k = blockIdx.x / n_attrs;
  const int a = blockIdx.x - k * n_attrs;
  const float* tile = hist + k * stride_k + a * stride_a;
  const int n = B * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf0[i] = tile[i];
  __syncthreads();

  const float tw = total_w[k];
  const float tw_safe = tw > EPS_W ? tw : 1.0f;
  const int nb = n_bins[a];
  float best_s = -INFINITY;
  int best_b = 0x7fffffff;

  if (is_cont[a]) {
    // inclusive prefix over bins, all classes at once
    float* src = buf0;
    float* dst = buf1;
    for (int d = 1; d < B; d <<= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int b = i / C;
        dst[i] = b >= d ? src[i] + src[i - d * C] : src[i];
      }
      __syncthreads();
      float* t = src;
      src = dst;
      dst = t;
    }
    const float* known = src + (B - 1) * C;
    float w_known;
    const float info_parent = weighted_info(known, C, &w_known);
    const float safe_w = w_known > EPS_W ? w_known : 1.0f;
    const float f = w_known / tw_safe;
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      const float* left = src + b * C;
      float wl, wr;
      const float il = weighted_info(left, C, &wl);
      const float ir = weighted_info_right(known, left, C, &wr);
      float gain = (info_parent - (il + ir)) / safe_w;
      gain = f * gain;
      if (gain_ratio) {
        const float denom = info2(wl, wr);
        gain = denom > EPS_W ? gain / denom : 0.0f;
      }
      const bool valid = b < nb - 1 && wl >= min_objs && wr >= min_objs;
      take_better(best_s, best_b, valid ? gain : -INFINITY, b);
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_down_sync(0xffffffffu, best_s, o);
      const int b2 = __shfl_down_sync(0xffffffffu, best_b, o);
      take_better(best_s, best_b, s2, b2);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      scratch[warp] = best_s;
      scratch_i[warp] = best_b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int n_warps = (blockDim.x + 31) >> 5;
      for (int i = 1; i < n_warps; ++i)
        take_better(best_s, best_b, scratch[i], scratch_i[i]);
      score[blockIdx.x] = best_s;
      split_bin[blockIdx.x] = best_b;
    }
    return;
  }

  // discrete: the multiway split over the structural bins b < nb
  float child_info = 0.0f, w_bins = 0.0f, w_bins_xlogx = 0.0f;
  float branches = 0.0f;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    float wb = 0.0f;
    float ib = 0.0f;
    if (b < nb) ib = weighted_info(buf0 + b * C, C, &wb);
    child_info += ib;
    w_bins += wb;
    w_bins_xlogx += xlogx(wb);
    branches += wb >= min_objs ? 1.0f : 0.0f;
  }
  child_info = block_sum(child_info, scratch);
  w_bins = block_sum(w_bins, scratch);
  w_bins_xlogx = block_sum(w_bins_xlogx, scratch);
  branches = block_sum(branches, scratch);
  // parent class counts over the structural bins, then their weight
  float* parent = buf1;
  for (int c = 0; c < C; ++c) {
    float v = 0.0f;
    for (int b = threadIdx.x; b < nb && b < B; b += blockDim.x)
      v += buf0[b * C + c];
    v = block_sum(v, scratch);
    if (threadIdx.x == 0) parent[c] = v;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float w_known;
  const float info_parent = weighted_info(parent, C, &w_known);
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
  score[blockIdx.x] = branches >= 2.0f ? gain : -INFINITY;
  split_bin[blockIdx.x] = -1;
}

extern "C" int split_gain_launch(
    const void* hist, long long stride_k, long long stride_a,
    const void* total_w, const void* is_cont, const void* n_bins, void* score,
    void* split_bin, int n_slots, int n_attrs, int B, int C, float min_objs,
    int gain_ratio, int threads, void* stream) {
  const size_t smem = (2 * (size_t)B * C + 64) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      split_gain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  split_gain_kernel<<<n_slots * n_attrs, threads, smem,
                      (cudaStream_t)stream>>>(
      (const float*)hist, (int64_t)stride_k, (int64_t)stride_a,
      (const float*)total_w, (const uint8_t*)is_cont, (const int32_t*)n_bins,
      (float*)score, (int32_t*)split_bin, n_attrs, B, C, min_objs,
      gain_ratio);
  return (int)cudaGetLastError();
}

extern "C" const char* split_gain_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
