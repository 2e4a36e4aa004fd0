// Frontier histogram: (K slots, A attributes, B+1 bins, C classes) weighted
// class counts of the cases in the open frontier.
//
// Replaces the TPU kernel repro.kernels.histogram.frontier_histogram
// (src/repro/kernels/histogram.py, body _hist_kernel), which counts with a
// one-hot matmul on the MXU.  On Hopper the same counts are a scatter-add:
// the formulation that module's docstring names for a GPU.
//
// What bounds it on the H100: device-memory bytes.  The function reads each
// live case once (the x row 4A bytes, y, w and slot 4 bytes each; read
// through a list, its index 4 bytes more) and writes each non-zero output
// cell once; one add per (case, attribute) is far below the card's scalar
// rate.
//
// Design (the plan, a pure function of the shapes, is autotune.HistPlan):
//   * a block walks tiles of block_t consecutive cases (grid-stride), two
//     tiles in flight: cp.async copies the next tile's x words (consecutive
//     threads on consecutive words of the row-major (N, A) array) and its
//     slot, y and w words into shared memory while the block counts this
//     one.  Each case row and slot is read once; slot and class fold into
//     one output offset a case.  Threads then take the tile's (attribute,
//     case) pairs, a warp 32 consecutive cases of one attribute;
//   * given a list of cases (int32 row indices, the live cases that
//     splitPost's routing kernel listed for this superstep), the n cases
//     are the listed rows: tile case i is row list[t0 + i], and its x words,
//     slot, y and w are copied by index (stage_listed) in place of a copy
//     of the live rows gathered beforehand.  A list is written a warp's
//     cases in ascending order, so a tile's rows mostly lie in runs.
//     Without a list (null) the kernel reads rows [0, n) as above;
//   * the grid follows the live count n: as many blocks as tiles, up to a
//     few waves, so no block exists only to zero and flush;
//   * "direct" plan (block_k = 0: every superstep but the densest): adds go
//     straight into the zeroed output (red.global.add).  The lanes of a
//     warp that add to one cell add once, their sum in lane order
//     (match.any): a node's cases crowd into few cells (one class, a narrow
//     range of the attributes it was split on), and device adds to one
//     address serialise in L2;
//   * "shared" plan (block_k > 0: the root and the first levels, a few
//     slots holding millions of cases): the block privatises the
//     A x (B+1) x C rows of the block_k live slots of its window
//     (blockIdx.y) in shared memory as int32 counts.  A float add in shared
//     memory is a compare-and-swap loop on Hopper (ATOMS.CAST.SPIN), and
//     the cases pile onto a few cells there, so the window adds each
//     weight's integral part with the native integer add (ATOMS.ADD); a
//     fraction, if any, goes to the output directly.  Once its tiles are
//     done the block adds each non-zero count to the output (one device
//     add per cell and block).  Cases of a slot beyond the live windows
//     (slot >= n_live) go to the output directly from the blocks of window
//     0, so any slot array is counted.
//
// What is left: the direct plan is bound by the rate of device adds in L2
// (tens of G/s, less on crowded cells), far below the bytes bound; the
// densest supersteps with tens to hundreds of live slots do not fit a
// shared window and pay it for every (case, attribute); the output's zero
// fill is the wrapper's torch.zeros, outside the kernel.
//
// Exactness: with integral weights and fewer than 2^24 cases per cell the
// sums are exact whatever order the adds run in (a list's order included),
// so the result equals the plain version bit for bit.  With non-integral weights the sums are exact
// only to rounding (atomics run in no fixed order).
//
// Out-of-contract values (a bin above B, a class outside [0, C), a slot
// outside [0, K)) are dropped rather than written out of bounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FULL 0xffffffffu
// Weights below this magnitude add their integral part as an int32: a
// block counts at most 2^23 cases (autotune.HIST_MAX_BLOCK_CASES), so a
// cell's integer sum stays below 2^31.
#define INT_PART_MAX 256.0f

// 4-byte global -> shared copy that does not wait for its data (cp.async):
// a thread issues all the words of a tile before the first one arrives.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One tile of block_t cases in shared memory: x words at an odd row stride
// a_pad, then slot (rewritten in place into the output offset code), y, w.
struct Tile {
  int32_t* xs;
  int32_t* code;
  int32_t* yv;
  float* wv;
};

__device__ __forceinline__ Tile tile_at(float* base, int block_t,
                                        int a_pad) {
  Tile t;
  t.xs = (int32_t*)base;
  t.code = t.xs + (size_t)block_t * a_pad;
  t.yv = t.code + block_t;
  t.wv = (float*)(t.yv + block_t);
  return t;
}

// Issue the copies of cases [t0, t0 + cnt) into tile t.
__device__ __forceinline__ void stage(const Tile& t, const int32_t* x,
                                      const int32_t* y, const float* w,
                                      const int32_t* slot, int64_t t0,
                                      int cnt, int n_attrs, int a_pad) {
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    copy4(t.code + i, slot + t0 + i);
    copy4(t.yv + i, y + t0 + i);
    copy4(t.wv + i, w + t0 + i);
  }
  const int32_t* xt = x + t0 * n_attrs;
  const int words = cnt * n_attrs;
  if (a_pad == n_attrs) {
    for (int j = threadIdx.x; j < words; j += blockDim.x)
      copy4(t.xs + j, xt + j);
  } else {
    // word j = (case i, attribute a), stepped without a division
    int i = threadIdx.x / n_attrs, a = threadIdx.x - i * n_attrs;
    const int di = blockDim.x / n_attrs, da = blockDim.x - di * n_attrs;
    for (int j = threadIdx.x; j < words; j += blockDim.x) {
      copy4(t.xs + i * a_pad + a, xt + j);
      i += di;
      a += da;
      if (a >= n_attrs) {
        a -= n_attrs;
        ++i;
      }
    }
  }
  copy_commit();
}

// Issue the copies of listed cases [t0, t0 + cnt): tile case i is row
// list[t0 + i].  The x loop reads its rows' indices again, from L1.
__device__ __forceinline__ void stage_listed(
    const Tile& t, const int32_t* x, const int32_t* y, const float* w,
    const int32_t* slot, const int32_t* list, int64_t t0, int cnt,
    int n_attrs, int a_pad) {
  const int32_t* rows = list + t0;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const int64_t r = __ldg(rows + i);
    copy4(t.code + i, slot + r);
    copy4(t.yv + i, y + r);
    copy4(t.wv + i, w + r);
  }
  // word j = (case i, attribute a): a warp's consecutive words lie in the
  // rows of a few cases
  const int words = cnt * n_attrs;
  int i = threadIdx.x / n_attrs, a = threadIdx.x - i * n_attrs;
  const int di = blockDim.x / n_attrs, da = blockDim.x - di * n_attrs;
  for (int j = threadIdx.x; j < words; j += blockDim.x) {
    copy4(t.xs + i * a_pad + a, x + (int64_t)__ldg(rows + i) * n_attrs + a);
    i += di;
    a += da;
    if (a >= n_attrs) {
      a -= n_attrs;
      ++i;
    }
  }
  copy_commit();
}

__global__ void __launch_bounds__(512) frontier_histogram_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const float* __restrict__ w, const int32_t* __restrict__ slot,
    const int32_t* __restrict__ list, float* __restrict__ out, int64_t n,
    int n_attrs, int n_slots, int n_live, int n_bins, int n_classes,
    int block_k, int block_t) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int a_pad = n_attrs | 1;               // odd stride: no bank conflict
  const int tile_floats = block_t * (a_pad + 3);
  int32_t* sub = (int32_t*)(smem + 2 * tile_floats);  // window counts

  const int attr_cells = (n_bins + 1) * n_classes;
  const int row = n_attrs * attr_cells;        // floats per slot
  const bool shared = block_k > 0;
  const int k0 = blockIdx.y * block_k;
  int kb = n_live - k0;
  if (kb > block_k) kb = block_k;
  const int n_sub = shared ? kb * row : 0;
  float* win_out = out + (int64_t)k0 * row;    // the window in the output
  for (int i = threadIdx.x; i < n_sub; i += blockDim.x) sub[i] = 0;

  // two tiles in flight: the next one's copies run under this one's adds
  const int64_t stride = (int64_t)gridDim.x * block_t;
  auto tile_cases = [&](int64_t t) {
    return n - t < block_t ? (int)(n - t) : block_t;
  };
  auto put = [&](float* base, int64_t t) {
    const Tile tile = tile_at(base, block_t, a_pad);
    if (list)
      stage_listed(tile, x, y, w, slot, list, t, tile_cases(t), n_attrs,
                   a_pad);
    else
      stage(tile, x, y, w, slot, t, tile_cases(t), n_attrs, a_pad);
  };
  int64_t t0 = (int64_t)blockIdx.x * block_t;
  if (t0 < n) put(smem, t0);
  for (int it = 0; t0 < n; t0 += stride, ++it) {
    const Tile cur = tile_at(smem + (it & 1) * tile_floats, block_t, a_pad);
    const int cnt = tile_cases(t0);
    const int64_t t1 = t0 + stride;
    if (t1 < n) {
      put(smem + (~it & 1) * tile_floats, t1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    // code = 2 * offset of (slot, attr 0, bin 0, class) + 1 if the offset
    // is into this block's shared window, -1 if the case is not counted here
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const int s = cur.code[i];
      const int c = cur.yv[i];
      int v = -1;
      if ((unsigned)c < (unsigned)n_classes &&
          (unsigned)s < (unsigned)n_slots) {
        if (!shared)
          v = 2 * (s * row + c);
        else if ((unsigned)(s - k0) < (unsigned)kb)
          v = 2 * ((s - k0) * row + c) + 1;
        else if (s >= n_live && blockIdx.y == 0)
          v = 2 * (s * row + c);
      }
      cur.code[i] = v;
    }
    __syncthreads();
    // pair j = (attribute a, case i): a warp takes consecutive cases of one
    // attribute; the shared reads stride a_pad (odd) words.  The loop runs
    // whole warps (the last one partly idle) for the warp-wide aggregation.
    const int words = cnt * n_attrs;
    int i = threadIdx.x % cnt, a = threadIdx.x / cnt;
    const int di = blockDim.x % cnt, da = blockDim.x / cnt;
    for (int j = threadIdx.x; j - lane < words; j += blockDim.x) {
      int key = -1;                            // 2 * offset + (1: window)
      float wv = 0.0f;
      if (j < words) {
        const int v = cur.code[i];
        int b = cur.xs[i * a_pad + a];
        if (b < 0) b = n_bins;                 // unknown value -> bin B
        if (v >= 0 && b <= n_bins) {
          key = v + 2 * (a * attr_cells + b * n_classes);
          wv = cur.wv[i];
        }
      }
      if (!shared) {
        // the lanes of one key add once: the lowest one adds their sum,
        // taken in lane order
        const unsigned grp = __match_any_sync(FULL, key);
        unsigned rest = key >= 0 ? grp : 0u;
        float sum = 0.0f;
        while (__any_sync(FULL, rest != 0u)) {
          const float u = __shfl_sync(FULL, wv, rest ? __ffs(rest) - 1 : 0);
          if (rest) {
            sum += u;
            rest &= rest - 1u;
          }
        }
        wv = sum;
        if (lane != __ffs(grp) - 1) key = -1;
      }
      if (key >= 0) {
        const int off = key >> 1;
        if (key & 1) {
          // the integral part through the native shared integer add; a
          // fraction (or a weight outside the integer range) to the output
          if (fabsf(wv) < INT_PART_MAX) {
            const float ip = truncf(wv);
            atomicAdd(sub + off, (int)ip);
            wv -= ip;
          }
          if (wv != 0.0f) atomicAdd(win_out + off, wv);
        } else {
          atomicAdd(out + off, wv);
        }
      }
      i += di;
      a += da;
      if (i >= cnt) {
        i -= cnt;
        ++a;
      }
    }
    __syncthreads();                           // before the tile is reused
  }
  if (!shared) return;
  __syncthreads();
  for (int i = threadIdx.x; i < n_sub; i += blockDim.x)
    if (sub[i] != 0) atomicAdd(win_out + i, (float)sub[i]);
}

// The kernel's dynamic shared-memory opt-in, set once per process and
// raised only when a launch needs more than any launch before it.
static int g_smem_attr = 48 * 1024;

extern "C" int frontier_histogram_launch(
    const void* x, const void* y, const void* w, const void* slot,
    const void* list, void* out, long long n, int n_attrs, int n_slots,
    int n_live, int n_bins, int n_classes, int block_k, int block_t,
    int blocks, int windows, int threads, int smem, void* stream) {
  if (smem > g_smem_attr) {
    cudaError_t err = cudaFuncSetAttribute(
        frontier_histogram_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_attr = smem;
  }
  frontier_histogram_kernel<<<dim3(blocks, windows), threads, smem,
                              (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const float*)w,
      (const int32_t*)slot, (const int32_t*)list, (float*)out, (int64_t)n,
      n_attrs, n_slots, n_live, n_bins, n_classes, block_k, block_t);
  return (int)cudaGetLastError();
}

extern "C" const char* frontier_histogram_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
