// Frontier histogram: (K slots, A attributes, B+1 bins, C classes) weighted
// class counts of the cases in the open frontier.
//
// Replaces the TPU kernel repro.kernels.histogram.frontier_histogram
// (src/repro/kernels/histogram.py, body _hist_kernel), which counts with a
// one-hot matmul on the MXU.  On Hopper the same counts are a scatter-add:
// the formulation that module's docstring names for a GPU.
//
// Bound on the H100: device-memory bytes.  The function reads each live case
// once (x row 4A bytes, y, w and slot 4 bytes each) and writes the
// K*A*(B+1)*C f32 output once; it does no arithmetic worth counting.
//
// Design:
//   * a 1-D grid over (case chunk, slot block, attribute), attribute
//     fastest: a block owns one attribute, a window of block_k slots and a
//     chunk of block_t cases, and the blocks that read the same chunk of
//     cases run side by side, so the A attribute blocks share the chunk's
//     x rows (and all share its slots) through L2;
//   * the block privatises its block_k x (B+1) x C sub-histogram in shared
//     memory (dynamic; above 48 KB after cudaFuncSetAttribute), so the hot
//     atomics are shared-memory atomics, not device-memory ones;
//   * each thread walks the chunk with a block-wide stride, reads the
//     case's slot (coalesced) and skips cases outside its slot window before
//     touching x, y or w;
//   * after a barrier the block adds its non-zero entries to the zeroed
//     output with device atomics (one per non-zero cell and block).
//
// Known costs left for later work: the attribute column read x[i*A + a] is
// strided in the (N, A) layout (a 32-byte sector serves one 4-byte bin per
// block; the A blocks of a chunk share sectors only through L2), and every
// slot block re-reads the slot array of its chunk.
//
// Exactness: with integral weights and fewer than 2^24 cases per cell the
// f32 sums are exact whatever order the atomics run in, so the result equals
// the plain version bit for bit.  With non-integral weights the sums are
// exact only to rounding (atomics run in no fixed order).
//
// Out-of-contract values (a bin above B, a class outside [0, C)) are dropped
// rather than written out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void frontier_histogram_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const float* __restrict__ w, const int32_t* __restrict__ slot,
    float* __restrict__ out, int64_t n, int n_attrs, int n_slots,
    int n_bins, int n_classes, int block_k, int n_kb, int64_t block_t) {
  extern __shared__ float sub[];
  const int a = blockIdx.x % n_attrs;
  const int k0 = (blockIdx.x / n_attrs) % n_kb * block_k;
  const int64_t chunk = blockIdx.x / ((unsigned)n_attrs * n_kb);
  const int kb = block_k < n_slots - k0 ? block_k : n_slots - k0;
  const int row = (n_bins + 1) * n_classes;   // floats per slot
  const int n_sub = kb * row;

  for (int i = threadIdx.x; i < n_sub; i += blockDim.x) sub[i] = 0.0f;
  __syncthreads();

  const int64_t start = chunk * block_t;
  const int64_t end = start + block_t < n ? start + block_t : n;
  for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x) {
    const int s = slot[i] - k0;
    if ((unsigned)s >= (unsigned)kb) continue;
    int b = x[i * n_attrs + a];
    if (b < 0) b = n_bins;                     // unknown value -> bin B
    const int c = y[i];
    if (b > n_bins || (unsigned)c >= (unsigned)n_classes) continue;
    atomicAdd(&sub[s * row + b * n_classes + c], w[i]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_sub; i += blockDim.x) {
    const float v = sub[i];
    if (v != 0.0f) {
      const int s = i / row;
      const int r = i - s * row;
      atomicAdd(&out[((int64_t)(k0 + s) * n_attrs + a) * row + r], v);
    }
  }
}

extern "C" int frontier_histogram_launch(
    const void* x, const void* y, const void* w, const void* slot, void* out,
    long long n, int n_attrs, int n_slots, int n_bins, int n_classes,
    int block_k, long long block_t, int threads, void* stream) {
  const int kb = block_k < n_slots ? block_k : n_slots;
  const size_t smem = (size_t)kb * (n_bins + 1) * n_classes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      frontier_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_chunks = (n + block_t - 1) / block_t;
  const int n_kb = (n_slots + block_k - 1) / block_k;
  const long long n_blocks = n_chunks * n_kb * n_attrs;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  frontier_histogram_kernel<<<(unsigned)n_blocks, threads, smem,
                              (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const float*)w,
      (const int32_t*)slot, (float*)out, (int64_t)n, n_attrs, n_slots, n_bins,
      n_classes, block_k, n_kb, (int64_t)block_t);
  return (int)cudaGetLastError();
}

extern "C" const char* frontier_histogram_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
