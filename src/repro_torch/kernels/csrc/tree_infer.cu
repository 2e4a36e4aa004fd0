// Forest traversal: the leaf class of every (tree, case) pair of a packed
// forest, descending at most max_depth levels through its node table.
//
// Replaces the TPU kernel repro.kernels.tree_infer.forest_predict
// (src/repro/kernels/tree_infer.py, body _infer_kernel), which keeps one
// tree's table in VMEM and turns every per-level gather into a one-hot
// matmul on the MXU.  On Hopper the gathers are what they are: one thread
// per (tree, case) chases its path through the table with indexed loads.
// Its specification is repro_torch.core.tree.descend_once, applied until the
// case sits at a leaf:
//   * continuous attribute: b <= split_bin -> child 0, else child 1;
//     discrete attribute: child b;
//   * then an unknown value (b < 0) follows the heavy child;
//   * then the child is clipped to [0, max(nchild - 1, 0)];
//   * a leaf (nchild == 0) absorbs, so the thread stops there: the plain
//     version's remaining steps would leave the node where it is.
// The case's bin is read only at internal nodes (leaves and padding rows
// have attr = -1).  An attribute of -1 at an internal node reads column 0,
// as descend_once does; one at or above A is out of contract and reads as
// unknown rather than past the row.  Child ids must lie below M.
//
// Table layout: (T, M, 8) int32, one 32-byte row per node: attr, split_bin,
// child0, nchild, heavy, class and two pad columns, read as two int4 loads.
//
// Bound on the H100: device-memory bytes.  The function reads each case's
// (A,) bins, each tree's table once and writes (T, N) int32 classes; it
// does a few integer compares per level.  Its real traffic is larger: each
// tree re-reads the case rows, and each level a 32-byte row per thread.
//
// Design:
//   * grid (ceil(N / threads), T), case blocks fastest: the blocks in
//     flight walk one tree at a time, so that tree's table (8.4 MB at
//     M = 2^18) stays in L2 while they read it;
//   * node rows through the read-only path (__ldg); the second int4 (heavy,
//     class) only when a value is unknown and once at the leaf;
//   * no shared memory: a variant that first copied a table of up to 48 KB
//     into each block's shared memory was slower than this cached read on
//     a forest of 1,024-node trees at N = 10M (each block pays the copy for
//     its 512 cases, where L1 already holds so small a table);
//   * 64-bit offsets for x and the output (T * N passes 2^31 at full size).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void forest_predict_kernel(const int4* __restrict__ tab,
                                      const int32_t* __restrict__ x,
                                      const uint8_t* __restrict__ is_cont,
                                      int32_t* __restrict__ out, int64_t n,
                                      int n_attrs, int m, int max_depth) {
  const int t = blockIdx.y;
  const int4* rows = tab + (int64_t)t * m * 2;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* xi = x + i * n_attrs;

  int node = 0;
  for (int d = 0; d < max_depth; ++d) {
    // attr, split_bin, child0, nchild
    const int4 lo = __ldg(rows + 2 * node);
    const int nchild = lo.w;
    if (nchild == 0) break;
    const int a = lo.x < 0 ? 0 : lo.x;
    const int b = a < n_attrs ? __ldg(xi + a) : -1;
    int child;
    if (b < 0) {
      child = __ldg(rows + 2 * node + 1).x;      // heavy child
    } else if (a < n_attrs && __ldg(is_cont + a)) {
      child = b <= lo.y ? 0 : 1;
    } else {
      child = b;
    }
    const int top = nchild - 1;
    child = child < 0 ? 0 : (child > top ? top : child);
    node = lo.z + child;
  }
  out[(int64_t)t * n + i] = __ldg(rows + 2 * node + 1).y;   // class
}

extern "C" int forest_predict_launch(const void* tab, const void* x,
                                     const void* is_cont, void* out,
                                     long long n, int n_attrs, int n_trees,
                                     int m, int max_depth, int threads,
                                     void* stream) {
  const long long n_blocks = (n + threads - 1) / threads;
  if (n_blocks > 0x7fffffffLL || n_trees > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)n_blocks, (unsigned)n_trees);
  forest_predict_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int4*)tab, (const int32_t*)x, (const uint8_t*)is_cont,
      (int32_t*)out, (int64_t)n, n_attrs, m, max_depth);
  return (int)cudaGetLastError();
}

extern "C" const char* forest_predict_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
