// Forest traversal: the leaf class of every (tree, case) pair of a packed
// forest, descending at most max_depth levels through its node table.
//
// Replaces the TPU kernel repro.kernels.tree_infer.forest_predict
// (src/repro/kernels/tree_infer.py, body _infer_kernel), which keeps one
// tree's table in VMEM and turns every per-level gather into a one-hot
// matmul on the MXU.  On Hopper the gathers are what they are: one thread
// per (tree, case) chases its path through the table with indexed loads.
// Its specification is repro_torch.kernels.ref.forest_predict_ref (the
// steps of repro_torch.core.tree.descend_once), applied until the case sits
// at a leaf:
//   * continuous attribute: b <= split_bin -> child 0, else child 1;
//     discrete attribute: child b;
//   * then an unknown value (b < 0) follows the heavy child;
//   * then the child is clipped to [0, max(nchild - 1, 0)];
//   * a leaf (nchild == 0) absorbs, so the thread stops there: the plain
//     version's remaining steps would leave the node where it is.
// The case's bin is read only at internal nodes (leaves and padding rows
// have attr = -1).  An attribute of -1 at an internal node reads column 0,
// as descend_once does; one at or above A reads as unknown, as the JAX
// package's descend_once does (its out-of-range gather fills a negative
// value).  Child ids must lie below M.
//
// Table layout: (T, M, 8) int32, one 32-byte row per node: attr, split_bin,
// child0, nchild, heavy, class and two pad columns, read as two int4 loads.
//
// Bound on the H100: device-memory bytes.  The function reads each case's
// (A,) bins, the table rows its walks visit once and writes (T, N) int32
// classes; a few integer operations a level.  What holds it far above that
// bound is the walk itself: a level is a row load that depends on the last
// one.  The trees of a 10M-case forest are deep (SyD10M9A: 45 levels, 15.8
// steps a walk on average, about a third of the steps below row 256 and
// two thirds below row 8,192): below the top levels the lanes of a warp
// share fewer and fewer rows, each read from L1 or L2.
//
// Design (the plan, a pure function of the shapes, is
// autotune.plan_infer_blocks):
//   * a (case blocks, trees) grid, case blocks fastest, 64-bit offsets:
//     the blocks in flight walk one tree at a time, so that tree's table
//     (8.4 MB at M = 2^18) stays in L2 and its upper rows in each SM's L1,
//     which the kernel leaves whole (no shared memory);
//   * the lanes of a warp walk neighbouring cases of one tree in lockstep:
//     they read the top levels' rows together (one broadcast load), their
//     bins from a few lines, and write their classes in one store;
//   * the block: 1,024 cases where the grid still fills the card (the
//     "wide" plan; at N = 10M faster than the 256 of the earlier design,
//     see PERF.md), else the largest block that puts the walks on at least
//     one block an SM (the "spread" plan; a serving batch is
//     latency-bound);
//   * the grid's y extent stops at 65,535 trees (where the earlier design,
//     one tree a grid row, refused a larger forest) and its blocks walk the
//     trees beyond it in turn, 65,535 apart: no limit on T;
//   * node rows through the read-only path (__ldg); the second int4 (heavy,
//     class) only when a value is unknown and once at the leaf.
// Measured (repro_torch.profile_infer --against the earlier design's
// checkout, one NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6):
// T = 16, N = 10M 9.88-9.90 ms against 13.02-13.03 ms for the earlier
// design, bound 0.33 ms; the serving batch N = 1,024 0.015 ms, as the
// earlier design: the deepest walk's 45 dependent levels set it.
// Tried on the H100 and slower in every configuration (PERF.md, section 6):
// reading a tile's cases once for a group of trees (the SM's L1 then holds
// every tree of the group), staging each tree's top rows in shared memory
// (its carve-out shrinks L1, and the top rows are already broadcast L1
// hits), and keeping several walks in flight a thread, with or without
// refilling finished lanes (lanes at different depths lose the shared top
// rows and spread their bins over more lines).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(1024)
forest_predict_kernel(const int4* __restrict__ tab,
                      const int32_t* __restrict__ x,
                      const uint8_t* __restrict__ is_cont,
                      int32_t* __restrict__ out, int64_t n, int n_attrs,
                      int64_t n_trees, int m, int max_depth) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* xi = x + i * n_attrs;
  for (int64_t t = blockIdx.y; t < n_trees; t += gridDim.y) {
    const int4* rows = tab + t * m * 2;
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
      } else if (__ldg(is_cont + a)) {
        child = b <= lo.y ? 0 : 1;
      } else {
        child = b;
      }
      const int top = nchild - 1;
      child = child < 0 ? 0 : (child > top ? top : child);
      node = lo.z + child;
    }
    out[t * n + i] = __ldg(rows + 2 * node + 1).y;   // class
  }
}

extern "C" int forest_predict_launch(const void* tab, const void* x,
                                     const void* is_cont, void* out,
                                     long long n, int n_attrs,
                                     long long n_trees, int m, int max_depth,
                                     int threads, int tree_blocks,
                                     void* stream) {
  // the grid's y extent is the plan's: trees beyond it are walked by the
  // same blocks in turn
  const long long case_blocks = (n + threads - 1) / threads;
  if (case_blocks < 1 || case_blocks > 0x7fffffffLL || tree_blocks < 1 ||
      tree_blocks > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)case_blocks, (unsigned)tree_blocks);
  forest_predict_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int4*)tab, (const int32_t*)x, (const uint8_t*)is_cont,
      (int32_t*)out, (int64_t)n, n_attrs, (int64_t)n_trees, m, max_depth);
  return (int)cudaGetLastError();
}

extern "C" const char* forest_predict_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
