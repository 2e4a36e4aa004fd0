// splitPost of the frontier engine in two kernels: the superstep's node
// results and children (split_post_nodes_kernel, one block a slot), then
// every case routed to its child (split_post_route_kernel, one pass over
// the cases).
//
// Replaces no TPU kernel: the JAX package's splitPost is jnp under its
// jitted superstep (src/repro/core/frontier.py, split_post), which XLA
// fuses.  In the port it was about 150 torch launches a superstep and a
// blocking copy (a status written from a host scalar), so the host's
// dispatch set the pace of a deep build.  Its specification is the plain
// torch body of repro_torch.core.frontier.split_post, which the CPU and
// impl="torch" builds run.
//
// What bounds it on the H100: the node kernel is latency (K blocks, each a
// few hundred loads of its slot's histogram row from L2); the routing
// kernel is device-memory bytes: it reads every case's slot (4N bytes) and,
// for a case of a node split this superstep, one bin of its row (a 32-byte
// sector) and writes its node; writing the next frontier, it also reads
// the node of a case waiting outside the frontier and writes a slot that
// changes and a next live case's index in the list (4 bytes each).  The
// torch version moved ~2.5 GB a superstep at full width in int64
// temporaries.
//
// Node kernel (grid K, 256 threads; block r takes slot r):
//   * every block scans the K slots' child counts itself (nch: 2 for a
//     continuous best attribute, its bin count for a discrete one, 0 for a
//     slot that does not split), so it knows its slot's first child id
//     (n_nodes + the exclusive prefix) and whether the superstep overflows
//     the capacity (then every slot becomes a leaf) without a second pass;
//   * block 0 also reduces the superstep's statistics and writes them, with
//     the new overflow, lo and n_nodes, into stats (10 words), and zeroes
//     the two case counts the routing kernel adds to (active, next live);
//   * block r writes its node's row (ids[r]; an invalid slot's id is the
//     dump row M), and for a split node its children: the class
//     frequencies (continuous: the best attribute's bins up to and above
//     its split bin; discrete: its first nch bins), the unknown-valued
//     cases added to the heaviest child (first maximum, as torch.argmax),
//     each child's class (first maximum; the parent's class when empty),
//     depth, OPEN status and active attributes (a discrete split attribute
//     retired);
//   * route[r] = {attribute (-1: the node did not split), split bin, first
//     child, 2 * heaviest child + continuous} for the routing kernel.
// Routing kernel (grid-stride over N, 256 threads): a case of slot s >= 0
// counts as active (one atomic a block); if its node split, it reads its
// bin of the split attribute and moves to its child (the heaviest for an
// unknown value, b <= split bin -> 0 else 1 for a continuous attribute, b
// for a discrete one).  case_node is updated in place; without the next
// frontier a case of slot < 0 reads nothing but its slot.
//
// The next frontier (a state whose open nodes are the id range
// [lo, n_nodes), core/frontier.py OpenRange).  splitPre takes the K lowest
// open ids and the node kernel numbers the children from n_nodes up, so
// the open nodes stay one range drained from the front: the node kernel
// writes lo' = lo + (valid slots) beside n_nodes'.  The routing kernel
// then writes the next superstep's splitPre:
//   * in the same pass over the cases, each case's next slot in place:
//     its node - lo' when that lies in [lo', lo' + n_open'), n_open' =
//     min(K, n_nodes' - lo'), else -1, or -2 (SLOT_CLOSED) once its node
//     is a leaf.  A case of slot -1 (an open node outside the frontier)
//     reads its node word; a case of slot -2 reads its slot word alone;
//   * from its first K threads the K-wide planes: ids (lo' + j, the dump
//     row M past n_open'), valid, ids_safe, total_w (the node's class
//     frequencies summed in class order), depth_k and pre_leaf (pure,
//     below 2 min_objs, or at max_depth), as the plain split_pre computes
//     them from the node rows the node kernel has written;
//   * into a list (int32 (N,)), the next superstep's live cases: each
//     case whose next slot is >= 0 appends its index, and the count goes to
//     the stats word n_live beside lo' and n_nodes', which the host reads
//     with them at the loop's test.  The histogram of the next superstep
//     reads its cases through the list, so nothing gathers the live rows
//     and nothing waits for a count in splitAtt.  Each warp keeps its
//     listed cases in shared memory, in case order, over LIST_PASSES passes
//     of the block; then the block takes its place in the list with one
//     atomic on n_live and copies them out.  So a launch makes about
//     N / (256 LIST_PASSES) atomics on that one word, and the blocks'
//     stretches of the list lie in no fixed order (the histogram's sums do
//     not depend on it, csrc/histogram.cu).
//
// Exactness: the children's frequencies and weights are sums of the
// histogram's cells; with integral weights below 2^24 they are exact in
// any order, so the result equals the plain version bit for bit (the plain
// version's cumsum on the card adds in an order of its own too).  The cost
// model's test is float32 in the plain version's order (-fmad=false).
//
// Out-of-contract values (a best attribute outside [0, A), a slot at or
// above K) split nothing rather than read out of bounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define THREADS 256
#define WARPS (THREADS / 32)
#define ROUTE_BLOCKS_MAX 2048
// passes of the routing kernel's block between two copies of its listed
// cases from shared memory into the list (8 KB of shared memory a block)
#define LIST_PASSES 8

#define STATUS_OPEN 1
#define STATUS_INTERNAL 2
#define STATUS_LEAF 3
// a weighted count below this is an empty partition (entropy.EPS_W)
#define EPS_W 1e-7f
// the slot of a case whose node is a leaf (the next frontier only)
#define SLOT_CLOSED -2

// stats words (kernels/split_post.py STATS, then lo, n_nodes and the next
// superstep's live cases)
#define ST_PROCESSED 0
#define ST_ACTIVE 1
#define ST_INTERNAL 2
#define ST_CHILDREN 3
#define ST_MAX_R 4
#define ST_NAP 5
#define ST_OVERFLOW 6
#define ST_LO 7
#define ST_N_NODES 8
#define ST_LIVE 9

// cost models (core/cost_models.py COST_MODELS)
#define MODEL_ALPHA 0
#define MODEL_NLOGN 1
#define MODEL_NSQ 2

struct NodeArgs {
  // splitPre's (K,) planes
  const int64_t* ids;
  const uint8_t* valid;
  const int64_t* ids_safe;
  const float* total_w;
  const int32_t* depth_k;
  const uint8_t* pre_leaf;
  // splitAtt's: hist (K, A, B, C) with contiguous (B, C) rows, unknown
  // (K, A, C) with contiguous C, the rest contiguous
  const float* hist;
  int64_t hist_s0, hist_s1;
  const float* unknown;
  int64_t unk_s0, unk_s1;
  const int32_t* split_bin;  // (K, A)
  const uint8_t* active_k;   // (K, A): the cost model's attribute count
  const int32_t* best_attr;  // (K,)
  const uint8_t* has_split;  // (K,)
  const uint8_t* attr_is_cont;
  const int32_t* n_bins;
  // the node arrays, M + 1 rows (row M: the dump row)
  int32_t* node_attr;
  int32_t* node_split_bin;
  int32_t* node_child0;
  int32_t* node_nchild;
  int32_t* node_class;
  float* node_freq;          // (M + 1, C)
  int32_t* node_depth;
  int32_t* status;
  uint8_t* active;           // (M + 1, A)
  const int32_t* n_nodes;    // 0-d
  const uint8_t* overflow;   // 0-d
  const int32_t* lo;         // 0-d, the open range's first id; null: 0
  int4* route;               // (K,)
  int32_t* stats;            // 10 words
  int k, a, b, c, m;
  int cost_model;
  float n_total, alpha;
};

struct Slot {
  int attr;
  bool is_cont;
  int nch_attr;   // children a split on attr would make
  bool internal;  // splits, before the capacity test
};

__device__ __forceinline__ Slot slot_at(const NodeArgs& p, int s) {
  Slot t;
  t.attr = p.best_attr[s];
  const bool ok = (unsigned)t.attr < (unsigned)p.a;
  t.is_cont = ok && p.attr_is_cont[t.attr];
  t.nch_attr = t.is_cont ? 2 : (ok ? p.n_bins[t.attr] : 0);
  t.internal = ok && p.valid[s] && !p.pre_leaf[s] && p.has_split[s];
  return t;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_sumf(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The block's sum of v; every thread gets it.  buf: WARPS ints.
__device__ int block_sum(int v, int* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < WARPS; ++w) s += buf[w];
  return s;
}

// The cost model's test of a node of weight r and c active attributes, as
// cost_models.build_att_test in float32: alpha < r, |T| < c r log2 r,
// |T| < c r^2.
__device__ __forceinline__ bool nap_test(const NodeArgs& p, float r,
                                         float c) {
  if (p.cost_model == MODEL_ALPHA) return r > p.alpha;
  const float cr = c * r;
  if (p.cost_model == MODEL_NLOGN)
    return cr * log2f(fmaxf(r, 2.0f)) > p.n_total;
  return cr * r > p.n_total;
}

__global__ void __launch_bounds__(THREADS)
split_post_nodes_kernel(const NodeArgs p) {
  extern __shared__ float s_cls[];  // left, right, unknown: 3 x C
  __shared__ int s_warp[WARPS];
  __shared__ int s_excl;
  __shared__ float s_best_v[WARPS];
  __shared__ int s_best_j[WARPS];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool stats_block = r == 0;

  // ---- the K slots' child counts: this slot's exclusive prefix, the total
  int carry = 0;
  int n_valid = 0, n_split = 0, n_nap = 0;
  float max_r = -INFINITY;
  for (int base = 0; base < p.k; base += THREADS) {
    const int s = base + tid;
    int nch = 0;
    if (s < p.k) {
      const Slot t = slot_at(p, s);
      nch = t.internal ? t.nch_attr : 0;
      if (stats_block) {
        const bool v = p.valid[s];
        const float tw = p.total_w[s];
        n_valid += v;
        n_split += t.internal;
        max_r = fmaxf(max_r, v ? tw : 0.0f);
        if (v) {
          int act = 0;
          for (int j = 0; j < p.a; ++j) act += p.active_k[(int64_t)s * p.a + j];
          n_nap += nap_test(p, tw, (float)act);
        }
      }
    }
    int incl = nch;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, chunk = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int x = s_warp[w];
      if (w < warp) before += x;
      chunk += x;
    }
    if (s == r) s_excl = carry + before + incl - nch;
    carry += chunk;
    __syncthreads();                           // before s_warp is rewritten
  }
  const int total = carry;
  const int n0 = *p.n_nodes;
  const bool over = (int64_t)n0 + total > (int64_t)p.m;

  if (stats_block) {
    n_valid = block_sum(n_valid, s_warp);
    n_split = block_sum(n_split, s_warp);
    n_nap = block_sum(n_nap, s_warp);
    float mx = max_r;
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    if (lane == 0) s_best_v[warp] = mx;
    __syncthreads();
    if (tid == 0) {
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_best_v[w]);
      const int children = over ? 0 : total;
      p.stats[ST_PROCESSED] = n_valid;
      p.stats[ST_ACTIVE] = 0;                  // the routing kernel adds
      p.stats[ST_INTERNAL] = over ? 0 : n_split;
      p.stats[ST_CHILDREN] = children;
      p.stats[ST_MAX_R] = __float_as_int(mx);
      p.stats[ST_NAP] = n_nap;
      p.stats[ST_OVERFLOW] = (*p.overflow || over) ? 1 : 0;
      p.stats[ST_LO] = (p.lo ? *p.lo : 0) + n_valid;
      p.stats[ST_N_NODES] = n0 + children;
      p.stats[ST_LIVE] = 0;                    // the routing kernel adds
    }
    __syncthreads();                           // s_best_v is reused below
  }

  // ---- this slot's node
  const Slot t = slot_at(p, r);
  const bool internal = t.internal && !over;
  const int nch = internal ? t.nch_attr : 0;
  const int child0 = n0 + (over ? 0 : s_excl);
  const int sb = (unsigned)t.attr < (unsigned)p.a
                     ? p.split_bin[(int64_t)r * p.a + t.attr] : -1;
  if (tid == 0) {
    const int64_t id = p.ids[r];
    if (id >= 0 && id <= p.m) {
      p.node_attr[id] = internal ? t.attr : -1;
      p.node_split_bin[id] = internal && t.is_cont ? sb : -1;
      p.node_child0[id] = internal ? child0 : 0;
      p.node_nchild[id] = nch;
      p.status[id] = internal ? STATUS_INTERNAL : STATUS_LEAF;
    }
  }
  if (!internal) {
    if (tid == 0) p.route[r] = make_int4(-1, sb, child0, 0);
    return;
  }

  // ---- the children's class frequencies
  const int c_dim = p.c, b_dim = p.b;
  float* s_left = s_cls;
  float* s_right = s_cls + c_dim;
  float* s_unk = s_cls + 2 * c_dim;
  const float* hb = p.hist + (int64_t)r * p.hist_s0 + (int64_t)t.attr * p.hist_s1;
  const float* ub = p.unknown + (int64_t)r * p.unk_s0 + (int64_t)t.attr * p.unk_s1;
  for (int c = tid; c < c_dim; c += THREADS) s_unk[c] = ub[c];
  if (t.is_cont) {
    // left: the bins up to the split bin; right: the known rest
    const int upto = sb < 0 ? 0 : sb;
    for (int c = warp; c < c_dim; c += WARPS) {
      float all = 0.0f, left = 0.0f;
      for (int b = lane; b < b_dim; b += 32) {
        const float v = hb[(int64_t)b * c_dim + c];
        all += v;
        if (b <= upto) left += v;
      }
      all = warp_sumf(all);
      left = warp_sumf(left);
      if (lane == 0) {
        s_left[c] = left;
        s_right[c] = all - left;
      }
    }
  }
  __syncthreads();

  // ---- the heaviest child (first maximum of the children's weights)
  float best_v = -INFINITY;
  int best_j = 0;
  const int n_cand = t.nch_attr > 1 ? t.nch_attr : 1;
  for (int j = tid; j < n_cand; j += THREADS) {
    float wj = 0.0f;
    if (t.is_cont) {
      const float* f = j == 0 ? s_left : s_right;
      for (int c = 0; c < c_dim; ++c) wj += f[c];
    } else if (j < t.nch_attr && j < b_dim) {
      for (int c = 0; c < c_dim; ++c) wj += hb[(int64_t)j * c_dim + c];
    }
    if (wj > best_v) {
      best_v = wj;
      best_j = j;
    }
  }
  for (int o = 16; o; o >>= 1) {
    const float v = __shfl_xor_sync(FULL, best_v, o);
    const int j = __shfl_xor_sync(FULL, best_j, o);
    if (v > best_v || (v == best_v && j < best_j)) {
      best_v = v;
      best_j = j;
    }
  }
  if (lane == 0) {
    s_best_v[warp] = best_v;
    s_best_j[warp] = best_j;
  }
  __syncthreads();
  int heaviest = s_best_j[0];
  float heavy_v = s_best_v[0];
  for (int w = 1; w < WARPS; ++w) {
    if (s_best_v[w] > heavy_v ||
        (s_best_v[w] == heavy_v && s_best_j[w] < heaviest)) {
      heavy_v = s_best_v[w];
      heaviest = s_best_j[w];
    }
  }

  // ---- the children: frequencies, class, depth, status
  const int parent_class = p.node_class[p.ids_safe[r]];
  const int depth = p.depth_k[r] + 1;
  for (int j = tid; j < nch; j += THREADS) {
    const int64_t cid = (int64_t)child0 + j;
    float* freq = p.node_freq + cid * c_dim;
    float cw = 0.0f, top = -INFINITY;
    int cls = 0;
    for (int c = 0; c < c_dim; ++c) {
      float f;
      if (t.is_cont)
        f = j == 0 ? s_left[c] : s_right[c];
      else
        f = j < b_dim ? hb[(int64_t)j * c_dim + c] : 0.0f;
      f = f + (j == heaviest ? s_unk[c] : 0.0f);
      freq[c] = f;
      cw += f;
      if (f > top) {
        top = f;
        cls = c;
      }
    }
    p.node_class[cid] = cw > EPS_W ? cls : parent_class;
    p.node_depth[cid] = depth;
    p.status[cid] = STATUS_OPEN;
  }
  // the parent's active attributes (its row, below n_nodes: no child's),
  // less a discrete split attribute
  const int64_t cells = (int64_t)nch * p.a;
  const uint8_t* act = p.active + p.ids_safe[r] * p.a;
  for (int64_t i = tid; i < cells; i += THREADS) {
    const int j = (int)(i / p.a), a = (int)(i - (int64_t)j * p.a);
    p.active[((int64_t)child0 + j) * p.a + a] =
        act[a] && (t.is_cont || a != t.attr);
  }
  if (tid == 0)
    p.route[r] = make_int4(t.attr, sb, child0, 2 * heaviest + t.is_cont);
}

// The next frontier's K-wide planes and the node rows they read: a
// routing launch without them (ids null) writes no next frontier.
struct NextArgs {
  int64_t* ids;
  uint8_t* valid;
  int64_t* ids_safe;
  float* total_w;
  int32_t* depth_k;
  uint8_t* pre_leaf;
  const float* node_freq;    // (M + 1, C)
  const int32_t* node_depth;
  int c, m;
  float min_w;               // 2 min_objs
  int max_depth;
};

// Slot j of the next frontier [lo, lo + n_open): split_pre's stop tests.
__device__ __forceinline__ void next_slot(const NextArgs& q, int j, int lo,
                                          int n_open) {
  const bool v = j < n_open;
  const int64_t id = v ? (int64_t)lo + j : q.m;
  const int64_t safe = id < q.m ? id : q.m - 1;
  float tw = 0.0f;
  int nonzero = 0;
  if (v) {
    const float* f = q.node_freq + safe * q.c;
    for (int c = 0; c < q.c; ++c) {
      tw += f[c];
      nonzero += f[c] > EPS_W;
    }
  }
  const int depth = q.node_depth[safe];
  q.ids[j] = id;
  q.valid[j] = v;
  q.ids_safe[j] = safe;
  q.total_w[j] = tw;
  q.depth_k[j] = depth;
  q.pre_leaf[j] = nonzero <= 1 || tw < q.min_w || depth >= q.max_depth;
}

// Route case i (i < n); returns its slot after this kernel: with the next
// frontier (ahead) its next slot, else its slot as it was.  live counts
// the cases of slot >= 0.
__device__ __forceinline__ int route_case(
    int64_t i, int32_t* slot, const int32_t* __restrict__ x,
    const int4* __restrict__ route, int32_t* __restrict__ case_node,
    int n_attrs, int k, bool ahead, int lo, int n_open, int& live) {
  const int s = slot[i];
  int node;
  if (s < 0) {
    if (!ahead || s == SLOT_CLOSED) return s;
    node = case_node[i];                       // open, outside the frontier
  } else {
    ++live;
    if (s >= k) return s;
    const int4 e = __ldg(route + s);
    if (e.x < 0) {                             // the node did not split
      if (!ahead) return s;
      slot[i] = SLOT_CLOSED;
      return SLOT_CLOSED;
    }
    const int b = __ldg(x + i * n_attrs + e.x);
    const int j = b < 0 ? (e.w >> 1) : ((e.w & 1) ? (b <= e.y ? 0 : 1) : b);
    node = e.z + j;
    case_node[i] = node;
  }
  if (!ahead) return s;
  const unsigned d = (unsigned)(node - lo);
  const int next = d < (unsigned)n_open ? (int)d : -1;
  if (next != s) slot[i] = next;
  return next;
}

__global__ void __launch_bounds__(THREADS)
split_post_route_kernel(int32_t* slot, const int32_t* __restrict__ x,
                        const int4* __restrict__ route,
                        int32_t* __restrict__ case_node, int32_t* stats,
                        int32_t* __restrict__ list, int64_t n, int n_attrs,
                        int k, const NextArgs q) {
  __shared__ int s_warp[WARPS];
  // each warp's listed cases since the block's last copy into the list,
  // then the warps' offsets in the block's stretch and the stretch's start
  __shared__ int s_list[THREADS * LIST_PASSES];
  __shared__ int s_off[WARPS + 1];
  const bool ahead = q.ids != nullptr;       // and so the list
  const int lo = ahead ? stats[ST_LO] : 0;
  const int n_open = ahead ? min(k, stats[ST_N_NODES] - lo) : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  if (ahead)
    for (int64_t j = first; j < k; j += stride) next_slot(q, (int)j, lo, n_open);
  int live = 0;
  int* held = s_list + warp * 32 * LIST_PASSES;
  int n_held = 0;                              // the same in every lane
  // the block's passes run together (the list's copies are block-wide)
  for (int64_t i = first, pass = 0; i - threadIdx.x < n;
       i += stride, ++pass) {
    const int after =
        i < n ? route_case(i, slot, x, route, case_node, n_attrs, k, ahead,
                           lo, n_open, live)
              : -1;
    if (!ahead) continue;
    const bool keep = after >= 0;
    const unsigned m = __ballot_sync(FULL, keep);
    if (keep) held[n_held + __popc(m & ((1u << lane) - 1u))] = (int)i;
    n_held += __popc(m);
    if (pass % LIST_PASSES != LIST_PASSES - 1 &&
        i - threadIdx.x + stride < n)
      continue;
    // the block's stretch of the list: one atomic, then each warp's cases
    if (lane == 0) s_off[warp] = n_held;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int w = 0; w < WARPS; ++w) {
        const int c = s_off[w];
        s_off[w] = total;
        total += c;
      }
      s_off[WARPS] = total ? atomicAdd(stats + ST_LIVE, total) : 0;
    }
    __syncthreads();
    int32_t* dst = list + s_off[WARPS] + s_off[warp];
    for (int j = lane; j < n_held; j += 32) dst[j] = held[j];
    n_held = 0;
    __syncwarp();                              // before held is rewritten
  }
  live = block_sum(live, s_warp);
  if (threadIdx.x == 0 && live) atomicAdd(stats + ST_ACTIVE, live);
}

extern "C" int split_post_nodes_launch(
    const void* ids, const void* valid, const void* ids_safe,
    const void* total_w, const void* depth_k, const void* pre_leaf,
    const void* hist, long long hist_s0, long long hist_s1,
    const void* unknown, long long unk_s0, long long unk_s1,
    const void* split_bin, const void* active_k, const void* best_attr,
    const void* has_split, const void* attr_is_cont, const void* n_bins,
    void* node_attr, void* node_split_bin, void* node_child0,
    void* node_nchild, void* node_class, void* node_freq, void* node_depth,
    void* status, void* active, const void* n_nodes, const void* overflow,
    const void* lo, void* route, void* stats, int k, int a, int b, int c,
    int m, int cost_model, float n_total, float alpha, void* stream) {
  if (k < 1 || a < 1 || b < 1 || c < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  NodeArgs p;
  p.ids = (const int64_t*)ids;
  p.valid = (const uint8_t*)valid;
  p.ids_safe = (const int64_t*)ids_safe;
  p.total_w = (const float*)total_w;
  p.depth_k = (const int32_t*)depth_k;
  p.pre_leaf = (const uint8_t*)pre_leaf;
  p.hist = (const float*)hist;
  p.hist_s0 = hist_s0;
  p.hist_s1 = hist_s1;
  p.unknown = (const float*)unknown;
  p.unk_s0 = unk_s0;
  p.unk_s1 = unk_s1;
  p.split_bin = (const int32_t*)split_bin;
  p.active_k = (const uint8_t*)active_k;
  p.best_attr = (const int32_t*)best_attr;
  p.has_split = (const uint8_t*)has_split;
  p.attr_is_cont = (const uint8_t*)attr_is_cont;
  p.n_bins = (const int32_t*)n_bins;
  p.node_attr = (int32_t*)node_attr;
  p.node_split_bin = (int32_t*)node_split_bin;
  p.node_child0 = (int32_t*)node_child0;
  p.node_nchild = (int32_t*)node_nchild;
  p.node_class = (int32_t*)node_class;
  p.node_freq = (float*)node_freq;
  p.node_depth = (int32_t*)node_depth;
  p.status = (int32_t*)status;
  p.active = (uint8_t*)active;
  p.n_nodes = (const int32_t*)n_nodes;
  p.overflow = (const uint8_t*)overflow;
  p.lo = (const int32_t*)lo;
  p.route = (int4*)route;
  p.stats = (int32_t*)stats;
  p.k = k;
  p.a = a;
  p.b = b;
  p.c = c;
  p.m = m;
  p.cost_model = cost_model;
  p.n_total = n_total;
  p.alpha = alpha;
  const size_t smem = 3 * (size_t)c * sizeof(float);
  split_post_nodes_kernel<<<k, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int split_post_route_launch(
    void* slot, const void* x, const void* route, void* case_node,
    void* stats, void* list, long long n, int a, int k, void* ids,
    void* valid,
    void* ids_safe, void* total_w, void* depth_k, void* pre_leaf,
    const void* node_freq, const void* node_depth, int c, int m,
    float min_w, int max_depth, void* stream) {
  if (ids && (c < 1 || m < 1 || !list)) return (int)cudaErrorInvalidValue;
  NextArgs q;
  q.ids = (int64_t*)ids;
  q.valid = (uint8_t*)valid;
  q.ids_safe = (int64_t*)ids_safe;
  q.total_w = (float*)total_w;
  q.depth_k = (int32_t*)depth_k;
  q.pre_leaf = (uint8_t*)pre_leaf;
  q.node_freq = (const float*)node_freq;
  q.node_depth = (const int32_t*)node_depth;
  q.c = c;
  q.m = m;
  q.min_w = min_w;
  q.max_depth = max_depth;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > ROUTE_BLOCKS_MAX) blocks = ROUTE_BLOCKS_MAX;
  if (blocks < 1) blocks = 1;
  split_post_route_kernel<<<(unsigned)blocks, THREADS, 0,
                            (cudaStream_t)stream>>>(
      (int32_t*)slot, (const int32_t*)x, (const int4*)route,
      (int32_t*)case_node, (int32_t*)stats, (int32_t*)list, (int64_t)n, a, k,
      q);
  return (int)cudaGetLastError();
}

extern "C" const char* split_post_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
