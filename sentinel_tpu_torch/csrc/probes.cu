// Measurement-probe kernels for Hopper (sm_90a): a copy, an atomics-based
// count histogram, and the valued histograms in thread-block clusters.
//
// They replace the Pallas probe kernels the JAX package kept under
// benchmarks/ to measure its launch floor and its scatter floor:
//   probe_copy        <- benchmarks/probe_pallas_floor.py copy_call,
//                        benchmarks/probe_pallas_floor2.py copy_call
//   probe_hist_count  <- benchmarks/probe_pallas_floor.py sc_call, sc_call2
//   probe_hist_planes <- benchmarks/pallas_histogram.py pallas_histogram,
//                        benchmarks/probe_pallas_floor.py sc5_call
//   probe_hist_stat5  <- benchmarks/probe_fused_hist.py make_fused(TB).run,
//                        benchmarks/probe_fused_hist2.py make(TB, n_lo, mode).run
// The Python wrappers, the plain PyTorch versions and the planning of the
// cluster launches live in sentinel_tpu_torch/probes/kernels.py; this file
// has a plain C interface and is loaded with ctypes.
//
// What bounds them: bytes.  probe_copy reads and writes 4 B an item.  The
// histograms read 4 B an id plus 4 B a value plane an item and write the
// whole padded output once; at the stat-landing shape (393,216 items into
// 16,640 rows, 5 planes) that is 8.2 MB, 2.4 us at 3.35 TB/s, against
// 2 M adds.  The TPU kernels built one-hot factors and contracted them on
// the matrix unit because the TPU has no fast random scatter, and kept the
// whole output resident in VMEM across a sequential grid, written once;
// their tile sizes (TB, n_tile, chunk), the one-hot width n_lo, the grid
// step count and its "parallel" flag are that tiling.  n_lo survives only
// as the padded output shape [n_hi, n_lo], in which row k lies at flat cell
// k; the grid step count becomes the number of blocks of probe_copy.
//
// probe_copy moves 16 bytes an access, as torch.add does: a thread takes
// COPY_ITEMS = 8 items a grid-stride step, two uint4 loads in flight
// before its two stores, the warp's accesses side by side.  With few
// blocks (the P3 series' 1 and 4) a step's loads in flight set the time:
// on an H100, 4 items a thread were slower than the 4-byte kernel there,
// 8 faster at every grid; 16 were slower at 512 blocks.  A scalar head
// brings y to a 16-byte boundary and a scalar tail takes the last n % 4
// items; where x is not aligned as y is (x[1:] into a fresh y), x is read
// by 4-byte loads and y still written 16 bytes at a time.  `blocks` is the
// grid (a grid-stride over exactly that many blocks), 0 as many as one
// step of every thread covers.
//
// probe_hist_count, probe_hist_planes and probe_hist_stat5 are one
// template, the Hopper counterpart of the TPU kernels' resident output: ONE
// launch a call, no memset, no global atomic.  (probe_hist_count's first
// version was a memset, then one float atomicAdd an id into L2: two
// launches a call.)  The output's rows are cut into slices, one a
// thread-block cluster; every block of the cluster keeps its own copy of
// the slice (all P planes) in shared memory.  The blocks of a cluster share
// the item range (interleaved chunks of items_per_block ids, 16-byte id
// loads, HIST_UNROLL of them a thread in flight; each cluster starts at
// another place in the ids so the clusters do not read the same L2 lines
// at once).  A warp queues the items whose id lies in its cluster's slice
// (ballot) and then adds them one a lane: the item's values (one 16-byte
// load a row where P % 4 == 0, or cnts[3] + rt with the byte split done
// here) go into the block's own copy by shared-memory atomics.  After
// cluster.sync() each block sums its rows of the cluster's copies, read
// from distributed shared memory 16 bytes at a time, and writes them once
// with 16-byte stores, the padding rows [n, n_hi * n_lo) included, so what
// out held before the call does not matter.  The host plans the launch
// (kernels.py hist_plan): as many clusters as the card runs at once, more
// when the table does not fit their shared memory.  The count is the
// template specialised (CountValues): no value loads, no queue, no float
// copy — a warp's ids that fall in the slice add 1 to their int32 cell at
// once, and the row is written as the float of the cluster's int sum, exact
// below 2^24 — so a block's copy takes 4 bytes a cell.
//
// What was hard (measured on an H100, PERF.md): a float atomicAdd into
// shared memory compiles to a compare-and-swap loop (ATOMS.CAST.SPIN), and
// into another block's shared memory was slower still; so a cell is an
// int32 that takes integer values below 2^24 by native ATOMS.ADD, beside a
// float32 that takes any other value (the row written is int + float).  A
// thread that met a matching id took its gather inside a divergent branch,
// one lane at a time; the warp queue makes the gathers of 32 items one
// round trip.  What bounds it now: every cluster reads all the ids (from L2
// after the first), and the queue, the gathers, the cluster barrier and the
// combine are round trips in a row.
//
// Exactness: the sums are of integer-valued data and stay below 2^24, so
// float32 addition is exact and independent of the order the atomics land
// in, and an int32 cell holds the same sum: every kernel equals its plain
// version bit for bit (outside that contract, an int cell's sum past 2^31
// wraps).  ids outside [0, n) drop.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define BLOCK 256

#define COPY_ITEMS 8
#define COPY_U (COPY_ITEMS / 4)  // uint4s a thread a step

// y + head is 16-byte aligned, x + head is when x_vec.  Items [0, head)
// and [head + 4 * groups, n) are scalar.
__global__ void __launch_bounds__(BLOCK) probe_copy_kernel(const unsigned int* __restrict__ x,
                                                           unsigned int* __restrict__ y, long long n,
                                                           int head, long long groups, int x_vec) {
  const long long tid = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long tail = head + 4 * groups;
  for (long long s = tid; s < head + (n - tail); s += (long long)gridDim.x * BLOCK) {
    const long long i = s < head ? s : tail + (s - head);
    y[i] = x[i] + 1u;  // wraps like int32 addition
  }
  const unsigned int* xs = x + head;
  const uint4* x4 = reinterpret_cast<const uint4*>(xs);
  uint4* y4 = reinterpret_cast<uint4*>(y + head);
  for (long long base = (long long)blockIdx.x * BLOCK * COPY_U; base < groups;
       base += (long long)gridDim.x * BLOCK * COPY_U) {
    uint4 q[COPY_U];
#pragma unroll
    for (int u = 0; u < COPY_U; ++u) {  // every load of the step first
      const long long g = base + u * BLOCK + threadIdx.x;
      if (g < groups)
        q[u] = x_vec ? x4[g] : make_uint4(xs[4 * g], xs[4 * g + 1], xs[4 * g + 2], xs[4 * g + 3]);
    }
#pragma unroll
    for (int u = 0; u < COPY_U; ++u) {
      const long long g = base + u * BLOCK + threadIdx.x;
      if (g < groups) y4[g] = make_uint4(q[u].x + 1u, q[u].y + 1u, q[u].z + 1u, q[u].w + 1u);
    }
  }
}

// -- the valued histograms: one cluster launch --------------------------------

#define HIST_UNROLL 4              // 16-byte id loads a thread has in flight
#define HIST_QUEUE 256             // a warp's queue of matched items (shared memory)
#define HIST_FLUSH 128             // a warp adds its queue once it holds this many
#define HIST_MAX_THREADS 1024
#define HIST_MAX_CLUSTER 16        // above 8 needs the non-portable attribute
#define HIST_MAX_SMEM 232192       // dynamic shared memory a block may take (227 KB less 256 B static)
#define HIST_EXACT_INT 16777216.0f // 2^24: integers below it add as int32

struct HistGeom {
  const int* ids;
  int N;                    // items
  int n;                    // ids in [0, n) add; the rest drop
  int P;                    // value planes
  float* out;
  long long rows;           // rows of out: n ([n, P]) or plane_stride (padded)
  long long plane_stride;   // 0: out is [n, P]; else out is [P, plane_stride]
  int cluster;              // blocks a cluster
  int rows_per_block;       // rows a block owns (a multiple of 4)
  int chunk_shift;          // log2 of the 4-id groups a block takes at a time
};

// Adds one item's values into the block's own copy of the cluster's slice.
// A cell is an int32 and a float32 (the float copy after the int copy).  A
// value that is an integer below 2^24 adds to the int cell by a native
// shared-memory integer atomic; any other value (a fraction, NaN, inf, a
// large magnitude) adds to the float cell by atomicAdd, which for shared
// memory is a compare-and-swap loop, and marks the block's float copy as
// used.  The row is written as int + float: for integer-valued sums below
// 2^24 that is the float32 sum in any order, bit for bit.
struct CellAdd {
  int* ints;      // the int cell of plane 0
  float* floats;  // the float cell of plane 0
  int step;       // plane p: + p * step cells
  int* floats_used;
  __device__ __forceinline__ void operator()(int p, float v) const {
    if (v == 0.0f) return;
    if (fabsf(v) < HIST_EXACT_INT && v == truncf(v)) {
      atomicAdd(ints + p * step, (int)v);
    } else {
      atomicAdd(floats + p * step, v);
      *floats_used = 1;
    }
  }
};

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

// values [N, P] row-major, float32 or int32 (an int32 value adds as the
// float32 it converts to, as in the plain version).
template <typename T>
struct PlaneValues {
  static constexpr bool kCount = false;
  const T* vals;
  int P;
  bool vec4;  // P % 4 == 0 and vals 16-byte aligned: a row in 16-byte loads
  __device__ __forceinline__ void add(int i, const CellAdd& add) const {
    const T* row = vals + (long long)i * P;
    for (int p = 0; p < P; p += 4) {
      float v0, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
      if (vec4) {
        const typename Vec4<T>::type q = __ldg(reinterpret_cast<const typename Vec4<T>::type*>(row + p));
        v0 = (float)q.x, v1 = (float)q.y, v2 = (float)q.z, v3 = (float)q.w;
      } else {
        v0 = (float)__ldg(row + p);
        if (p + 1 < P) v1 = (float)__ldg(row + p + 1);
        if (p + 2 < P) v2 = (float)__ldg(row + p + 2);
        if (p + 3 < P) v3 = (float)__ldg(row + p + 3);
      }
      add(p, v0);
      add(p + 1, v1);  // a plane past P carries 0 and adds nothing
      add(p + 2, v2);
      add(p + 3, v3);
    }
  }
};

// Five planes: cnts[:, 0..2], rt & 0xFF, (rt >> 8) & 0xFF.
struct Stat5Values {
  static constexpr bool kCount = false;
  const int* cnts;
  const int* rt;
  __device__ __forceinline__ void add(int i, const CellAdd& add) const {
    const int r = __ldg(rt + i);
    const int* c = cnts + 3LL * i;
    const int c0 = __ldg(c), c1 = __ldg(c + 1), c2 = __ldg(c + 2);
    add(0, (float)c0);
    add(1, (float)c1);
    add(2, (float)c2);
    add(3, (float)(r & 0xFF));
    add(4, (float)((r >> 8) & 0xFF));
  }
};

// One plane of counts: an item adds 1 to its id's int cell, and nothing
// is loaded beside the ids.
struct CountValues {
  static constexpr bool kCount = true;
  __device__ __forceinline__ void add(int, const CellAdd&) const {}
};

// The 4-id group gi of ids; ids past N read as -1 (they drop).
__device__ __forceinline__ int4 load_group(const int* __restrict__ ids, int gi, int N, bool vec) {
  const int i = 4 * gi;
  if (vec && i + 3 < N) return __ldg(reinterpret_cast<const int4*>(ids) + gi);
  int4 q;
  q.x = i < N ? __ldg(ids + i) : -1;
  q.y = i + 1 < N ? __ldg(ids + i + 1) : -1;
  q.z = i + 2 < N ? __ldg(ids + i + 2) : -1;
  q.w = i + 3 < N ? __ldg(ids + i + 3) : -1;
  return q;
}

// Writes the rows [r0, r0 + nr) this block owns: each cell is the sum over
// the cluster's C copies of its int cell, as float, plus the sum of its
// float cells over the copies that used theirs.  The copies are read from
// the blocks' shared memory (DSMEM) 16 bytes at a time, four copies' loads
// in flight together; every thread takes a 4-cell group of one plane's run
// (one run of nr * P cells for an [n, P] table).
__device__ __forceinline__ void hist_write(const cg::cluster_group& cluster, const HistGeom& g, int* ints,
                                           float* floats, unsigned float_ranks, int S, long long r0,
                                           int nr) {
  const bool rowmajor = g.plane_stride == 0;
  const int runs = rowmajor ? 1 : g.P;
  const int len = rowmajor ? nr * g.P : nr;   // cells a run
  const int quads = (len + 3) / 4;
  const int rank = (int)cluster.block_rank();
  for (int t = threadIdx.x; t < runs * quads; t += blockDim.x) {
    const int p = t / quads;
    const int c = 4 * (t - p * quads);
    const int src = rowmajor ? rank * g.rows_per_block * g.P + c : p * S + rank * g.rows_per_block + c;
    float* dst = rowmajor ? g.out + r0 * g.P + c : g.out + p * g.plane_stride + r0 + c;
    int4 a = make_int4(0, 0, 0, 0);
    for (int r = 0; r < g.cluster; r += 4) {
      int4 x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = r + k < g.cluster ? *reinterpret_cast<const int4*>(cluster.map_shared_rank(ints + src, r + k))
                                 : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) a.x += x[k].x, a.y += x[k].y, a.z += x[k].z, a.w += x[k].w;
    }
    float4 v = make_float4((float)a.x, (float)a.y, (float)a.z, (float)a.w);
    for (unsigned m = float_ranks; m; m &= m - 1) {
      const float4 y = *reinterpret_cast<const float4*>(cluster.map_shared_rank(floats + src, __ffs(m) - 1));
      v.x += y.x, v.y += y.y, v.z += y.z, v.w += y.w;
    }
    if (c + 4 <= len && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float w[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; k < 4 && c + k < len; ++k) dst[k] = w[k];
    }
  }
}

// Adds a warp's queue, one item a lane: the value loads of 32 items are in
// flight together rather than one divergent lane at a time.
template <class Values>
__device__ __forceinline__ void hist_flush(const Values& vals, int* ints, float* floats, int* floats_used,
                                           const int* q_item, const int* q_cell, int queued, int lane,
                                           int row_cells, int step) {
  __syncwarp();
  for (int q = lane; q < queued; q += 32) {
    const int cell = q_cell[q] * row_cells;
    vals.add(q_item[q], CellAdd{ints + cell, floats + cell, step, floats_used});
  }
  __syncwarp();
}

// Shared memory: the block's own copy of its cluster's slice (S =
// cluster * rows_per_block rows x P int cells, then as many float cells),
// then one queue a warp of (item, row in the slice) pairs.  A warp appends
// the items of its ids that fall in the cluster's slice (ballot) and adds
// its queue once it holds HIST_FLUSH; every add is to the block's own
// copy.  Then each block sums its rows of the C copies and writes them.
// The count (Values::kCount) keeps the int cells alone and adds each hit
// at once.
template <class Values>
__global__ void __launch_bounds__(HIST_MAX_THREADS, 1)
probe_hist_cluster_kernel(const HistGeom g, const Values vals) {
  constexpr bool kCount = Values::kCount;
  extern __shared__ int4 hist_smem[];
  __shared__ int floats_used;       // this block's float copy took a value
  __shared__ unsigned float_ranks;  // the cluster's blocks whose float copy did
  int* ints = reinterpret_cast<int*>(hist_smem);
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = g.cluster;
  const int rank = (int)cluster.block_rank();
  const int K = gridDim.x / C;
  const int cid = blockIdx.x / C;
  const int rpb = g.rows_per_block;
  const int S = C * rpb;        // rows of the cluster's slice
  const int ncell = S * g.P;    // a multiple of 4
  float* floats = reinterpret_cast<float*>(ints + ncell);  // none for the count
  const int lane = threadIdx.x & 31;
  int* q_item = ints + 2 * ncell + (threadIdx.x >> 5) * 2 * HIST_QUEUE;  // none for the count
  int* q_cell = q_item + HIST_QUEUE;
  const int groups = (g.N + 3) / 4;
  // cluster c starts c / K of the way into the ids, so the clusters do not
  // all read the same lines of L2 at once
  const int rot = (int)((long long)cid * groups / K);
  if (threadIdx.x == 0) {
    floats_used = 0;
    float_ranks = 0;
  }
  for (int c = threadIdx.x; c < (kCount ? ncell / 4 : ncell / 2); c += blockDim.x) {
    hist_smem[c] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  const int lo = cid * S;  // the cluster's first row
  const int span = min(S, g.n - lo);
  const bool rowmajor = g.plane_stride == 0;
  if (span > 0) {
    const int step = rowmajor ? 1 : S;  // plane p of a row: + p * step
    const int row_cells = rowmajor ? g.P : 1;
    const int shift = g.chunk_shift;
    const int chunk = 1 << shift;
    // this block's groups: chunk c of the cluster's items goes to block c % C
    const long long round = (long long)chunk * C;
    const long long rem = groups % round - (long long)rank * chunk;
    const int count = (int)(groups / round * chunk + (rem < 0 ? 0 : rem < chunk ? rem : chunk));
    const bool vec = (reinterpret_cast<uintptr_t>(g.ids) & 15) == 0;
    const unsigned below = (1u << lane) - 1u;
    int queued = 0;  // warp-uniform
    // the whole warp runs every pass (lanes past count load nothing)
    for (int jw = threadIdx.x - lane; jw < count; jw += HIST_UNROLL * blockDim.x) {
      int4 q[HIST_UNROLL];
      int gi[HIST_UNROLL];
#pragma unroll
      for (int u = 0; u < HIST_UNROLL; ++u) {
        const int j = jw + lane + u * blockDim.x;
        // unsigned: a lane past count may overflow here; it loads nothing
        unsigned h = ((((unsigned)j >> shift) * C + rank) << shift) + ((unsigned)j & (chunk - 1)) + rot;
        if (h >= (unsigned)groups) h -= groups;
        gi[u] = (int)h;
        q[u] = j < count ? load_group(g.ids, gi[u], g.N, vec) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < HIST_UNROLL; ++u) {
        const int k[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned d = (unsigned)k[e] - (unsigned)lo;
          const bool hit = d < (unsigned)span;  // else another cluster's row, or dropped
          if constexpr (kCount) {
            if (hit) atomicAdd(ints + d, 1);  // one plane: the row's cell
          } else {
            const unsigned m = __ballot_sync(0xffffffffu, hit);
            if (hit) {
              const int at = queued + __popc(m & below);
              q_item[at] = 4 * gi[u] + e;
              q_cell[at] = (int)d;
            }
            queued += __popc(m);
          }
        }
        if (!kCount && queued >= HIST_FLUSH) {  // < HIST_FLUSH + 128 <= HIST_QUEUE
          hist_flush(vals, ints, floats, &floats_used, q_item, q_cell, queued, lane, row_cells, step);
          queued = 0;
        }
      }
    }
    if (!kCount) hist_flush(vals, ints, floats, &floats_used, q_item, q_cell, queued, lane, row_cells, step);
  }
  cluster.sync();  // every block's copy is complete
  if (threadIdx.x < C && *cluster.map_shared_rank(&floats_used, threadIdx.x)) {
    atomicOr(&float_ranks, 1u << threadIdx.x);
  }
  __syncthreads();

  const long long r0 = (long long)lo + rank * rpb;  // the rows this block owns, written once
  if (r0 < g.rows) {
    hist_write(cluster, g, ints, floats, float_ranks, S, r0, (int)(g.rows - r0 < rpb ? g.rows - r0 : rpb));
  }
  cluster.sync();  // no block leaves while another still reads its copy
}

// Check the plan against the geometry; fill the rest of g.  Returns 0 or a
// CUDA error code.  counts: the count's layout (4-byte cells, no queue).
static int hist_geom(HistGeom& g, long long N, int n, int P, long long plane_stride,
                     int items_per_block, int cluster, int clusters, int rows_per_block,
                     int smem_bytes, int threads, bool counts = false) {
  if (N < 0 || n < 0 || P < 1 || items_per_block < 1 || plane_stride < 0 ||
      (plane_stride && plane_stride < n) || cluster < 1 || cluster > HIST_MAX_CLUSTER ||
      clusters < 1 || threads < 32 || threads > HIST_MAX_THREADS || threads % 32 ||
      rows_per_block < 4 || rows_per_block % 4 || smem_bytes > HIST_MAX_SMEM ||
      (long long)smem_bytes != (counts ? 4LL * cluster * rows_per_block * P
                                       : 8LL * cluster * rows_per_block * P + threads / 32 * 8 * HIST_QUEUE) ||
      N > 2147483647LL ||
      (long long)clusters * cluster > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  g.N = (int)N;
  g.n = n;
  g.P = P;
  g.plane_stride = plane_stride;
  g.rows = plane_stride ? plane_stride : n;
  // every row owned, and row indices (plus a cluster's span) in int
  if ((long long)clusters * cluster * rows_per_block < g.rows ||
      (long long)clusters * cluster * rows_per_block > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  g.cluster = cluster;
  g.rows_per_block = rows_per_block;
  int shift = 0;  // groups of 4 ids a chunk: items_per_block / 4 rounded up to a power of two
  while ((4LL << shift) < items_per_block) ++shift;
  g.chunk_shift = shift;
  return 0;
}

template <class Values>
static int hist_launch(const HistGeom& g, const Values& v, int clusters, int smem_bytes, int threads,
                       cudaStream_t s) {
  // sentinel_probe_hist_max_clusters has set the kernel's attributes (shared
  // memory past 48 KB, clusters past 8) on this device; a launch makes no
  // attribute call, so it can be captured into a CUDA graph
  void (*kern)(const HistGeom, const Values) = probe_hist_cluster_kernel<Values>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(clusters * g.cluster));
  cfg.blockDim = dim3((unsigned int)threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, g, v);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Each entry point returns the CUDA error code of its calls (0 = success).

// blocks <= 0: as many as one step of every thread covers.
extern "C" int sentinel_probe_copy(const void* x, void* y, long long n, int blocks, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uintptr_t xa = (uintptr_t)x, ya = (uintptr_t)y;
  if ((xa | ya) & 3) return (int)cudaErrorInvalidValue;
  long long head = (long long)(((16 - (ya & 15)) & 15) >> 2);
  if (head > n) head = n;
  const long long groups = (n - head) / 4;
  const int x_vec = ((xa + 4 * head) & 15) == 0;
  const long long per_block = (long long)BLOCK * COPY_U;
  long long g = blocks > 0 ? blocks : (groups + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 2147483647LL) return (int)cudaErrorInvalidValue;
  probe_copy_kernel<<<(unsigned int)g, BLOCK, 0, (cudaStream_t)stream>>>(
      (const unsigned int*)x, (unsigned int*)y, n, (int)head, groups, x_vec);
  return (int)cudaGetLastError();
}

// The valued histograms take the launch plan of kernels.py hist_plan:
// `clusters` clusters of `cluster` blocks of `threads` threads, each block
// owning `rows_per_block` rows (smem_bytes = 8 * cluster * rows_per_block * P
// of dynamic shared memory for its copy of the cluster's slice, int and
// float cells, plus 8 * HIST_QUEUE a warp for its queue).  items_per_block: the 4-id groups a block takes
// at a time from its cluster's items (rounded up to a power of two groups).
// One launch; nothing is zeroed first.

// vals: [N, P] float32 (vals_float != 0) or int32.  plane_stride == 0: out is
// [n, P]; otherwise out is [P, plane_stride] with plane_stride >= n.
extern "C" int sentinel_probe_hist_planes(const void* ids, const void* vals, int vals_float,
                                          long long N, int P, int n, void* out,
                                          long long plane_stride, int items_per_block,
                                          int cluster, int clusters, int rows_per_block,
                                          int smem_bytes, int threads, void* stream) {
  HistGeom g;
  const int e = hist_geom(g, N, n, P, plane_stride, items_per_block, cluster, clusters,
                          rows_per_block, smem_bytes, threads);
  if (e) return e;
  g.ids = (const int*)ids;
  g.out = (float*)out;
  const bool vec4 = P % 4 == 0 && (reinterpret_cast<uintptr_t>(vals) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vals_float) {
    return hist_launch(g, PlaneValues<float>{(const float*)vals, P, vec4}, clusters, smem_bytes, threads, s);
  }
  return hist_launch(g, PlaneValues<int>{(const int*)vals, P, vec4}, clusters, smem_bytes, threads, s);
}

// out: [out_len] float32 ([n_hi, n_lo] flat), out_len >= n; the plan's
// smem_bytes = 4 * cluster * rows_per_block (int cells alone, no queue).
extern "C" int sentinel_probe_hist_count(const void* ids, long long N, int n, void* out, long long out_len,
                                         int items_per_block, int cluster, int clusters, int rows_per_block,
                                         int smem_bytes, int threads, void* stream) {
  if (out_len < 1) return (int)cudaErrorInvalidValue;
  HistGeom g;
  const int e = hist_geom(g, N, n, 1, out_len, items_per_block, cluster, clusters, rows_per_block,
                          smem_bytes, threads, true);
  if (e) return e;
  g.ids = (const int*)ids;
  g.out = (float*)out;
  return hist_launch(g, CountValues{}, clusters, smem_bytes, threads, (cudaStream_t)stream);
}

// cnts: [N, 3] int32; rt: [N] int32; out: [5, plane_stride], plane_stride >= n.
extern "C" int sentinel_probe_hist_stat5(const void* ids, const void* cnts, const void* rt,
                                         long long N, int n, void* out, long long plane_stride,
                                         int items_per_block, int cluster, int clusters,
                                         int rows_per_block, int smem_bytes, int threads,
                                         void* stream) {
  if (plane_stride < 1) return (int)cudaErrorInvalidValue;
  HistGeom g;
  const int e = hist_geom(g, N, n, 5, plane_stride, items_per_block, cluster, clusters,
                          rows_per_block, smem_bytes, threads);
  if (e) return e;
  g.ids = (const int*)ids;
  g.out = (float*)out;
  return hist_launch(g, Stat5Values{(const int*)cnts, (const int*)rt}, clusters, smem_bytes, threads,
                     (cudaStream_t)stream);
}

// The clusters of `cluster` blocks of `threads` threads the device runs at
// once (cudaOccupancyMaxActiveClusters at the most shared memory a block may
// take), the least over the four kernels.  It also sets the kernels'
// attributes on the current device (dynamic shared memory up to
// HIST_MAX_SMEM, clusters past the portable 8): call it once a device
// before the first launch.
extern "C" int sentinel_probe_hist_max_clusters(int cluster, int threads, int* out) {
  if (cluster < 1 || cluster > HIST_MAX_CLUSTER || threads < 32 || threads > HIST_MAX_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  const void* kerns[4] = {(const void*)probe_hist_cluster_kernel<Stat5Values>,
                          (const void*)probe_hist_cluster_kernel<PlaneValues<int>>,
                          (const void*)probe_hist_cluster_kernel<PlaneValues<float>>,
                          (const void*)probe_hist_cluster_kernel<CountValues>};
  int least = 1 << 30;
  for (const void* k : kerns) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, HIST_MAX_SMEM);
    if (e == cudaSuccess && cluster > 8) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)cluster);
    cfg.blockDim = dim3((unsigned int)threads);
    cfg.dynamicSmemBytes = HIST_MAX_SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned int)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
    if (e != cudaSuccess) return (int)e;
    least = n < least ? n : least;
  }
  *out = least;
  return 0;
}
