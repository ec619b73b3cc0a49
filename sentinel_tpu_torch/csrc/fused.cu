// Effect-phase scatter and flow-check gather kernels for Hopper (sm_90a).
//
// scatter_many replaces the Pallas kernel sentinel_tpu/ops/fused.py
// scatter_many (pl.pallas_call at fused.py:320); gather_many replaces
// sentinel_tpu/ops/fused.py gather_many (pl.pallas_call at fused.py:462).
// The Python wrappers and the plain PyTorch versions of both live in
// sentinel_tpu_torch/ops/fused.py; this file has a plain C interface and
// is loaded with ctypes (no PyTorch headers, so it builds in seconds).
//
// scatter_many — many scatter-add histograms in two launches.
//   What bounds it: bytes and launches.  At the engine's shapes (N = 2,048
//   or 256 items, a 262,144-row stat table, 2.9 M output cells, 11.5 MB, a
//   call on the segment path) the work is ~30 K integer adds against an
//   output that must be written once: 3.4 us of HBM time.  The TPU kernel
//   built one-hot factors and bf16 digit-plane matmuls because the TPU has
//   no fast random scatter; Hopper has native integer atomics in L2 and in
//   shared memory, so each (item, row-vector, plane) is an atomicAdd of
//   the digit-truncated value, exact and independent of order.
//   The design, against what bounded the first version (a memset, a
//   scatter and a conversion pass over every cell — three launches and
//   three passes over the table — plus the wrapper's own int32 copies of
//   transposed, permuted and uint8 operands, 17 more launches a tick on
//   the per-item path):
//   - One write pass over the output.  In launch 1 every block writes its
//     share of the float32 output's zeros (float4 stores) and then sums
//     into a separate int32 accumulator `acc` that the wrapper keeps
//     all-zero between calls (one per device and stream).  Launch 2 converts only
//     the touched cells into the output and zeroes them again in `acc`.
//   - Which cells were touched: a bitmap, one bit a cell (1/32 of the
//     table).  Every add sets its cell's bit with atomicOr.  The adds and
//     the ORs are fire-and-forget reductions: no value comes back, so no
//     thread waits on L2.  OWNERSHIP of a cell in launch 2 comes from its
//     bitmap word, which exactly one thread reads
//     and clears — never from "my atomicAdd returned 0", which is not
//     unique once a sum of all-ones-masked (negative) values returns to 0.
//     That thread converts the 4-cell groups with a bit set, 16 bytes at a
//     time (an untouched cell's sum is 0, which converts to the 0.0f launch
//     1 wrote), so launch 2 reads the bitmap and touches only the groups
//     items touched; `acc` and the bitmap are zero again when the call
//     ends, with no memset.  (Walking the items again and claiming cells
//     with atomicAnd's returned value instead is a round trip to L2 per
//     cell, and measured several times slower on the H100.)
//   - No search for the job: launch 1's grid is 2-D, blockIdx.y the job
//     and blockIdx.x its (row-vector, item block), so a block's first
//     reads are its job's descriptor, straight from the parameter bank.
//   - Two launches a call, the zeroing included.  The descriptors are per
//     JOB (a job's row-vectors are its rows tensor at a stride), so any
//     number of row-vectors rides one launch.  A launch carries 16 jobs
//     (1.4 KB of parameters: the engine's calls have at most 6, and the
//     host copies the whole parameter block at every launch); each further
//     16 jobs take one more scatter launch.
//   - Operands are read where they lie: int32, int64, uint8/bool, int8 or
//     int16, at any element strides (transposed and permuted views,
//     expanded rows), so the wrapper copies nothing.  Row ids compare in 64
//     bits, values truncate to their low 32 bits, as `.to(torch.int32)`
//     does.  A thread loads its row id and every plane's value at once.
//   - Hot rows are aggregated inside the warp: a run of neighbouring lanes
//     that add to one cell (items of one context share its node row; the
//     segment paths sort items by resource) sums by shuffles into the run's
//     first lane, which adds for the run — one atomic per run instead of
//     one per lane.  Grouping ANY equal cells with __match_any_sync and
//     __reduce_add_sync was measured on the H100 too and cost launch 1
//     more than the atomics it saved; a hot cell scattered across an
//     unsorted warp still costs one atomic a lane.
//   - Tables small enough for shared memory (at most 12,288 cells, the
//     wrapper's flag) are privatized per block when the block adds to them
//     at least as often as it would zero and flush them (n <= items a
//     block), and flushed with one atomic per nonzero cell.
//   Launch shapes: launch 1 is [max row-vectors x item blocks, jobs],
//   `gx` item blocks a row-vector (at most 64), widened on the first chunk
//   so that every block writes ~4 float4 zeros a thread; launch 2 has a
//   thread a bitmap word.
//
// gather_many — per-item reads of up to 4 planes, each from a column.
//   Replaces the tick's old read: the Pallas kernel contracted one-hot rows
//   against bf16 digit planes of a dense [n, P] table that XLA built and
//   fused around it; eager PyTorch cannot fuse, so the port's first version
//   built that [node_rows, 3] table in six launches over all 262,152 node
//   rows (~20 MB of device traffic by the shapes, and over 0.1 ms of host
//   time to enqueue on an H100's host) to read 8,192 of them, and then
//   gathered with one thread an (item, plane).
//   What bounds it: round trips, not bytes.  At the tick's shape (8,192
//   items, 3 planes, one guard) it moves ~0.15 MB: the ids, 4 B of each
//   column for each row the ids name, and the output; a call is an id load,
//   then one dependent load of each column, then the store.
//   The design: every plane is a COLUMN read where it lies — int32 or
//   float32 at its own element stride (run[:, EV_PASS] at stride 5, no
//   copy), capped (a signed minimum) before its digit mask; a float column
//   rounds half to even into int32 (__float2int_rn, as torch.round then
//   .to(int32)) and may carry a guard, an int32 column whose row must equal
//   a key or the value reads 0.  A 2-D int32 table is P columns at stride
//   P.  One thread takes GATHER_ITEMS = 2 items: one 8-byte load of their
//   ids, then every (item, plane) load and guard load issued together —
//   one round trip after the id — and P 8-byte stores of its 2 x P output
//   floats, with scalar loads and stores at a ragged or misaligned end.
//   Two items, not four: with four, the tick's 8,192 items sat on 16 SMs
//   with 16 loads a thread in flight, and on an H100 the kernel was slower
//   than with two items on 64 SMs (blocks of 64 threads) or one.
//   blockIdx.y is the job; a launch carries MAX_GATHER_JOBS jobs.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXP 4
#define MAX_JOBS 16
#define MAX_GATHER_JOBS 8
#define BLOCK 256
#define DESC_SLOTS 11

// operand element types (ops/fused.py _DTYPES)
#define DT_I32 0
#define DT_I64 1
#define DT_U8 2
#define DT_I8 3
#define DT_I16 4

struct JobDesc {
  const void* rows;    // [R, N] row ids at (rs_r, rs_n) element strides
  const void* vals;    // [P, N] (vs_r = 0) or [R, P, N] values
  long long out_off;   // first output cell of this job's [n, P] table
  int n, P, R, priv;   // table rows, planes, row-vectors, shared-memory copy
  int rows_dt, vals_dt;
  int rs_r, rs_n, vs_r, vs_p, vs_n;
  unsigned int mask[MAXP];  // 256**digits - 1 per plane (all ones for >= 4)
};

struct ScatterParams {
  float* out;
  unsigned int* acc;      // int32 sums, all zero between calls
  unsigned int* touched;  // one bit a cell, all zero between calls
  long long out_len;
  int N, gx, zero;         // items, blocks a row-vector, 1: this launch zeroes `out`
  JobDesc j[MAX_JOBS];
};

__device__ __forceinline__ long long load_elem(const void* base, long long idx, int dt) {
  switch (dt) {
    case DT_I32: return ((const int*)base)[idx];
    case DT_I64: return ((const long long*)base)[idx];
    case DT_U8: return ((const unsigned char*)base)[idx];
    case DT_I8: return ((const signed char*)base)[idx];
    default: return ((const short*)base)[idx];
  }
}

// Launch 1: blockIdx.y is the job, blockIdx.x a (row-vector, item block)
// pair of it, so a block reads its job's descriptor straight from the
// parameter bank, with no search.  Every block first writes its share of
// the output's zeros (posted stores; the grid is wide enough for ~4
// float4s a thread); then a block whose row-vector exists walks its items,
// adds each digit-masked value to its cell of `acc` and sets the cell's
// bit in `touched` — both fire-and-forget reductions (no value returned,
// so no thread waits on L2).
__global__ void __launch_bounds__(BLOCK) scatter_many_kernel(const ScatterParams prm) {
  extern __shared__ unsigned int sh[];
  const JobDesc J = prm.j[blockIdx.y];
  if (prm.zero) {
    const long long n4 = (prm.out_len + 3) >> 2;  // the wrapper pads the output to whole float4s
    const long long step = (long long)gridDim.x * gridDim.y * BLOCK;
    float4* o4 = reinterpret_cast<float4*>(prm.out);
    for (long long c = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * BLOCK + threadIdx.x; c < n4;
         c += step)
      o4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int r = blockIdx.x / prm.gx;
  if (r >= J.R) return;
  const int bx = blockIdx.x - r * prm.gx;
  const int N = prm.N;
  const int P = J.P;
  const int n = J.n;
  const int lane = threadIdx.x & 31;
  const long long rbase = (long long)r * J.rs_r;
  const long long vbase = (long long)r * J.vs_r;
  if (J.priv) {
    for (int c = threadIdx.x; c < n * P; c += BLOCK) sh[c] = 0u;
    __syncthreads();
  }
  // whole warps walk the items together, so a warp can aggregate its cells
  for (int base = bx * BLOCK; base < N; base += prm.gx * BLOCK) {
    const int i = base + threadIdx.x;
    long long k = -1;
    unsigned int v[MAXP] = {0u, 0u, 0u, 0u};
    if (i < N) {  // the row id and every plane's value, loaded together
      k = load_elem(J.rows, rbase + (long long)i * J.rs_n, J.rows_dt);
#pragma unroll
      for (int p = 0; p < MAXP; ++p)
        if (p < P)
          v[p] = (unsigned int)load_elem(J.vals, vbase + (long long)p * J.vs_p + (long long)i * J.vs_n,
                                         J.vals_dt);
    }
    const bool ok = k >= 0 && k < n;
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      if (p >= P) break;
      const unsigned int x = ok ? v[p] & J.mask[p] : 0u;
      // the cell in the job's table (below 2^31), or a key of this lane's
      // own when it adds nothing
      const unsigned int key = x ? (unsigned int)(k * P + p) : 0xffffffffu - lane;
      // a run of neighbouring lanes with one cell sums into its first lane
      const unsigned int left = __shfl_up_sync(0xffffffffu, key, 1);  // every lane shuffles
      const bool head = lane == 0 || left != key;
      const unsigned int later = __ballot_sync(0xffffffffu, head) & ~((2u << lane) - 1u);
      const int run_end = later ? __ffs(later) - 2 : 31;  // this run's last lane
      unsigned int s = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned int y = __shfl_down_sync(0xffffffffu, s, d);
        if (lane + d <= run_end) s += y;
      }
      if (!s || !head) continue;
      if (J.priv) {
        atomicAdd(&sh[key], s);
      } else {
        const long long c = J.out_off + key;
        atomicAdd(&prm.acc[c], s);
        atomicOr(&prm.touched[c >> 5], 1u << (c & 31));
      }
    }
  }
  if (J.priv) {
    __syncthreads();
    for (int c = threadIdx.x; c < n * P; c += BLOCK) {
      const unsigned int x = sh[c];
      if (x) {
        const long long g = J.out_off + c;
        atomicAdd(&prm.acc[g], x);
        atomicOr(&prm.touched[g >> 5], 1u << (g & 31));
      }
    }
  }
}

// Launch 2: one thread a bitmap word (32 cells).  The word's owner — the
// only thread that reads it — clears it, and for each group of 4 cells
// with a bit set loads the 4 sums at once (16 bytes), writes them as
// float32 (an untouched cell's sum is 0, and 0.0f is what launch 1 wrote
// there) and zeroes them in `acc`.  Ownership is exact whatever the values
// (never "my atomicAdd returned 0", which is not unique once a sum of
// all-ones-masked, negative values returns to 0), and `acc` and the bitmap
// are zero again when the launch ends.
__global__ void __launch_bounds__(BLOCK) convert_touched_kernel(float* __restrict__ out,
                                                                unsigned int* __restrict__ acc,
                                                                unsigned int* __restrict__ touched,
                                                                long long n_words) {
  for (long long w = (long long)blockIdx.x * BLOCK + threadIdx.x; w < n_words;
       w += (long long)gridDim.x * BLOCK) {
    const unsigned int bits = touched[w];
    if (!bits) continue;
    touched[w] = 0u;
    int4* a4 = reinterpret_cast<int4*>(acc) + w * 8;
    float4* o4 = reinterpret_cast<float4*>(out) + w * 8;
    int4 q[8];
#pragma unroll
    for (int g = 0; g < 8; ++g)  // the loads first, all in flight together
      if ((bits >> (4 * g)) & 0xFu) q[g] = a4[g];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      if ((bits >> (4 * g)) & 0xFu) {
        o4[g] = make_float4(__int2float_rn(q[g].x), __int2float_rn(q[g].y), __int2float_rn(q[g].z),
                            __int2float_rn(q[g].w));
        a4[g] = make_int4(0, 0, 0, 0);
      }
    }
  }
}

#define GATHER_ITEMS 2    // items a thread: one 8-byte id load
#define GATHER_BLOCK 64   // the tick's 8,192 items spread over 64 SMs
#define GATHER_FLOAT 1    // column flag: float32 source (else int32)

struct GatherJob {
  const int* ids;            // [N], contiguous
  float* out;                // [N, P] row-major, 16-byte aligned
  const void* src[MAXP];     // column p: [n] at stride[p] elements
  const int* guard[MAXP];    // [n] at gstride[p] elements, or null
  int n, P;
  int stride[MAXP], gstride[MAXP], flags[MAXP], cap[MAXP];
  unsigned int mask[MAXP];   // 256**digits - 1 (all ones for >= 4)
  int key[MAXP];
};

struct GatherParams {
  int N;
  GatherJob j[MAX_GATHER_JOBS];
};

// Items [GATHER_ITEMS * t, + GATHER_ITEMS) of job g.
template <int P>
__device__ __forceinline__ void gather_items(const GatherJob& g, int N, long long t) {
  const long long i0 = t * GATHER_ITEMS;
  const bool whole = i0 + GATHER_ITEMS <= N;
  int id[GATHER_ITEMS];
  if (whole && (reinterpret_cast<uintptr_t>(g.ids + i0) & 7) == 0) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(g.ids + i0));
    id[0] = q.x;
    id[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < GATHER_ITEMS; ++k) id[k] = i0 + k < N ? __ldg(g.ids + i0 + k) : -1;
  }
  // every column and guard load of the thread's items, in flight together
  unsigned int raw[GATHER_ITEMS][P];
  int gd[GATHER_ITEMS][P];
#pragma unroll
  for (int k = 0; k < GATHER_ITEMS; ++k) {
    const bool ok = id[k] >= 0 && id[k] < g.n;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      raw[k][p] = ok ? __ldg(reinterpret_cast<const unsigned int*>(g.src[p]) + (long long)id[k] * g.stride[p]) : 0u;
      gd[k][p] = ok && g.guard[p] ? __ldg(g.guard[p] + (long long)id[k] * g.gstride[p]) : g.key[p];
    }
  }
  float o[GATHER_ITEMS * P];
#pragma unroll
  for (int k = 0; k < GATHER_ITEMS; ++k) {
    const bool ok = id[k] >= 0 && id[k] < g.n;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int v = (g.flags[p] & GATHER_FLOAT) ? __float2int_rn(__uint_as_float(raw[k][p])) : (int)raw[k][p];
      if (gd[k][p] != g.key[p]) v = 0;
      v = min(v, g.cap[p]);
      o[k * P + p] = ok ? __int2float_rn((int)((unsigned int)v & g.mask[p])) : 0.f;
    }
  }
  // the thread's 2 x P floats are contiguous: P 8-byte stores
  float* dst = g.out + i0 * P;
  if (whole && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
#pragma unroll
    for (int q = 0; q < P; ++q) reinterpret_cast<float2*>(dst)[q] = make_float2(o[2 * q], o[2 * q + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < GATHER_ITEMS; ++k) {
      if (i0 + k >= N) break;
#pragma unroll
      for (int p = 0; p < P; ++p) dst[k * P + p] = o[k * P + p];
    }
  }
}

template <int P>
__device__ __forceinline__ void gather_job(const GatherJob& g, int N) {
  const long long groups = (N + GATHER_ITEMS - 1) / GATHER_ITEMS;
  for (long long t = (long long)blockIdx.x * GATHER_BLOCK + threadIdx.x; t < groups;
       t += (long long)gridDim.x * GATHER_BLOCK)
    gather_items<P>(g, N, t);
}

__global__ void __launch_bounds__(GATHER_BLOCK) gather_many_kernel(const GatherParams prm) {
  const GatherJob g = prm.j[blockIdx.y];
  switch (g.P) {  // P is a template argument: the thread's values stay in registers
    case 1: gather_job<1>(g, prm.N); break;
    case 2: gather_job<2>(g, prm.N); break;
    case 3: gather_job<3>(g, prm.N); break;
    case 4: gather_job<4>(g, prm.N); break;
    default: break;
  }
}

static int grid_for(long long work, int cap) {
  long long g = (work + BLOCK - 1) / BLOCK;
  if (g < 1) g = 1;
  if (g > cap) g = cap;
  return (int)g;
}

// The launch goes to `device` (restored after), on `stream`.
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    if (cudaGetDevice(&prev) == cudaSuccess && prev != device) cudaSetDevice(device);
    else prev = -1;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// scatter descriptors: DESC_SLOTS eight-byte slots a job — rows pointer,
// values pointer, output offset, then 16 int32 words: n, P, R, priv,
// rows dtype, values dtype, rows strides (r, n), values strides (r, p, n),
// unused, mask[MAXP].  out: out_len float32 cells, padded to a multiple of
// 4; acc / touched: the all-zero scratch (out_len cells rounded up to a
// multiple of 32, and one bit each).  Returns the CUDA error code of its
// launches (0 = success): one scatter launch per MAX_JOBS jobs, then the
// conversion.
extern "C" int sentinel_scatter_many(const long long* desc, int n_jobs, int N, float* out,
                                     long long out_len, unsigned int* acc, unsigned int* touched,
                                     int device, void* stream) {
  if (n_jobs < 1 || out_len < 1) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t s = (cudaStream_t)stream;
  const int gx = grid_for(N, 64);
  const int items_per_block = (N + gx - 1) / gx;
  for (int base = 0; base < n_jobs; base += MAX_JOBS) {
    const int m = n_jobs - base < MAX_JOBS ? n_jobs - base : MAX_JOBS;
    ScatterParams prm;
    prm.out = out;
    prm.acc = acc;
    prm.touched = touched;
    prm.out_len = out_len;
    prm.N = N;
    prm.gx = gx;
    prm.zero = base == 0;
    int smem = 0;
    int max_r = 0;
    for (int q = 0; q < m; ++q) {
      const long long* d = desc + (size_t)(base + q) * DESC_SLOTS;
      const int* w = (const int*)(d + 3);
      JobDesc& x = prm.j[q];
      x.rows = (const void*)d[0];
      x.vals = (const void*)d[1];
      x.out_off = d[2];
      x.n = w[0];
      x.P = w[1];
      x.R = w[2];
      // a shared-memory copy pays for itself only when the block adds to
      // its table at least as often as it zeroes and flushes its cells
      x.priv = w[3] && x.n <= items_per_block;
      x.rows_dt = w[4];
      x.vals_dt = w[5];
      x.rs_r = w[6];
      x.rs_n = w[7];
      x.vs_r = w[8];
      x.vs_p = w[9];
      x.vs_n = w[10];
      for (int p = 0; p < MAXP; ++p) x.mask[p] = (unsigned int)w[12 + p];
      if (x.R > max_r) max_r = x.R;
      if (x.priv && 4 * x.n * x.P > smem) smem = 4 * x.n * x.P;
    }
    // a block per (row-vector, item block) of the longest job; the first
    // chunk's grid is also wide enough to zero the output at ~4 float4
    // stores a thread
    long long gxs = (long long)max_r * gx;
    if (prm.zero) {
      const long long zero_blocks = ((out_len + 3) / 4 + 4 * BLOCK - 1) / (4 * BLOCK);
      const long long per_row = (zero_blocks + m - 1) / m;
      if (per_row > gxs) gxs = per_row;
    }
    if (gxs == 0) continue;
    scatter_many_kernel<<<dim3((unsigned int)gxs, m), BLOCK, smem, s>>>(prm);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_words = (out_len + 31) / 32;
  convert_touched_kernel<<<grid_for(n_words, 1056), BLOCK, 0, s>>>(out, acc, touched, n_words);
  return (int)cudaGetLastError();
}

// gather descriptors: GATHER_SLOTS eight-byte slots a job — ids, out,
// src[MAXP], guard[MAXP] pointers, then 26 int32 words: n, P, stride[MAXP],
// gstride[MAXP], flags[MAXP], cap[MAXP], mask[MAXP], key[MAXP].  N >= 1.
// Returns the CUDA error code of its launches (0 = success): one per
// MAX_GATHER_JOBS jobs.
#define GATHER_SLOTS 23
extern "C" int sentinel_gather_many(const long long* desc, int n_jobs, int N, int device, void* stream) {
  if (n_jobs < 1 || N < 1) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t s = (cudaStream_t)stream;
  const long long groups = (N + GATHER_ITEMS - 1) / GATHER_ITEMS;
  long long gx = (groups + GATHER_BLOCK - 1) / GATHER_BLOCK;
  if (gx > 1024) gx = 1024;
  for (int base = 0; base < n_jobs; base += MAX_GATHER_JOBS) {
    const int m = n_jobs - base < MAX_GATHER_JOBS ? n_jobs - base : MAX_GATHER_JOBS;
    GatherParams prm;
    prm.N = N;
    for (int q = 0; q < m; ++q) {
      const long long* d = desc + (size_t)(base + q) * GATHER_SLOTS;
      const int* w = (const int*)(d + 2 + 2 * MAXP);
      GatherJob& g = prm.j[q];
      g.ids = (const int*)d[0];
      g.out = (float*)d[1];
      g.n = w[0];
      g.P = w[1];
      for (int p = 0; p < MAXP; ++p) {
        g.src[p] = (const void*)d[2 + p];
        g.guard[p] = (const int*)d[2 + MAXP + p];
        g.stride[p] = w[2 + p];
        g.gstride[p] = w[2 + MAXP + p];
        g.flags[p] = w[2 + 2 * MAXP + p];
        g.cap[p] = w[2 + 3 * MAXP + p];
        g.mask[p] = (unsigned int)w[2 + 4 * MAXP + p];
        g.key[p] = w[2 + 5 * MAXP + p];
      }
    }
    gather_many_kernel<<<dim3((unsigned int)gx, m), GATHER_BLOCK, 0, s>>>(prm);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
