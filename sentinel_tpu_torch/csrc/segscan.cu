// Segmented scans for the segment check and completion phases, for Hopper
// (sm_90a).
//
// seg_excl_cumsum replaces the Pallas kernel sentinel_tpu/ops/segscan.py
// seg_excl_cumsum_pl (pl.pallas_call at segscan.py:104); seg_incl_min
// replaces seg_incl_min_pl (pl.pallas_call at segscan.py:192).  The Python
// wrappers and the plain PyTorch versions of both live in
// sentinel_tpu_torch/ops/segscan.py; this file has a plain C interface and
// is loaded with ctypes.
//
// seg_excl_cumsum — int32 [V, N] values, bool [N] heads: item i gets the
//   sum of the earlier items of its segment (heads reset the sum).  Sums
//   wrap modulo 2^32, so a result is exact whenever its segment's total
//   stays below 2^31 (the caller's contract).
// seg_incl_min — float32 [N] values, bool [N] heads: item i gets the
//   minimum of its segment's items up to and including i, and never more
//   than the identity 3.0e38 (the TPU kernel's carry, which clamps the same
//   way).
//
// What bounds them on this card: neither bytes nor arithmetic.  At the
// engine's shapes (N = 2,048 or 256 items, V <= 4 rows) a call moves 10-40
// KB and does a few thousand adds or compares — nanoseconds against
// 3.35 TB/s — so the launch itself (a few microseconds) is the floor.  The
// design spends one launch per call at those shapes and nothing else:
//
// - The TPU kernel walked a SEQUENTIAL grid of 2,048-item tiles, carrying
//   the sum in VMEM scratch, with 11 roll/select log-steps per tile.  On
//   Hopper blocks run in parallel and in no order, so a tile is one block
//   of 256 threads x 8 items: each thread scans its 8 items in registers,
//   a warp scans the threads' (value, any-head) pairs with __shfl_up_sync,
//   and one pass over the 8 warps' totals in shared memory finishes the
//   block.  Rows ride blockIdx.y, so all V rows take one launch.
// - A row that fits one tile (N <= 2,048, every call the client makes)
//   needs no carry.  A longer row (up to the 131,072-item batches the JAX
//   package serves) takes a second, tiny pass first: pass 1 writes each
//   tile's (open-segment aggregate, any-head) pair, and in pass 2 each tile
//   folds the pairs of the tiles before it, back to the nearest tile with a
//   head (at most 64 pairs at N = 131,072), into the items before its own
//   first head.
// - Integer sums and float minima do not depend on the order of
//   combination, so both kernels equal their plain versions exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCAN_THREADS 256
#define SCAN_ITEMS 8
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)
#define SCAN_WARPS (SCAN_THREADS / 32)

struct SumOp {
  typedef int T;
  __device__ static int identity() { return 0; }
  // two's-complement wraparound, without signed-overflow UB
  __device__ static int apply(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
};

struct MinOp {
  typedef float T;
  __device__ static float identity() { return 3.0e38f; }
  __device__ static float apply(float a, float b) { return b < a ? b : a; }
};

// (earlier, later) segmented combine: a head in the later part cuts the
// earlier part off.
template <class Op>
__device__ __forceinline__ void combine(typename Op::T& v, int& f,
                                        typename Op::T ev, int ef) {
  if (!f) v = Op::apply(ev, v);
  f = f | ef;
}

// mode 0: write the tile's (aggregate, any-head) pair to agg/agg_flag.
// mode 1: write the scan, folding the earlier tiles' pairs in as a carry.
// exclusive: 1 writes the exclusive scan (B3), 0 the inclusive one (B4).
template <class Op>
__global__ void seg_scan_kernel(const unsigned char* __restrict__ head,
                                const typename Op::T* __restrict__ vals,
                                typename Op::T* __restrict__ out,
                                typename Op::T* __restrict__ agg,
                                int* __restrict__ agg_flag, int N, int n_tiles,
                                int mode, int exclusive) {
  typedef typename Op::T T;
  __shared__ T s_val[SCAN_WARPS];
  __shared__ int s_flag[SCAN_WARPS];
  __shared__ T s_carry;
  const int row = blockIdx.y;
  const int tile = blockIdx.x;
  const T* v = vals + (size_t)row * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = tile * SCAN_TILE + threadIdx.x * SCAN_ITEMS;

  // 1. this thread's items, and their segmented aggregate
  T raw[SCAN_ITEMS];
  int fl[SCAN_ITEMS];
  T tv = Op::identity();
  int tf = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = i0 + k;
    const bool in = i < N;
    raw[k] = in ? v[i] : Op::identity();
    fl[k] = in ? (head[i] != 0) : 1;  // past the row: a head, no effect
    if (fl[k]) tv = raw[k]; else tv = Op::apply(tv, raw[k]);
    tf |= fl[k];
  }

  // 2. inclusive scan of the threads' pairs inside the warp
  T wv = tv;
  int wf = tf;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T ov = __shfl_up_sync(0xffffffffu, wv, d);
    const int of = __shfl_up_sync(0xffffffffu, wf, d);
    if (lane >= d) combine<Op>(wv, wf, ov, of);
  }
  if (lane == 31) {
    s_val[warp] = wv;
    s_flag[warp] = wf;
  }
  // this thread's exclusive prefix inside the warp
  T pv = __shfl_up_sync(0xffffffffu, wv, 1);
  int pf = __shfl_up_sync(0xffffffffu, wf, 1);
  if (lane == 0) {
    pv = Op::identity();
    pf = 0;
  }
  __syncthreads();

  if (mode == 0) {
    if (threadIdx.x == 0) {
      T a = Op::identity();
      int af = 0;
      for (int w = 0; w < SCAN_WARPS; ++w) {
        T x = s_val[w];
        int xf = s_flag[w];
        combine<Op>(x, xf, a, af);
        a = x;
        af = xf;
      }
      agg[(size_t)row * n_tiles + tile] = a;
      agg_flag[(size_t)row * n_tiles + tile] = af;
    }
    return;
  }

  // 3. the carry from earlier tiles (pass 2 of a multi-tile row)
  if (threadIdx.x == 0) {
    T c = Op::identity();
    int cf = 0;
    for (int t = tile - 1; t >= 0 && !cf; --t) {
      combine<Op>(c, cf, agg[(size_t)row * n_tiles + t],
                  agg_flag[(size_t)row * n_tiles + t]);
    }
    s_carry = c;
  }
  __syncthreads();

  // 4. prefix before this thread = carry, then earlier warps, then earlier lanes
  T run = s_carry;
  int rf = 0;
  for (int w = 0; w < warp; ++w) {
    T x = s_val[w];
    int xf = s_flag[w];
    combine<Op>(x, xf, run, rf);
    run = x;
    rf = xf;
  }
  combine<Op>(pv, pf, run, rf);
  run = pv;

  // 5. this thread's items
  T* o = out + (size_t)row * N;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = i0 + k;
    const T before = fl[k] ? Op::identity() : run;
    run = Op::apply(before, raw[k]);
    if (i < N) o[i] = exclusive ? before : Op::apply(run, Op::identity());
  }
}

template <class Op>
static int seg_scan(const unsigned char* head, const typename Op::T* vals,
                    typename Op::T* out, typename Op::T* agg, int* agg_flag,
                    int V, int N, int exclusive, void* stream) {
  if (V < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (N + SCAN_TILE - 1) / SCAN_TILE;
  if (n_tiles > 1 && (agg == nullptr || agg_flag == nullptr)) return (int)cudaErrorInvalidValue;
  dim3 grid(n_tiles, V);
  if (n_tiles > 1) {
    seg_scan_kernel<Op><<<grid, SCAN_THREADS, 0, s>>>(head, vals, out, agg, agg_flag, N,
                                                      n_tiles, 0, exclusive);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  seg_scan_kernel<Op><<<grid, SCAN_THREADS, 0, s>>>(head, vals, out, agg, agg_flag, N,
                                                    n_tiles, 1, exclusive);
  return (int)cudaGetLastError();
}

// Both entry points: head uint8 [N] (0/1), values and out [V, N] row-major,
// agg [V, n_tiles] and agg_flag int32 [V, n_tiles] scratch (may be null when
// N <= SCAN_TILE).  Each returns the CUDA error code of its launches.

extern "C" int sentinel_seg_excl_cumsum(const unsigned char* head, const int* vals, int* out,
                                        int* agg, int* agg_flag, int V, int N, void* stream) {
  return seg_scan<SumOp>(head, vals, out, agg, agg_flag, V, N, 1, stream);
}

extern "C" int sentinel_seg_incl_min(const unsigned char* head, const float* vals, float* out,
                                     float* agg, int* agg_flag, int V, int N, void* stream) {
  return seg_scan<MinOp>(head, vals, out, agg, agg_flag, V, N, 0, stream);
}

extern "C" int sentinel_seg_scan_tile() { return SCAN_TILE; }
