// Segmented scans for the segment check and completion phases, for Hopper
// (sm_90a).
//
// seg_excl_cumsum replaces the Pallas kernel sentinel_tpu/ops/segscan.py
// seg_excl_cumsum_pl (pl.pallas_call at segscan.py:104) and its wide
// wrapper seg_excl_cumsum_wide_pl (segscan.py:215); seg_incl_min replaces
// seg_incl_min_pl (pl.pallas_call at segscan.py:192).  The Python wrappers
// and the plain PyTorch versions live in sentinel_tpu_torch/ops/segscan.py;
// this file has a plain C interface and is loaded with ctypes.
//
// seg_excl_cumsum — bool [N] heads and, in ONE launch, narrow and wide
//   rows: item i gets the sum of the earlier items of its segment (heads
//   reset the sum).
//   - A narrow row is int32 in, int32 out; sums wrap modulo 2^32, so a
//     result is exact whenever its segment's total stays below 2^31 (the
//     caller's contract).
//   - A wide row is int32 values up to 2^24 whose totals may pass 2^31,
//     float32 out.  The reference splits each value into 12-bit lanes
//     lo = v & 0xFFF and hi = v >> 12, scans both in int32 and returns
//     fl(fl(hi) * 4096 + fl(lo)).  The kernel does the same in registers:
//     it scans the (lo, hi) pair and writes __fadd_rn(__fmul_rn(hi, 4096),
//     lo) — no FMA contraction, so one rounding of the sum wherever hi's
//     lane total is exact in float32 (below 2^24, i.e. totals below 2^36),
//     and in every case the reference's bits, negative values included
//     (an exact int64 scan rounded once would differ from the reference
//     where fl(hi) rounds).  The lane split and the recombination were
//     eight PyTorch launches around the kernel; they are gone.
// seg_incl_min — float32 [N] values, bool [N] heads: item i gets the
//   minimum of its segment's items up to and including i, and never more
//   than the identity 3.0e38 (the TPU kernel's carry, which clamps the same
//   way).
//
// What bounds them on this card: the launch.  At the engine's shapes
// (N = 2,048 or 256 items, up to 3 rows) a call moves 10-40 KB and does a
// few thousand adds or compares — nanoseconds against 3.35 TB/s — so the
// floor is a launch (2.5 us back to back on the H100) plus the latency of
// one load, one block-wide exchange and one store.  The design:
//
// - The TPU kernel walked a SEQUENTIAL grid of 2,048-item tiles, carrying
//   the sum in VMEM scratch, with 11 roll/select log-steps per tile.  On
//   Hopper blocks run in parallel and in no order, so a tile is one block
//   of 512 threads x 4 items.  Each thread loads its 4 neighbouring items
//   with one 16-byte load (and their 4 head bytes with one 4-byte load)
//   where the row's length allows, so neighbouring threads read
//   neighbouring 16 bytes; it scans them in registers, a warp scans the
//   threads' (value, any-head) pairs with __shfl_up_sync, and ONE
//   shared-memory round (the 16 warps' totals, one __syncthreads) finishes
//   the block.  Rows ride blockIdx.y, so all rows take one launch.
// - A row that fits one tile (N <= 2,048, every call the client makes)
//   needs no carry.  A longer row (up to the 131,072-item batches the JAX
//   package serves) takes a second, tiny pass first: pass 1 writes each
//   tile's (open-segment aggregate, any-head) pair, and in pass 2 each
//   thread folds the pairs of the tiles before its own, back to the nearest
//   tile with a head (at most 64 pairs at N = 131,072), into the items
//   before its tile's first head.
// - Integer sums and float minima do not depend on the order of
//   combination, so both kernels equal their plain versions exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCAN_THREADS 512
#define SCAN_ITEMS 4
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)
#define SCAN_WARPS (SCAN_THREADS / 32)
#define FULL 0xffffffffu

// two's-complement wraparound, without signed-overflow UB
__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

struct Lanes {
  int lo, hi;
};

__device__ __forceinline__ int shfl_up(int v, int d) { return __shfl_up_sync(FULL, v, d); }
__device__ __forceinline__ float shfl_up(float v, int d) { return __shfl_up_sync(FULL, v, d); }
__device__ __forceinline__ Lanes shfl_up(Lanes v, int d) {
  return Lanes{__shfl_up_sync(FULL, v.lo, d), __shfl_up_sync(FULL, v.hi, d)};
}

// 32-bit words of a 16-byte load or store
template <class In>
__device__ __forceinline__ In from_bits(int b);
template <>
__device__ __forceinline__ int from_bits<int>(int b) { return b; }
template <>
__device__ __forceinline__ float from_bits<float>(int b) { return __int_as_float(b); }
__device__ __forceinline__ int to_bits(int v) { return v; }
__device__ __forceinline__ int to_bits(float v) { return __float_as_int(v); }

// narrow rows: int32 sums, exclusive
struct SumOp {
  typedef int T;
  typedef int In;
  typedef int Out;
  static constexpr bool exclusive = true;
  __device__ static int identity() { return 0; }
  __device__ static int apply(int a, int b) { return wrap_add(a, b); }
  __device__ static int lift(int v) { return v; }
  __device__ static int out(int a) { return a; }
};

// wide rows: the (lo, hi) 12-bit lanes of each value, float32 out
struct WideOp {
  typedef Lanes T;
  typedef int In;
  typedef float Out;
  static constexpr bool exclusive = true;
  __device__ static Lanes identity() { return Lanes{0, 0}; }
  __device__ static Lanes apply(Lanes a, Lanes b) { return Lanes{wrap_add(a.lo, b.lo), wrap_add(a.hi, b.hi)}; }
  __device__ static Lanes lift(int v) { return Lanes{v & 0xFFF, v >> 12}; }
  __device__ static float out(Lanes a) {
    return __fadd_rn(__fmul_rn(__int2float_rn(a.hi), 4096.0f), __int2float_rn(a.lo));
  }
};

// float minima, inclusive, never above the identity
struct MinOp {
  typedef float T;
  typedef float In;
  typedef float Out;
  static constexpr bool exclusive = false;
  __device__ static float identity() { return 3.0e38f; }
  __device__ static float apply(float a, float b) { return b < a ? b : a; }
  __device__ static float lift(float v) { return v; }
  __device__ static float out(float a) { return apply(a, identity()); }
};

// (earlier, later) segmented combine: a head in the later part cuts the
// earlier part off.
template <class Op>
__device__ __forceinline__ void combine(typename Op::T& v, int& f, typename Op::T ev, int ef) {
  if (!f) v = Op::apply(ev, v);
  f = f | ef;
}

// One 2,048-item tile of one row.  agg / agg_flag: one (aggregate,
// any-head) pair a tile of this row (8-byte aggregate slots), written by
// pass 1 (mode 0) and read by pass 2 of a multi-tile row.  vec: the row
// may be read and written 16 bytes a thread (N a multiple of 4, aligned).
template <class Op>
__device__ __forceinline__ void scan_tile(const unsigned char* __restrict__ head,
                                          const typename Op::In* __restrict__ in,
                                          typename Op::Out* __restrict__ out, long long* agg,
                                          int* agg_flag, int N, int tile, int mode, bool vec) {
  typedef typename Op::T T;
  __shared__ T s_val[SCAN_WARPS];
  __shared__ int s_flag[SCAN_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = tile * SCAN_TILE + threadIdx.x * SCAN_ITEMS;

  // 1. this thread's 4 items, and their segmented aggregate
  T raw[SCAN_ITEMS];
  int fl[SCAN_ITEMS];
  if (vec && i0 + SCAN_ITEMS <= N) {
    typedef typename Op::In In;
    const int4 q = *reinterpret_cast<const int4*>(in + i0);
    const uchar4 h = *reinterpret_cast<const uchar4*>(head + i0);
    raw[0] = Op::lift(from_bits<In>(q.x));
    raw[1] = Op::lift(from_bits<In>(q.y));
    raw[2] = Op::lift(from_bits<In>(q.z));
    raw[3] = Op::lift(from_bits<In>(q.w));
    fl[0] = h.x != 0;
    fl[1] = h.y != 0;
    fl[2] = h.z != 0;
    fl[3] = h.w != 0;
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const int i = i0 + k;
      const bool inside = i < N;
      raw[k] = inside ? Op::lift(in[i]) : Op::identity();
      fl[k] = inside ? (head[i] != 0) : 1;  // past the row: a head, no effect
    }
  }
  T tv = Op::identity();
  int tf = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    tv = fl[k] ? raw[k] : Op::apply(tv, raw[k]);
    tf |= fl[k];
  }

  // 2. inclusive scan of the threads' pairs inside the warp
  T wv = tv;
  int wf = tf;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T ov = shfl_up(wv, d);
    const int of = __shfl_up_sync(FULL, wf, d);
    if (lane >= d) combine<Op>(wv, wf, ov, of);
  }
  if (lane == 31) {
    s_val[warp] = wv;
    s_flag[warp] = wf;
  }
  // this thread's exclusive prefix inside the warp
  T pv = shfl_up(wv, 1);
  int pf = __shfl_up_sync(FULL, wf, 1);
  if (lane == 0) {
    pv = Op::identity();
    pf = 0;
  }
  __syncthreads();  // the one shared-memory round

  if (mode == 0) {  // pass 1 of a multi-tile row: the tile's pair
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
      *reinterpret_cast<T*>(agg + tile) = a;
      agg_flag[tile] = af;
    }
    return;
  }

  // 3. prefix before this thread: the earlier tiles' carry (pass 2 of a
  // multi-tile row; every thread folds the same few pairs), then the
  // earlier warps, then the earlier lanes
  T run = Op::identity();
  int rf = 0;
  for (int t = tile - 1; t >= 0 && !rf; --t) {
    combine<Op>(run, rf, *reinterpret_cast<const T*>(agg + t), agg_flag[t]);
  }
  rf = 0;  // the carry is a prefix: a head inside it does not cut this tile
  for (int w = 0; w < warp; ++w) {
    T x = s_val[w];
    int xf = s_flag[w];
    combine<Op>(x, xf, run, rf);
    run = x;
    rf = xf;
  }
  combine<Op>(pv, pf, run, rf);
  run = pv;

  // 4. this thread's items
  typename Op::Out o[SCAN_ITEMS];
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const T before = fl[k] ? Op::identity() : run;
    run = Op::apply(before, raw[k]);
    o[k] = Op::out(Op::exclusive ? before : run);
  }
  if (vec && i0 + SCAN_ITEMS <= N) {
    *reinterpret_cast<int4*>(out + i0) = make_int4(to_bits(o[0]), to_bits(o[1]), to_bits(o[2]), to_bits(o[3]));
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k)
      if (i0 + k < N) out[i0 + k] = o[k];
  }
}

// B3: rows [0, Vn) are narrow, rows [Vn, Vn + Vw) wide; one row a blockIdx.y
__global__ void __launch_bounds__(SCAN_THREADS)
seg_sum_kernel(const unsigned char* __restrict__ head, const int* __restrict__ narrow,
               int* __restrict__ narrow_out, int Vn, const int* __restrict__ wide,
               float* __restrict__ wide_out, long long* agg, int* agg_flag, int N, int n_tiles,
               int mode, int vec) {
  const int row = blockIdx.y;
  long long* a = agg + (size_t)row * n_tiles;
  int* af = agg_flag + (size_t)row * n_tiles;
  if (row < Vn) {
    scan_tile<SumOp>(head, narrow + (size_t)row * N, narrow_out + (size_t)row * N, a, af, N, blockIdx.x,
                     mode, vec);
  } else {
    const size_t w = (size_t)(row - Vn) * N;
    scan_tile<WideOp>(head, wide + w, wide_out + w, a, af, N, blockIdx.x, mode, vec);
  }
}

// B4: one row
__global__ void __launch_bounds__(SCAN_THREADS)
seg_min_kernel(const unsigned char* __restrict__ head, const float* __restrict__ vals,
               float* __restrict__ out, long long* agg, int* agg_flag, int N, int mode, int vec) {
  scan_tile<MinOp>(head, vals, out, agg, agg_flag, N, blockIdx.x, mode, vec);
}

static bool aligned(const void* p, uintptr_t a) { return p == nullptr || ((uintptr_t)p % a) == 0; }

// head uint8 [N] (0/1); values and outputs [V, N] row-major; agg int64 [V,
// n_tiles] and agg_flag int32 [V, n_tiles] scratch (may be null when N <=
// SCAN_TILE).  Each returns the CUDA error code of its launches: one, and
// a carry pass first for a row longer than one tile.

extern "C" int sentinel_seg_excl_cumsum(const unsigned char* head, const int* narrow,
                                        int* narrow_out, int Vn, const int* wide, float* wide_out,
                                        int Vw, long long* agg, int* agg_flag, int N, void* stream) {
  if (Vn < 0 || Vw < 0 || Vn + Vw < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (N + SCAN_TILE - 1) / SCAN_TILE;
  if (n_tiles > 1 && (agg == nullptr || agg_flag == nullptr)) return (int)cudaErrorInvalidValue;
  const int vec = N % 4 == 0 && aligned(head, 4) && aligned(narrow, 16) && aligned(narrow_out, 16) &&
                  aligned(wide, 16) && aligned(wide_out, 16);
  dim3 grid(n_tiles, Vn + Vw);
  if (n_tiles > 1) {
    seg_sum_kernel<<<grid, SCAN_THREADS, 0, s>>>(head, narrow, narrow_out, Vn, wide, wide_out, agg,
                                                 agg_flag, N, n_tiles, 0, vec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  seg_sum_kernel<<<grid, SCAN_THREADS, 0, s>>>(head, narrow, narrow_out, Vn, wide, wide_out, agg,
                                               agg_flag, N, n_tiles, 1, vec);
  return (int)cudaGetLastError();
}

extern "C" int sentinel_seg_incl_min(const unsigned char* head, const float* vals, float* out,
                                     long long* agg, int* agg_flag, int N, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (N + SCAN_TILE - 1) / SCAN_TILE;
  if (n_tiles > 1 && (agg == nullptr || agg_flag == nullptr)) return (int)cudaErrorInvalidValue;
  const int vec = N % 4 == 0 && aligned(head, 4) && aligned(vals, 16) && aligned(out, 16);
  if (n_tiles > 1) {
    seg_min_kernel<<<n_tiles, SCAN_THREADS, 0, s>>>(head, vals, out, agg, agg_flag, N, 0, vec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  seg_min_kernel<<<n_tiles, SCAN_THREADS, 0, s>>>(head, vals, out, agg, agg_flag, N, 1, vec);
  return (int)cudaGetLastError();
}

extern "C" int sentinel_seg_scan_tile() { return SCAN_TILE; }
