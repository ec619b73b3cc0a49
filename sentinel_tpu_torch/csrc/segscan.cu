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

// -- seg_build: one side of the tick's segment build -------------------------
//
// B4's route on the main path.  The tick's two segment builds
// (ops/engine_seg.py prepare_completions / prepare_acquire) were ~50 and
// ~60 eager PyTorch launches a side around B4's own launch: the valid
// mask, the RT quantization, the digit split and its cumsum, the heads,
// sid, the slot scatter and one gather a payload.  Here each side is ONE
// launch for a batch of up to SCAN_TILE items (the client's 2,048), two for
// a longer one.  It writes what seg_build_plain (ops/segscan.py) gives, bit
// for bit, every slot included:
//   head [N], sid [N], n_seg, ok, seg_end [U], live [U];
//   key_u [nkeys, U]: each key at its segment's last item;
//   the completion side (succ != null) also ce [ncols, U], the digit
//   columns' inclusive cumsums at the tails, and min_rt [U], the segment's
//   RT minimum; the acquire side res_sorted (key 0 nondecreasing).
// Dead slots [n_seg, U) hold what the plain version's gathers at
// seg_end = 0 leave: seg_end 0, item 0's keys and cumsums, min_rt 3.0e38.
//
// The design: a tile of SCAN_TILE items is one block, 4 items a thread (16-
// byte loads where aligned).  A thread reads its items' keys and those of
// the items on either side, so it knows each item's head (a key changes, or
// the item sits at a multiple of 256) and tail (the next item is a head, or
// it is the last).  Segments never span a 256-item boundary, so the RT
// minimum at a tail needs nothing from another tile: a segmented min in
// registers, warp shuffles and one shared-memory round, as scan_tile does;
// that is what takes B4's launch away.  sid and the digit cumsums are plain
// prefix sums over the batch: the same warp scan and shared-memory round
// within the tile, and, for a batch longer than one tile, a first pass that
// writes each tile's head count, column sums and sortedness (agg), which
// warp 0 of every block of the second pass folds for the tiles before its
// own.  The tail item of segment s < U writes slot s of every compacted
// output; the blocks share the slots [n_seg, U) and live [U] by grid stride.
// n_seg and ok stay on the card.
//
// Exactness: integer sums wrap as int32 cumsums do; the RT planes follow
// the plain version's float steps (a NaN RT passes clamp_max, rt > 0 is
// false for it; rint of an exact product by 8 rounds half to even; the
// float -> int32 conversion saturates and reads NaN as 0, as the card's
// does), and float minima do not depend on the order of combination.
//
// What bounds it: the launch (N = 2,048 moves ~37 KB); the gain is the
// ~55 launches a side it replaces.

#define BUILD_MAX_KEYS 5
#define BUILD_MAX_COLS 12
#define SEG_BLOCK 256  // segments never span a multiple of it (ops/segment.py BLOCK)
#define RT_ABSENT 3.0e38f

struct BuildArgs {
  const int* key[BUILD_MAX_KEYS];
  int nkeys;
  unsigned key_vec;  // bit j: key j may be read 16 bytes at a time
  const int* succ;   // the completion side's stat planes; null on the acquire side
  const int* err;
  const float* rt;
  unsigned stat_vec;  // bits 0-2: succ, err, rt may be read 16 bytes at a time
  int trash_row;
  float rt_max;
  int ncols;
  int col_plane[BUILD_MAX_COLS];  // 0 success, 1 error, 2 rt_q
  int col_shift[BUILD_MAX_COLS];  // the digit's shift, or -1 for the plane as it is
  int N, U, n_tiles;
  unsigned char* head;
  int* sid;
  int* n_seg;
  unsigned char* ok;
  int* seg_end;
  unsigned char* live;
  int* key_u;
  int* ce;
  float* min_rt;
  unsigned char* res_sorted;
  int* agg;  // [n_tiles, ncols + 2]: heads, column sums, unsorted
};

__device__ __forceinline__ void load4(const int* __restrict__ p, int i0, int N, bool vec, int v[4]) {
  if (vec && i0 + 3 < N) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p + i0));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i0 + k < N ? __ldg(p + i0 + k) : 0;
  }
}

__device__ __forceinline__ void load4(const float* __restrict__ p, int i0, int N, bool vec, float v[4]) {
  if (vec && i0 + 3 < N) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + i0));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i0 + k < N ? __ldg(p + i0 + k) : 0.0f;
  }
}

// One item's stat planes (success, error, rt_q) and its RT-minimum input,
// by the plain version's steps.
__device__ __forceinline__ void stat_planes(const BuildArgs& a, int res, int s, int e, float rt, int pv[3],
                                            float& m) {
  const bool valid = res != a.trash_row;
  const float r1 = valid ? rt : 0.0f;
  const float c = r1 > a.rt_max ? a.rt_max : r1;  // clamp_max: NaN passes
  pv[0] = valid ? s : 0;
  pv[1] = valid ? e : 0;
  pv[2] = __float2int_rz(rintf(__fmul_rn(c, 8.0f)));  // saturates; NaN -> 0
  m = valid && r1 > 0.0f ? r1 : RT_ABSENT;
}

// Digit column c of an item's planes (c a compile-time index after unrolling).
__device__ __forceinline__ int col_of(const BuildArgs& a, const int pv[3], int c) {
  const int p = a.col_plane[c];
  const int v = p == 0 ? pv[0] : p == 1 ? pv[1] : pv[2];
  const int s = a.col_shift[c];
  return s < 0 ? v : (v >> s) & 0xFF;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = wrap_add(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// mode 0: pass 1 of a multi-tile batch (the tile's aggregates into agg);
// mode 1: the build (after pass 1, or alone for one tile).
template <bool kStats>
__global__ void __launch_bounds__(SCAN_THREADS) seg_build_kernel(const BuildArgs a, int mode) {
  constexpr int MC = kStats ? BUILD_MAX_COLS : 1;
  __shared__ int s_cnt[SCAN_WARPS];
  __shared__ int s_col[MC][SCAN_WARPS];
  __shared__ float s_min[SCAN_WARPS];
  __shared__ int s_minf[SCAN_WARPS];
  __shared__ int s_carry[MC + 1];  // the earlier tiles' heads, then column sums
  __shared__ int s_total;          // heads of the whole batch
  __shared__ int s_unsorted;       // key 0 falls somewhere in the batch
  const int N = a.N;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = tile * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  const int aw = a.ncols + 2;
  const bool multi = a.n_tiles > 1;

  // 1. keys of items i0 - 1 .. i0 + 4: heads (h[k]: one starts at i0 + k),
  // and whether key 0 ever falls
  bool h[SCAN_ITEMS + 1];
#pragma unroll
  for (int k = 0; k <= SCAN_ITEMS; ++k) h[k] = ((i0 + k) & (SEG_BLOCK - 1)) == 0;
  int kv[BUILD_MAX_KEYS][SCAN_ITEMS];
  int unsorted = 0;
#pragma unroll
  for (int j = 0; j < BUILD_MAX_KEYS; ++j) {
    if (j < a.nkeys) {
      const int* __restrict__ p = a.key[j];
      load4(p, i0, N, (a.key_vec >> j) & 1u, kv[j]);
      int prev = i0 > 0 && i0 - 1 < N ? __ldg(p + i0 - 1) : 0;
      const int next = i0 + SCAN_ITEMS < N ? __ldg(p + i0 + SCAN_ITEMS) : 0;
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        h[k] = h[k] || kv[j][k] != prev;
        if (j == 0 && i0 + k > 0 && i0 + k < N && kv[j][k] < prev) unsorted = 1;
        prev = kv[j][k];
      }
      h[SCAN_ITEMS] = h[SCAN_ITEMS] || next != prev;
    }
  }
  bool hd[SCAN_ITEMS], tl[SCAN_ITEMS];
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const bool inside = i0 + k < N;
    hd[k] = inside && h[k];
    tl[k] = inside && (i0 + k + 1 >= N || h[k + 1]);
  }

  // 2. the stat planes, and the thread's aggregates: heads, column sums,
  // the segmented RT minimum (an item past the batch is a head, no effect)
  int pv[SCAN_ITEMS][3];
  float mv[SCAN_ITEMS];
  int t_cnt = 0;
  int t_col[MC];
  float t_min = RT_ABSENT;
  int t_mf = 0;
#pragma unroll
  for (int c = 0; c < MC; ++c) t_col[c] = 0;
  if constexpr (kStats) {
    int s[SCAN_ITEMS], e[SCAN_ITEMS];
    float r[SCAN_ITEMS];
    load4(a.succ, i0, N, a.stat_vec & 1u, s);
    load4(a.err, i0, N, (a.stat_vec >> 1) & 1u, e);
    load4(a.rt, i0, N, (a.stat_vec >> 2) & 1u, r);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      stat_planes(a, kv[0][k], s[k], e[k], r[k], pv[k], mv[k]);
      if (i0 + k >= N) pv[k][0] = pv[k][1] = pv[k][2] = 0;
    }
  }
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    t_cnt += hd[k];
    if constexpr (kStats) {
#pragma unroll
      for (int c = 0; c < MC; ++c)
        if (c < a.ncols) t_col[c] = wrap_add(t_col[c], col_of(a, pv[k], c));
      const int f = hd[k] || i0 + k >= N;
      t_min = f ? mv[k] : MinOp::apply(t_min, mv[k]);
      t_mf |= f;
    }
  }

  // 3. inclusive scans of the threads' aggregates inside the warp, and
  // each thread's exclusive prefix
  int w_cnt = t_cnt;
  int w_col[MC];
#pragma unroll
  for (int c = 0; c < MC; ++c) w_col[c] = t_col[c];
  float w_min = t_min;
  int w_mf = t_mf;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int oc = __shfl_up_sync(FULL, w_cnt, d);
    if (lane >= d) w_cnt += oc;
    if constexpr (kStats) {
#pragma unroll
      for (int c = 0; c < MC; ++c) {
        if (c < a.ncols) {
          const int o = __shfl_up_sync(FULL, w_col[c], d);
          if (lane >= d) w_col[c] = wrap_add(w_col[c], o);
        }
      }
      const float om = __shfl_up_sync(FULL, w_min, d);
      const int of = __shfl_up_sync(FULL, w_mf, d);
      if (lane >= d) combine<MinOp>(w_min, w_mf, om, of);
    }
  }
  if (lane == 31) {
    s_cnt[warp] = w_cnt;
#pragma unroll
    for (int c = 0; c < MC; ++c) s_col[c][warp] = w_col[c];
    s_min[warp] = w_min;
    s_minf[warp] = w_mf;
  }
  int p_cnt = __shfl_up_sync(FULL, w_cnt, 1);
  int p_col[MC];
#pragma unroll
  for (int c = 0; c < MC; ++c) p_col[c] = __shfl_up_sync(FULL, w_col[c], 1);
  float p_min = __shfl_up_sync(FULL, w_min, 1);
  int p_mf = __shfl_up_sync(FULL, w_mf, 1);
  if (lane == 0) {
    p_cnt = 0;
#pragma unroll
    for (int c = 0; c < MC; ++c) p_col[c] = 0;
    p_min = RT_ABSENT;
    p_mf = 0;
  }

  // the earlier tiles (pass 2 of a multi-tile batch): warp 0 folds pass
  // 1's aggregates, in the same shared-memory round
  if (mode == 1 && multi && warp == 0) {
    int c_cnt = 0, tot = 0, uns = 0;
    int c_col[MC];
#pragma unroll
    for (int c = 0; c < MC; ++c) c_col[c] = 0;
    for (int t = lane; t < a.n_tiles; t += 32) {
      const int* g = a.agg + (size_t)t * aw;
      const int x = g[0];
      tot += x;
      uns |= g[aw - 1];
      if (t < tile) {
        c_cnt += x;
        if constexpr (kStats) {
#pragma unroll
          for (int c = 0; c < MC; ++c)
            if (c < a.ncols) c_col[c] = wrap_add(c_col[c], g[1 + c]);
        }
      }
    }
    c_cnt = warp_sum(c_cnt);
    tot = warp_sum(tot);
    uns = __any_sync(FULL, uns != 0);
#pragma unroll
    for (int c = 0; c < MC; ++c) c_col[c] = warp_sum(c_col[c]);
    if (lane == 0) {
      s_carry[0] = c_cnt;
#pragma unroll
      for (int c = 0; c < MC; ++c) s_carry[1 + c] = c_col[c];
      s_total = tot;
      s_unsorted = uns;
    }
  }
  const int blk_unsorted = __syncthreads_or(unsorted);  // the one shared-memory round

  if (mode == 0) {  // pass 1: the tile's aggregates
    if (threadIdx.x == 0) {
      int* g = a.agg + (size_t)tile * aw;
      int cnt = 0;
      for (int w = 0; w < SCAN_WARPS; ++w) cnt += s_cnt[w];
      g[0] = cnt;
      if constexpr (kStats) {
        for (int c = 0; c < a.ncols; ++c) {
          int x = 0;
          for (int w = 0; w < SCAN_WARPS; ++w) x = wrap_add(x, s_col[c][w]);
          g[1 + c] = x;
        }
      }
      g[aw - 1] = blk_unsorted;
    }
    return;
  }

  // 4. the prefix before this thread: earlier tiles, warps, lanes
  int r_cnt = multi ? s_carry[0] : 0;
  int total = multi ? s_total : 0;
  int r_col[MC];
#pragma unroll
  for (int c = 0; c < MC; ++c) r_col[c] = multi ? s_carry[1 + c] : 0;
  float r_min = RT_ABSENT;
  int r_mf = 0;
  for (int w = 0; w < SCAN_WARPS; ++w) {
    const int x = s_cnt[w];
    if (!multi) total += x;
    if (w < warp) {
      r_cnt += x;
      if constexpr (kStats) {
#pragma unroll
        for (int c = 0; c < MC; ++c)
          if (c < a.ncols) r_col[c] = wrap_add(r_col[c], s_col[c][w]);
        float m = s_min[w];
        int f = s_minf[w];
        combine<MinOp>(m, f, r_min, r_mf);
        r_min = m;
        r_mf = f;
      }
    }
  }
  r_cnt += p_cnt;
#pragma unroll
  for (int c = 0; c < MC; ++c) r_col[c] = wrap_add(r_col[c], p_col[c]);
  combine<MinOp>(p_min, p_mf, r_min, r_mf);
  r_min = p_min;

  // 5. this thread's items: head, sid, and the tails' slots
  int sd[SCAN_ITEMS];
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    r_cnt += hd[k];
    sd[k] = r_cnt - 1;
    if constexpr (kStats) {
#pragma unroll
      for (int c = 0; c < MC; ++c)
        if (c < a.ncols) r_col[c] = wrap_add(r_col[c], col_of(a, pv[k], c));
      r_min = MinOp::apply(hd[k] ? RT_ABSENT : r_min, mv[k]);
    }
    if (tl[k] && sd[k] < a.U) {
      const int s = sd[k];
      a.seg_end[s] = i0 + k;
#pragma unroll
      for (int j = 0; j < BUILD_MAX_KEYS; ++j)
        if (j < a.nkeys) a.key_u[(size_t)j * a.U + s] = kv[j][k];
      if constexpr (kStats) {
#pragma unroll
        for (int c = 0; c < MC; ++c)
          if (c < a.ncols) a.ce[(size_t)c * a.U + s] = r_col[c];
        a.min_rt[s] = MinOp::out(r_min);
      }
    }
  }
  if (i0 + SCAN_ITEMS <= N) {  // the outputs are the wrapper's, aligned
    *reinterpret_cast<uchar4*>(a.head + i0) = make_uchar4(hd[0], hd[1], hd[2], hd[3]);
    *reinterpret_cast<int4*>(a.sid + i0) = make_int4(sd[0], sd[1], sd[2], sd[3]);
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (i0 + k < N) {
        a.head[i0 + k] = hd[k];
        a.sid[i0 + k] = sd[k];
      }
    }
  }

  // 6. the scalars, live [U], and the dead slots [n_seg, U): item 0's
  if (tile == 0 && threadIdx.x == 0) {
    *a.n_seg = total;
    *a.ok = total <= a.U;
    if (a.res_sorted != nullptr) *a.res_sorted = !(multi ? s_unsorted : blk_unsorted);
  }
  int p0[3] = {0, 0, 0};
  if constexpr (kStats) {
    if (total < a.U) {
      float m0;
      stat_planes(a, __ldg(a.key[0]), __ldg(a.succ), __ldg(a.err), __ldg(a.rt), p0, m0);
    }
  }
  for (int s = tile * SCAN_THREADS + threadIdx.x; s < a.U; s += gridDim.x * SCAN_THREADS) {
    a.live[s] = s < total;
    if (s >= total) {
      a.seg_end[s] = 0;
#pragma unroll
      for (int j = 0; j < BUILD_MAX_KEYS; ++j)
        if (j < a.nkeys) a.key_u[(size_t)j * a.U + s] = __ldg(a.key[j]);
      if constexpr (kStats) {
#pragma unroll
        for (int c = 0; c < MC; ++c)
          if (c < a.ncols) a.ce[(size_t)c * a.U + s] = col_of(a, p0, c);
        a.min_rt[s] = RT_ABSENT;
      }
    }
  }
}

// keys: nkeys (1-5) int32 [N] device pointers, in a host array; succ / err
// int32 [N] and rt float32 [N] for the completion side, all null for the
// acquire side; col_plane / col_shift: ncols (0-12) host ints, the digit
// columns of the three stat planes.  Outputs as BuildArgs says; res_sorted
// may be null; agg int32 [n_tiles, ncols + 2] scratch (null when N <=
// SCAN_TILE).  Returns the CUDA error code of its launches: one, and a
// first pass before it for a batch longer than one tile.
extern "C" int sentinel_seg_build(const void* const* keys, int nkeys, const void* succ, const void* err,
                                  const void* rt, int trash_row, float rt_max, const int* col_plane,
                                  const int* col_shift, int ncols, int N, int U, void* head, void* sid,
                                  void* n_seg, void* ok, void* seg_end, void* live, void* key_u, void* ce,
                                  void* min_rt, void* res_sorted, void* agg, void* stream) {
  const bool stats = succ != nullptr;
  if (N < 1 || U < 0 || nkeys < 1 || nkeys > BUILD_MAX_KEYS || ncols < 0 || ncols > BUILD_MAX_COLS ||
      (stats && (err == nullptr || rt == nullptr || ce == nullptr || min_rt == nullptr || ncols < 1)) ||
      head == nullptr || sid == nullptr || n_seg == nullptr || ok == nullptr ||
      (U > 0 && (seg_end == nullptr || live == nullptr || key_u == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  BuildArgs a = {};
  for (int j = 0; j < nkeys; ++j) {
    if (keys[j] == nullptr) return (int)cudaErrorInvalidValue;
    a.key[j] = (const int*)keys[j];
    a.key_vec |= (unsigned)aligned(keys[j], 16) << j;
  }
  a.nkeys = nkeys;
  if (stats) {
    a.succ = (const int*)succ;
    a.err = (const int*)err;
    a.rt = (const float*)rt;
    a.stat_vec = (unsigned)aligned(succ, 16) | (unsigned)aligned(err, 16) << 1 | (unsigned)aligned(rt, 16) << 2;
    a.ncols = ncols;
    for (int c = 0; c < ncols; ++c) {
      const int sh = col_shift[c];
      if (col_plane[c] < 0 || col_plane[c] > 2 || !(sh == -1 || sh == 0 || sh == 8 || sh == 16 || sh == 24)) {
        return (int)cudaErrorInvalidValue;
      }
      a.col_plane[c] = col_plane[c];
      a.col_shift[c] = sh;
    }
  }
  a.trash_row = trash_row;
  a.rt_max = rt_max;
  a.N = N;
  a.U = U;
  a.n_tiles = (N + SCAN_TILE - 1) / SCAN_TILE;
  if (a.n_tiles > 1 && agg == nullptr) return (int)cudaErrorInvalidValue;
  a.head = (unsigned char*)head;
  a.sid = (int*)sid;
  a.n_seg = (int*)n_seg;
  a.ok = (unsigned char*)ok;
  a.seg_end = (int*)seg_end;
  a.live = (unsigned char*)live;
  a.key_u = (int*)key_u;
  a.ce = (int*)ce;
  a.min_rt = (float*)min_rt;
  a.res_sorted = (unsigned char*)res_sorted;
  a.agg = (int*)agg;
  cudaStream_t s = (cudaStream_t)stream;
  for (int mode = a.n_tiles > 1 ? 0 : 1; mode < 2; ++mode) {
    if (stats) {
      seg_build_kernel<true><<<a.n_tiles, SCAN_THREADS, 0, s>>>(a, mode);
    } else {
      seg_build_kernel<false><<<a.n_tiles, SCAN_THREADS, 0, s>>>(a, mode);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int sentinel_seg_scan_tile() { return SCAN_TILE; }
