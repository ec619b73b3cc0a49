// Measurement-probe kernels for Hopper (sm_90a): a copy and three
// atomics-based histograms.
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
// The Python wrappers and the plain PyTorch versions live in
// sentinel_tpu_torch/probes/kernels.py; this file has a plain C interface
// and is loaded with ctypes.
//
// What bounds them: bytes.  probe_copy reads and writes 4 B an item.  The
// histograms read 4 B an id plus 4 B a value plane an item and write (and
// first zero) the whole padded output; at the stat-landing shape (393,216
// items into 16,640 rows, 5 planes) that is 8.3 MB against 2 M adds.  The
// TPU kernels built one-hot factors and contracted them on the matrix unit
// because the TPU has no fast random scatter, and carried the output in
// VMEM across a sequential grid; their tile sizes (TB, n_tile, chunk), the
// one-hot factor width n_lo, the grid step count and its "parallel" flag
// are that tiling.  Hopper has float atomics in L2: each (item, plane) is
// ONE atomicAdd into the output, which a memset zeroes first (the Pallas
// kernels zero at grid step 0, so the zeroing is part of the work).  n_lo
// survives only as the padded output shape [n_hi, n_lo], in which row k
// lies at flat cell k; the grid step count becomes the number of blocks of
// probe_copy, and the tile size becomes items_per_block.
//
// Exactness: the sums are of integer-valued data and stay below 2^24, so
// float32 addition is exact and independent of the order the atomics land
// in: every kernel equals its plain version bit for bit.
//
// Deliberately simple: no shared-memory privatised sub-histograms, no warp
// aggregation of hot rows.  ids outside [0, n) drop.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 256

__global__ void probe_copy_kernel(const unsigned int* __restrict__ x,
                                  unsigned int* __restrict__ y, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    y[i] = x[i] + 1u;  // wraps like int32 addition
  }
}

// Every histogram block takes the items [blockIdx.x * ipb, + ipb).

__global__ void probe_hist_count_kernel(const int* __restrict__ ids, long long N,
                                        int n, float* __restrict__ out, int ipb) {
  const long long lo = (long long)blockIdx.x * ipb;
  const long long hi = lo + ipb < N ? lo + ipb : N;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int k = ids[i];
    if (k < 0 || k >= n) continue;
    atomicAdd(&out[k], 1.0f);
  }
}

// values [N, P] row-major.  plane_stride == 0: out[k * P + p] (an [n, P]
// table); otherwise out[p * plane_stride + k] (planes-major, padded rows).
template <typename T>
__global__ void probe_hist_planes_kernel(const int* __restrict__ ids,
                                         const T* __restrict__ vals, long long N,
                                         int P, int n, float* __restrict__ out,
                                         long long plane_stride, int ipb) {
  const long long lo = (long long)blockIdx.x * ipb;
  const long long hi = lo + ipb < N ? lo + ipb : N;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int k = ids[i];
    if (k < 0 || k >= n) continue;
    for (int p = 0; p < P; ++p) {
      const float v = (float)vals[i * P + p];
      if (v == 0.0f) continue;
      const long long cell = plane_stride ? p * plane_stride + k : (long long)k * P + p;
      atomicAdd(&out[cell], v);
    }
  }
}

// Five planes: cnts[:, 0..2], rt & 0xFF, (rt >> 8) & 0xFF.
__global__ void probe_hist_stat5_kernel(const int* __restrict__ ids,
                                        const int* __restrict__ cnts,
                                        const int* __restrict__ rt, long long N,
                                        int n, float* __restrict__ out,
                                        long long plane_stride, int ipb) {
  const long long lo = (long long)blockIdx.x * ipb;
  const long long hi = lo + ipb < N ? lo + ipb : N;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int k = ids[i];
    if (k < 0 || k >= n) continue;
    const int r = rt[i];
    const int v[5] = {cnts[i * 3], cnts[i * 3 + 1], cnts[i * 3 + 2], r & 0xFF,
                      (r >> 8) & 0xFF};
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      if (v[p] == 0) continue;
      atomicAdd(&out[p * plane_stride + k], (float)v[p]);
    }
  }
}

// Each entry point returns the CUDA error code of its calls (0 = success).

// blocks <= 0: one thread an item (as many blocks as that takes).
extern "C" int sentinel_probe_copy(const void* x, void* y, long long n, int blocks,
                                   void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  long long g = blocks > 0 ? blocks : (n + BLOCK - 1) / BLOCK;
  if (g > 2147483647LL) return (int)cudaErrorInvalidValue;
  probe_copy_kernel<<<(unsigned int)g, BLOCK, 0, (cudaStream_t)stream>>>(
      (const unsigned int*)x, (unsigned int*)y, n);
  return (int)cudaGetLastError();
}

// Zero out[out_len]; the grid for N items at ipb items a block (0 blocks
// when N == 0), or -1 for arguments no launch can take.
static long long zero_and_grid(float* out, long long out_len, long long N, int ipb,
                               cudaStream_t s, cudaError_t* e) {
  if (N < 0 || ipb < 1 || out_len < 0) {
    *e = cudaErrorInvalidValue;
    return -1;
  }
  *e = cudaMemsetAsync(out, 0, (size_t)out_len * 4, s);
  if (*e != cudaSuccess) return -1;
  const long long g = (N + ipb - 1) / ipb;
  if (g > 2147483647LL) {
    *e = cudaErrorInvalidValue;
    return -1;
  }
  return g;
}

// out: out_len >= n float32 cells ([n_hi, n_lo] flat).
extern "C" int sentinel_probe_hist_count(const void* ids, long long N, int n,
                                         void* out, long long out_len,
                                         int items_per_block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (out_len < n) return (int)cudaErrorInvalidValue;
  const long long g = zero_and_grid((float*)out, out_len, N, items_per_block, s, &e);
  if (g < 0) return (int)e;
  if (g == 0) return (int)cudaSuccess;
  probe_hist_count_kernel<<<(unsigned int)g, BLOCK, 0, s>>>(
      (const int*)ids, N, n, (float*)out, items_per_block);
  return (int)cudaGetLastError();
}

// vals: [N, P] float32 (vals_float != 0) or int32.  plane_stride == 0: out is
// [n, P]; otherwise out is [P, plane_stride] with plane_stride >= n.
extern "C" int sentinel_probe_hist_planes(const void* ids, const void* vals,
                                          int vals_float, long long N, int P, int n,
                                          void* out, long long out_len,
                                          long long plane_stride,
                                          int items_per_block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (P < 1 || plane_stride < 0 || (plane_stride && plane_stride < n) ||
      out_len < (plane_stride ? plane_stride * P : (long long)n * P)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long g = zero_and_grid((float*)out, out_len, N, items_per_block, s, &e);
  if (g < 0) return (int)e;
  if (g == 0) return (int)cudaSuccess;
  if (vals_float) {
    probe_hist_planes_kernel<float><<<(unsigned int)g, BLOCK, 0, s>>>(
        (const int*)ids, (const float*)vals, N, P, n, (float*)out, plane_stride,
        items_per_block);
  } else {
    probe_hist_planes_kernel<int><<<(unsigned int)g, BLOCK, 0, s>>>(
        (const int*)ids, (const int*)vals, N, P, n, (float*)out, plane_stride,
        items_per_block);
  }
  return (int)cudaGetLastError();
}

// cnts: [N, 3] int32; rt: [N] int32; out: [5, plane_stride], plane_stride >= n.
extern "C" int sentinel_probe_hist_stat5(const void* ids, const void* cnts,
                                         const void* rt, long long N, int n,
                                         void* out, long long plane_stride,
                                         int items_per_block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (plane_stride < n) return (int)cudaErrorInvalidValue;
  const long long g =
      zero_and_grid((float*)out, 5 * plane_stride, N, items_per_block, s, &e);
  if (g < 0) return (int)e;
  if (g == 0) return (int)cudaSuccess;
  probe_hist_stat5_kernel<<<(unsigned int)g, BLOCK, 0, s>>>(
      (const int*)ids, (const int*)cnts, (const int*)rt, N, n, (float*)out,
      plane_stride, items_per_block);
  return (int)cudaGetLastError();
}
