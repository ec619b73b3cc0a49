// Effect-phase scatter and flow-check gather kernels for Hopper (sm_90a).
//
// scatter_many replaces the Pallas kernel sentinel_tpu/ops/fused.py
// scatter_many (pl.pallas_call at fused.py:320); gather_many replaces
// sentinel_tpu/ops/fused.py gather_many (pl.pallas_call at fused.py:462).
// The Python wrappers and the plain PyTorch versions of both live in
// sentinel_tpu_torch/ops/fused.py; this file has a plain C interface and
// is loaded with ctypes (no PyTorch headers, so it builds in seconds).
//
// scatter_many — many scatter-add histograms in one launch.
//   What bounds it: bytes.  At the engine's shapes (N = 2,048 items, a
//   262,144-row stat table, P = 3 planes) the work is ~30 K integer adds
//   against ~7 MB of output tables that must be zeroed, written and
//   converted: the output traffic, not arithmetic, sets the floor.  The
//   TPU kernel built one-hot factors and bf16 digit-plane matmuls because
//   the TPU has no fast random scatter; Hopper has native integer atomics
//   in L2 and in shared memory, so each (item, row-vector, plane) is ONE
//   atomicAdd of the digit-truncated value.  Integer atomics make the sums
//   exact and independent of order (the TPU needed f32 digit planes for
//   that).  Tables small enough for shared memory (circuit-breaker
//   columns, probe flags, per-rule slots) are privatized per block and
//   flushed with one atomic per nonzero cell, which keeps hot rule slots
//   from serializing on one global address.  The int32 sums are converted
//   to float32 in place at the end (the reference's output dtype).
//   Launch shape: blockIdx.y = one row-vector ("unit") of one job;
//   blockIdx.x strides over items.  Each unit carries its own rows and
//   values pointers, so the wrapper stacks nothing.  The unit descriptors
//   travel as a kernel parameter (constant bank): no descriptor upload,
//   no host sync.  A job list with more than MAX_UNITS units (the
//   parameter bank's room) takes one launch per chunk of units, all
//   summing into the same zeroed output before the one conversion pass.
//
// gather_many — per-item reads from small-P int tables.
//   What bounds it: bytes (N x P reads of 4 B plus the ids).  One thread
//   per (item, plane): bounds check, read, digit mask, store float32.
//   The TPU kernel contracted one-hot rows against bf16 digit planes of
//   the whole table; here a gather reads only the rows the ids name.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXP 4
#define MAX_UNITS 48
#define MAX_GATHER_JOBS 8
#define BLOCK 256

struct Unit {
  const int* rows;     // [N] ids of this row-vector; ids outside [0, n) drop
  const int* vals;     // [P, N] value planes, plane stride N
  long long out_off;   // first output cell (int32 words) of this job's [n, P] table
  int n;               // logical table rows
  int P;               // value planes
  int priv;            // 1: accumulate in a shared-memory copy of the table
  unsigned int mask[MAXP];  // 256**digits - 1 per plane (all ones for >= 4)
};

struct ScatterParams {
  int N;
  Unit u[MAX_UNITS];
};

__global__ void scatter_many_kernel(unsigned int* __restrict__ out,
                                    const ScatterParams prm) {
  extern __shared__ unsigned int sh[];
  const Unit u = prm.u[blockIdx.y];
  const int N = prm.N;
  const int cells = u.n * u.P;
  if (u.priv) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) sh[c] = 0u;
    __syncthreads();
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += gridDim.x * blockDim.x) {
    const int k = u.rows[i];
    if (k < 0 || k >= u.n) continue;
    for (int p = 0; p < u.P; ++p) {
      const unsigned int v = (unsigned int)u.vals[(size_t)p * N + i] & u.mask[p];
      if (v == 0u) continue;
      if (u.priv) {
        atomicAdd(&sh[k * u.P + p], v);
      } else {
        atomicAdd(&out[u.out_off + (long long)k * u.P + p], v);
      }
    }
  }
  if (u.priv) {
    __syncthreads();
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const unsigned int s = sh[c];
      if (s) atomicAdd(&out[u.out_off + c], s);
    }
  }
}

// int32 sums -> float32, in place (same 4-byte cells)
__global__ void int_to_float_kernel(unsigned int* buf, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int v = (int)buf[i];
    reinterpret_cast<float*>(buf)[i] = __int2float_rn(v);
  }
}

struct GatherJob {
  const int* ids;    // [N]
  const int* table;  // [n, P] int32, row-major
  float* out;        // [N, P]
  int n;
  int P;
  unsigned int mask[MAXP];
};

struct GatherParams {
  int N;
  GatherJob j[MAX_GATHER_JOBS];
};

__global__ void gather_many_kernel(const GatherParams prm) {
  const GatherJob g = prm.j[blockIdx.y];
  const int total = prm.N * g.P;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += gridDim.x * blockDim.x) {
    const int i = t / g.P;
    const int p = t - i * g.P;
    const int id = g.ids[i];
    unsigned int v = 0u;
    if (id >= 0 && id < g.n) {
      v = (unsigned int)g.table[(size_t)id * g.P + p] & g.mask[p];
    }
    g.out[t] = __int2float_rn((int)v);
  }
}

static int grid_for(long long work, int cap) {
  long long g = (work + BLOCK - 1) / BLOCK;
  if (g < 1) g = 1;
  if (g > cap) g = cap;
  return (int)g;
}

// Both entry points take descriptors of 7 eight-byte slots each: three
// pointers (scatter: rows, values, output offset; gather: ids, table,
// out), then 8 int32 words — (n, P, priv, unused, mask[MAXP]) for scatter,
// (n, P, mask[MAXP], unused, unused) for gather.
// Each returns the CUDA error code of its launches (0 = success).

// out: out_len int32 words; zeroed here, summed, converted to float32.
extern "C" int sentinel_scatter_many(const long long* units, int n_units, int N,
                                     unsigned int* out, long long out_len,
                                     void* stream) {
  if (n_units < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)out_len * 4, s);
  if (e != cudaSuccess) return (int)e;
  for (int base = 0; base < n_units; base += MAX_UNITS) {
    const int m = n_units - base < MAX_UNITS ? n_units - base : MAX_UNITS;
    ScatterParams prm;
    prm.N = N;
    int smem = 0;
    for (int u = 0; u < m; ++u) {
      const long long* d = units + (size_t)(base + u) * 7;
      const int* w = (const int*)(d + 3);
      Unit& x = prm.u[u];
      x.rows = (const int*)d[0];
      x.vals = (const int*)d[1];
      x.out_off = d[2];
      x.n = w[0];
      x.P = w[1];
      x.priv = w[2];
      for (int p = 0; p < MAXP; ++p) x.mask[p] = (unsigned int)w[4 + p];
      if (x.priv && 4 * x.n * x.P > smem) smem = 4 * x.n * x.P;
    }
    dim3 grid(grid_for(N, 64), m);
    scatter_many_kernel<<<grid, BLOCK, smem, s>>>(out, prm);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int_to_float_kernel<<<grid_for(out_len, 1024), BLOCK, 0, s>>>(out, out_len);
  return (int)cudaGetLastError();
}

extern "C" int sentinel_gather_many(const long long* jobs, int n_jobs, int N,
                                    void* stream) {
  if (n_jobs < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int base = 0; base < n_jobs; base += MAX_GATHER_JOBS) {
    const int m = n_jobs - base < MAX_GATHER_JOBS ? n_jobs - base : MAX_GATHER_JOBS;
    GatherParams prm;
    prm.N = N;
    int pmax = 1;
    for (int j = 0; j < m; ++j) {
      const long long* d = jobs + (size_t)(base + j) * 7;
      const int* w = (const int*)(d + 3);
      GatherJob& g = prm.j[j];
      g.ids = (const int*)d[0];
      g.table = (const int*)d[1];
      g.out = (float*)d[2];
      g.n = w[0];
      g.P = w[1];
      for (int p = 0; p < MAXP; ++p) g.mask[p] = (unsigned int)w[2 + p];
      if (g.P > pmax) pmax = g.P;
    }
    dim3 grid(grid_for((long long)N * pmax, 1024), m);
    gather_many_kernel<<<grid, BLOCK, 0, s>>>(prm);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
