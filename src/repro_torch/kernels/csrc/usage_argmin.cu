// The least-used rows of a usage table: SAM's LRA selection (the n least
// recently accessed slots) and DAM's least-used slot (the argmin).
//
// Replaces src/repro/kernels/usage_argmin.py:
// - lra_topn (_topn_kernel, usage_argmin.py:71-83, tiles merged by lexsort
//   at :109-111): last_access (B, rows) int32, swept over [0, valid_n) ->
//   (B, n) int32 indices, ascending by (value, index);
// - usage_argmin (_kernel, usage_argmin.py:26-44): usage (B, rows) f32,
//   swept over [0, valid_n) -> (B,) int32 index of the minimum, the lowest
//   index on ties, -0.0 equal to +0.0. A NaN is not handled (DAM's usage
//   is a sum of softmax weights and finite).
//
// What bounds it on the H100: bytes. It reads the table once (B·N·4 bytes:
// 33.6 MB at B = 8, N = 2^20, about 10 us at 3.35 TB/s) and does a few
// integer compares per entry.
//
// Design: each entry becomes one int64 key value·2^32 + index, where an
// int32 value is itself and an f32 value is mapped to an int32 of the same
// signed order (`ordered`). Values can be negative (the -arange(N) stagger
// of SAM's table), and signed int64 order of the key is exactly (value,
// index) order, so the tie rule needs no extra compare and every key is
// unique. Pass 1: a grid over (chunk of N, b); each thread keeps its n
// smallest keys in registers (loads issued four at a time to keep bytes in
// flight), then n rounds of a block-wide min pick the chunk's n smallest.
// Pass 2: one block per b merges the chunks·n candidates the same way. The
// TPU kernels' sequential grid has no counterpart: blocks run in parallel
// and meet only in pass 2. The argmin is the same two passes with n = 1.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 8;
constexpr int kChunk = 8192;         // table entries per pass-1 block
constexpr long long kNone = LLONG_MAX;

// An int32 usage value orders as itself.
__device__ __forceinline__ int ordered(int v) { return v; }

// An f32 value as an int32 whose signed order is the float order. -0.0
// becomes +0.0 first (x + 0.0 rounds -0.0 to +0.0), so the two compare
// equal and the lower index wins; then a negative float's magnitude bits
// are flipped, so that a larger magnitude orders lower.
__device__ __forceinline__ int ordered(float v) {
  const int bits = __float_as_int(__fadd_rn(v, 0.0f));
  return bits < 0 ? bits ^ 0x7fffffff : bits;
}

__device__ __forceinline__ long long make_key(int value, int index) {
  return (long long)value * 4294967296LL + (long long)index;
}

// Insert `key` into the ascending register list top[0..n).
__device__ __forceinline__ void insert(long long (&top)[kMaxN], int n,
                                       long long key) {
#pragma unroll
  for (int p = kMaxN - 1; p >= 0; --p) {
    if (p < n && key < top[p]) {
      const long long prev = top[p > 0 ? p - 1 : 0];
      top[p] = (p > 0 && key < prev) ? prev : key;
    }
  }
}

__device__ __forceinline__ void pop(long long (&top)[kMaxN]) {
#pragma unroll
  for (int p = 0; p < kMaxN - 1; ++p) top[p] = top[p + 1];
  top[kMaxN - 1] = kNone;
}

__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long other = __shfl_xor_sync(0xffffffffu, v, o);
    v = other < v ? other : v;
  }
  return v;
}

// Minimum over the block; sh holds 33 slots.
__device__ long long block_min(long long v, long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? sh[lane] : kNone;
    v = warp_min(v);
    if (lane == 0) sh[32] = v;
  }
  __syncthreads();
  const long long r = sh[32];
  __syncthreads();
  return r;
}

// n rounds: the block's smallest remaining head is emitted and popped.
__device__ void merge_out(long long (&top)[kMaxN], int n, long long* sh,
                          long long* out_keys, int* out_idx) {
  for (int r = 0; r < n; ++r) {
    const long long best = block_min(top[0], sh);
    if (top[0] == best) pop(top);     // keys are unique (or all kNone)
    if (threadIdx.x == 0) {
      if (out_keys) out_keys[r] = best;
      if (out_idx) out_idx[r] = (int)(best & 0xffffffffLL);
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
smallest_pass1(const V* __restrict__ table, long long row_stride,
               int valid_n, int n, int chunks, long long* __restrict__ cand) {
  __shared__ long long sh[33];
  const int b = blockIdx.y, c = blockIdx.x, t = threadIdx.x;
  const V* row = table + (long long)b * row_stride;
  long long top[kMaxN];
#pragma unroll
  for (int p = 0; p < kMaxN; ++p) top[p] = kNone;
  const int start = c * kChunk;
  const int end = min(start + kChunk, valid_n);
  for (int base = start; base < end; base += 4 * kThreads) {
    V v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kThreads + t;
      v[u] = i < end ? row[i] : V(0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kThreads + t;
      if (i < end) insert(top, n, make_key(ordered(v[u]), i));
    }
  }
  merge_out(top, n, sh, cand + ((long long)b * chunks + c) * n, nullptr);
}

__global__ void __launch_bounds__(kThreads)
smallest_pass2(const long long* __restrict__ cand, int ncand, int n,
               int* __restrict__ out) {
  __shared__ long long sh[33];
  const int b = blockIdx.x;
  const long long* mine = cand + (long long)b * ncand;
  long long top[kMaxN];
#pragma unroll
  for (int p = 0; p < kMaxN; ++p) top[p] = kNone;
  for (int i = threadIdx.x; i < ncand; i += kThreads) insert(top, n, mine[i]);
  merge_out(top, n, sh, nullptr, out + (long long)b * n);
}

// Both passes over a (batch, row_stride) table; out is (batch, n).
template <typename V>
int launch_smallest(const V* table, long long row_stride, int batch,
                    int valid_n, int n, long long* cand, int* out,
                    void* stream) {
  if (n < 1 || n > kMaxN || valid_n < n || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int chunks = (valid_n + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  smallest_pass1<V><<<dim3(chunks, batch), kThreads, 0, s>>>(
      table, row_stride, valid_n, n, chunks, cand);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smallest_pass2<<<batch, kThreads, 0, s>>>(cand, chunks * n, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int64 candidates per batch row that pass 1 writes (the wrapper
// allocates the scratch buffer).
int smallest_candidates(int valid_n, int n) {
  return ((valid_n + kChunk - 1) / kChunk) * n;
}

int lra_topn_launch(const int* la, long long row_stride, int batch,
                    int valid_n, int n, long long* cand, int* out,
                    void* stream) {
  return launch_smallest(la, row_stride, batch, valid_n, n, cand, out, stream);
}

int usage_argmin_launch(const float* usage, long long row_stride, int batch,
                        int valid_n, long long* cand, int* out, void* stream) {
  return launch_smallest(usage, row_stride, batch, valid_n, 1, cand, out,
                         stream);
}

}  // extern "C"
