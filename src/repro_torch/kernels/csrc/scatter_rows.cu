// scatter_rows: a row scatter into a (B, R, W) f32 buffer, in place.
//
// Replaces src/repro/kernels/scatter_rows.py::scatter_rows (the Pallas
// _scatter_unique, scatter_rows.py:85-106, with _combine_duplicates,
// scatter_rows.py:46-54, folding duplicate 'add' rows beforehand).
//
// Computes, for each batch row b and each of the J columns j:
//   'add': mem[b, idx[b, j]] += rows[b, j]
//   'set': mem[b, idx[b, j]]  = rows[b, j]
// With duplicate indices, 'add' sums every matching column into the row in
// j order, starting from the row's value; 'set' keeps the last column.
// Every index must lie in [0, R): the plain version raises on one outside,
// and the kernel, which cannot raise without waiting on the device, skips
// it rather than write out of bounds. No row that no index names is
// touched (in particular not the write-scratch row N of a (B, N+1, W)
// buffer, which the TPU kernel used as a parking row for duplicates).
//
// What bounds it on the H100: latency. It reads B·J·W·4 bytes of rows
// (20 KB at B = 8, J = 20, W = 32) and reads and writes at most as many
// bytes of memory rows, independent of R: a launch and the chain of
// dependent trips to device memory set its time.
//
// Design: one block per batch row, so that the chain is as short as it
// can be. The rows do not depend on the indices, so each thread issues
// the loads of its first pieces of rows (16-byte float4s where W % 4 == 0
// and the buffers are 16-byte aligned, one a thread at W = 128 a row to a
// warp instruction; floats otherwise) before it loads the indices into
// shared memory. Columns naming the same row form a group: within a warp
// of columns by __match_any_sync, across the warps (J > 32: 36 at the
// LM's shapes) by a scan of the other warps' indices in shared memory.
// Each row gets exactly one owner, the group's first column ('add') or
// its last ('set'), and each column the next column of its group. 'set'
// then stores its pieces (one dependent trip: the index); 'add' loads the
// memory row and adds the group's columns in j order with separately
// rounded adds (two trips), the plain version's arithmetic and the fused
// write's, so the replay of a write gives the forward's floats bit for
// bit. No atomics, so the result is deterministic.
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kPer = 4;              // pieces a thread holds at once
constexpr int kMaxThreads = 1024;
constexpr int kMaxColumns = 4096;    // 3·J ints of shared memory: 48 KB

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Piece e of batch row b is piece e % P of column e / P, P pieces (of V)
// a row.
template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
scatter_rows_kernel(float* __restrict__ mem, const int* __restrict__ idx,
                    const float* __restrict__ rows, int n_rows, int J, int P,
                    int add) {
  extern __shared__ int sh[];
  int* sidx = sh;              // the columns' rows
  int* snext = sh + J;         // the next column of the group, or -1
  int* sown = sh + 2 * J;      // whether the column writes its row
  const int b = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31;
  const int E = J * P, chunk = kPer * T;
  V* mb = reinterpret_cast<V*>(mem) + (long long)b * n_rows * P;
  const V* rb = reinterpret_cast<const V*>(rows) + (long long)b * E;

  V v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (t + k * T < E) v[k] = rb[t + k * T];
  for (int j = t; j < J; j += T) sidx[j] = idx[(long long)b * J + j];
  __syncthreads();

  // Whole warps, lane l on column base + l; a skipped column (past J or
  // out of range) matches only other skipped ones, under -1.
  for (int base = t - lane; base < J; base += T) {
    const int j = base + lane;
    const int row = j < J ? sidx[j] : -1;
    const bool ok = row >= 0 && row < n_rows;
    const unsigned same = __match_any_sync(0xffffffffu, ok ? row : -1);
    if (ok) {
      const unsigned below = same & ((1u << lane) - 1u);
      const unsigned above = lane == 31 ? 0u : same & (0xffffffffu << (lane + 1));
      int next = -1;
      if (above) {
        next = base + __ffs(above) - 1;
      } else {
        for (int u = base + 32; u < J; ++u)
          if (sidx[u] == row) {
            next = u;
            break;
          }
      }
      bool first = below == 0u;
      for (int u = 0; first && u < base; ++u) first = sidx[u] != row;
      snext[j] = next;
      sown[j] = add ? first : next < 0;
    } else if (j < J) {
      sown[j] = 0;
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < E; c0 += chunk) {
    if (c0 > 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (c0 + t + k * T < E) v[k] = rb[c0 + t + k * T];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = c0 + t + k * T;
      const int j = e / P;
      if (e < E && sown[j]) {
        V* dst = mb + (long long)sidx[j] * P + (e - j * P);
        if (add) {
          V acc = add_rn(*dst, v[k]);
          for (int u = snext[j]; u >= 0; u = snext[u])
            acc = add_rn(acc, rb[u * P + (e - j * P)]);
          *dst = acc;
        } else {
          *dst = v[k];
        }
      }
    }
  }
}

}  // namespace

// threads: enough for one piece each up to 256 threads, and for at most
// kPer pieces each up to kMaxThreads; above that the block loops.
extern "C" int scatter_rows_launch(float* mem, const int* idx,
                                   const float* rows, int batch, int n_rows,
                                   int J, int W, int add, void* stream) {
  if (batch < 1 || J < 1 || J > kMaxColumns || W < 1 || n_rows < 1 ||
      (long long)J * W > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 &&
                   ((reinterpret_cast<std::uintptr_t>(mem) |
                     reinterpret_cast<std::uintptr_t>(rows)) & 15) == 0;
  const int P = vec ? W / 4 : W;
  const int E = J * P;
  const int want = (E + kPer - 1) / kPer > 256 ? (E + kPer - 1) / kPer
                                               : (E < 256 ? E : 256);
  const int threads = std::min((want + 31) / 32 * 32, kMaxThreads);
  const size_t smem = 3 * sizeof(int) * (size_t)J;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    scatter_rows_kernel<float4><<<batch, threads, smem, s>>>(
        mem, idx, rows, n_rows, J, P, add);
  else
    scatter_rows_kernel<float><<<batch, threads, smem, s>>>(
        mem, idx, rows, n_rows, J, P, add);
  return (int)cudaGetLastError();
}
