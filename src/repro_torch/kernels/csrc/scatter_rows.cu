// scatter_rows: a row scatter into a (B, R, W) buffer of f32 or bf16 rows,
// or of int8 rows with their (B, R) f32 scales, in place.
//
// Replaces src/repro/kernels/scatter_rows.py::scatter_rows (the Pallas
// _scatter_unique, scatter_rows.py:85-106, with _combine_duplicates,
// scatter_rows.py:46-54, folding duplicate 'add' rows beforehand), on the
// memory's dtype as the Pallas kernel takes it (it casts the rows to it,
// scatter_rows.py:69), and the int8 (row, scale) restore that the JAX
// package runs through its oracle ref.scatter_rows_q_ref.
//
// Computes, for each batch row b and each of the J columns j:
//   'add': mem[b, idx[b, j]] += rows[b, j]
//   'set': mem[b, idx[b, j]]  = rows[b, j]
// With duplicate indices, 'add' sums every matching column into the row in
// j order, starting from the row's value; 'set' keeps the last column.
// On bf16 rows each add rounds to bf16 (ref.scatter_rows_ref's rounding,
// the JAX oracle's; the Pallas kernel folds duplicates with a bf16 einsum
// first and may differ where they meet). On int8 rows only 'set' exists:
// the last column's codes and its scale, rows_scale[b, j], go to the row
// and mem_scale[b, row] together. Every index must lie in [0, R): the
// plain version raises on one outside, and the kernel, which cannot raise
// without waiting on the device, skips it rather than write out of
// bounds. No row that no index names is touched (in particular not the
// write-scratch row N of a (B, N+1, W) buffer, which the TPU kernel used
// as a parking row for duplicates).
//
// What bounds it on the H100: latency. It reads B·J·W values of rows
// (20 KB at B = 8, J = 20, W = 32, f32) and reads and writes at most as
// many of memory rows, independent of R: a launch and the chain of
// dependent trips to device memory set its time.
//
// Design: one block per batch row, so that the chain is as short as it
// can be. The rows do not depend on the indices, so each thread issues
// the loads of its first pieces of rows (16 bytes: 4 floats, 8 bf16 or 16
// int8 codes where a row is a whole number of them and the buffers are
// 16-byte aligned; single values otherwise) before it loads the indices
// into shared memory. Columns naming the same row form a group: within a
// warp of columns by __match_any_sync, across the warps (J > 32: 36 at the
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

#include "rows.cuh"

namespace {

constexpr int kPer = 4;              // pieces a thread holds at once
constexpr int kMaxThreads = 1024;
constexpr int kMaxColumns = 4096;    // 3·J ints of shared memory: 48 KB

// The pieces a thread moves: V is one piece, add() the 'add' of two
// pieces, rounded as the plain version rounds (kAdd: whether 'add' exists).
struct F32x4 {
  using V = float4;
  static constexpr int kValues = 4;
  static constexpr bool kAdd = true;
  static __device__ __forceinline__ V add(V a, V b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
};

struct F32x1 {
  using V = float;
  static constexpr int kValues = 1;
  static constexpr bool kAdd = true;
  static __device__ __forceinline__ V add(V a, V b) { return __fadd_rn(a, b); }
};

__device__ __forceinline__ uint16_t bf16_add(uint16_t a, uint16_t b) {
  return f32_to_bf16(__fadd_rn(bf16_to_f32(a), bf16_to_f32(b)));
}

__device__ __forceinline__ unsigned bf16x2_add(unsigned a, unsigned b) {
  return (unsigned)bf16_add((uint16_t)a, (uint16_t)b) |
         ((unsigned)bf16_add((uint16_t)(a >> 16), (uint16_t)(b >> 16)) << 16);
}

struct BF16x8 {                       // raw bf16 bit patterns, 16 bytes
  using V = uint4;
  static constexpr int kValues = 8;
  static constexpr bool kAdd = true;
  static __device__ __forceinline__ V add(V a, V b) {
    return make_uint4(bf16x2_add(a.x, b.x), bf16x2_add(a.y, b.y),
                      bf16x2_add(a.z, b.z), bf16x2_add(a.w, b.w));
  }
};

struct BF16x1 {
  using V = uint16_t;
  static constexpr int kValues = 1;
  static constexpr bool kAdd = true;
  static __device__ __forceinline__ V add(V a, V b) { return bf16_add(a, b); }
};

struct I8x16 {                        // int8 codes, 'set' only
  using V = uint4;
  static constexpr int kValues = 16;
  static constexpr bool kAdd = false;
};

struct I8x1 {
  using V = int8_t;
  static constexpr int kValues = 1;
  static constexpr bool kAdd = false;
};

// Piece e of batch row b is piece e % P of column e / P, P pieces (of
// Piece::V) a row. mem_scale and rows_scale are the int8 rows' scales
// (null for float rows).
template <typename Piece>
__global__ void __launch_bounds__(kMaxThreads)
scatter_rows_kernel(void* __restrict__ mem_, const int* __restrict__ idx,
                    const void* __restrict__ rows_, int n_rows, int J, int P,
                    int add, float* __restrict__ mem_scale,
                    const float* __restrict__ rows_scale) {
  using V = typename Piece::V;
  extern __shared__ int sh[];
  int* sidx = sh;              // the columns' rows
  int* snext = sh + J;         // the next column of the group, or -1
  int* sown = sh + 2 * J;      // whether the column writes its row
  const int b = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31;
  const int E = J * P, chunk = kPer * T;
  V* mb = reinterpret_cast<V*>(mem_) + (long long)b * n_rows * P;
  const V* rb = reinterpret_cast<const V*>(rows_) + (long long)b * E;

  V v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (t + k * T < E) v[k] = rb[t + k * T];
  const float s0 = mem_scale != nullptr && t < J ? rows_scale[(long long)b * J + t]
                                                 : 0.0f;
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

  if (mem_scale != nullptr)
    for (int j = t; j < J; j += T)
      if (sown[j])
        mem_scale[(long long)b * n_rows + sidx[j]] =
            j == t ? s0 : rows_scale[(long long)b * J + j];

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
        if constexpr (Piece::kAdd) {
          if (add) {
            V acc = Piece::add(*dst, v[k]);
            for (int u = snext[j]; u >= 0; u = snext[u])
              acc = Piece::add(acc, rb[u * P + (e - j * P)]);
            *dst = acc;
            continue;
          }
        }
        *dst = v[k];
      }
    }
  }
}

// threads: enough for one piece each up to 256 threads, and for at most
// kPer pieces each up to kMaxThreads; above that the block loops. Vec
// pieces where a row is a whole number of 16 bytes and both buffers are
// 16-byte aligned, One pieces (single values) otherwise.
template <typename Vec, typename One>
int launch(void* mem, const int* idx, const void* rows, int batch,
           int n_rows, int J, int W, int add, float* mem_scale,
           const float* rows_scale, void* stream) {
  if (batch < 1 || J < 1 || J > kMaxColumns || W < 1 || n_rows < 1 ||
      (long long)J * W > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const bool vec = W % Vec::kValues == 0 &&
                   ((reinterpret_cast<std::uintptr_t>(mem) |
                     reinterpret_cast<std::uintptr_t>(rows)) & 15) == 0;
  const int P = vec ? W / Vec::kValues : W;
  const int E = J * P;
  const int want = (E + kPer - 1) / kPer > 256 ? (E + kPer - 1) / kPer
                                               : (E < 256 ? E : 256);
  const int threads = std::min((want + 31) / 32 * 32, kMaxThreads);
  const size_t smem = 3 * sizeof(int) * (size_t)J;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    scatter_rows_kernel<Vec><<<batch, threads, smem, s>>>(
        mem, idx, rows, n_rows, J, P, add, mem_scale, rows_scale);
  else
    scatter_rows_kernel<One><<<batch, threads, smem, s>>>(
        mem, idx, rows, n_rows, J, P, add, mem_scale, rows_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 rows, 'add' (add = 1) or 'set'.
extern "C" int scatter_rows_launch(float* mem, const int* idx,
                                   const float* rows, int batch, int n_rows,
                                   int J, int W, int add, void* stream) {
  return launch<F32x4, F32x1>(mem, idx, rows, batch, n_rows, J, W, add,
                              nullptr, nullptr, stream);
}

// bf16 rows (raw bit patterns), 'add' (add = 1) or 'set'.
extern "C" int scatter_rows_bf16_launch(uint16_t* mem, const int* idx,
                                        const uint16_t* rows, int batch,
                                        int n_rows, int J, int W, int add,
                                        void* stream) {
  return launch<BF16x8, BF16x1>(mem, idx, rows, batch, n_rows, J, W, add,
                                nullptr, nullptr, stream);
}

// int8 rows and their (B, R) f32 scales, 'set' of recorded (row, scale)
// pairs: rows (B, J, W) int8, rows_scale (B, J).
extern "C" int scatter_rows_q_launch(int8_t* mem, float* mem_scale,
                                     const int* idx, const int8_t* rows,
                                     const float* rows_scale, int batch,
                                     int n_rows, int J, int W, void* stream) {
  if (mem_scale == nullptr || rows_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch<I8x16, I8x1>(mem, idx, rows, batch, n_rows, J, W, 0,
                             mem_scale, rows_scale, stream);
}
