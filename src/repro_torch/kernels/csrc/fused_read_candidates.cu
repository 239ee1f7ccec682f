// fused_read_candidates: the ANN (LSH) SAM read over a candidate set.
//
// Replaces src/repro/kernels/fused_read.py::fused_read_candidates
// (_cand_kernel, fused_read.py:210-275, called at :326) on f32 rows, bf16
// rows and int8 rows with their per-row scales (:229-234).
//
// Computes: q (B, H, W), mem (B, rows, W), beta (B, H), and cand (B, H, C)
// int32 *signed, pre-deduped* candidate rows (-1 = invalid) -> (on the
// rows as f32: bf16 upcast, int8 dequantized as float(q)·scale[id] with
// the scale of the clamped id, fused_read.py:302-308)
//   idx  (B, H, K) int32: the K candidates of highest cosine similarity
//        x·q / (sqrt(|x|² + 1e-6) sqrt(|q|² + 1e-6)), an invalid one scored
//        -1e9, ordered by (similarity desc, position in C asc) — lax.top_k's
//        tie rule; signed: a -1 is selected only when fewer than K
//        candidates are valid;
//   w    (B, H, K) f32: softmax of similarity·beta over the valid entries,
//        invalid ones exactly 0, renormalised (fused_read.py:70-78);
//   read (B, H, W) f32: sum_k w_k · mem[b, max(idx_k, 0)].
//
// What bounds it on the H100: latency. One call reads B·H·C rows,
// B·H·C·W·4 bytes (606 KB at B = 8, H = 4, C = 148, W = 32, 0.18 µs at
// 3.35 TB/s), whatever N is, but the rows can be read only once their ids
// are known: two dependent trips to device memory and the launch set the
// time.
//
// Design: the Pallas grid (B·H, C) walks the candidates in order, carrying
// a running top-K in VMEM scratch, and keeps the candidate rows in VMEM
// (rows_s). Here one block per (b, h), its size and tile planned by the
// wrapper (fused_read_candidates.py::cand_plan: a tile of up to 256 rows,
// the whole candidate set at C = 148, 160 threads there), in two dependent
// trips:
//   trip 1: the C ids and q into shared memory, and beta;
//   trip 2: the tile's candidate rows, 16-byte loads all in flight at once
//           (an invalid id loads row 0, as the clamped block map of the
//           TPU kernel does), written into the tile as f32 (int8 times the
//           row's scale, loaded with the row); while they are in flight,
//           warp 0 takes |q|² with shuffles and normalises q.
// Thread c scores candidate c from the tile and keeps one order-preserving
// 64-bit key, (similarity, then the position reversed): a larger key is a
// better candidate, and each comparison is one compare. Each warp sorts
// its 32 keys with a bitonic network of shuffles and keeps its K best;
// warp 0 then ranks the warps' lists, each lane counting the keys that
// beat its own, and the key beaten by r is selection r. Lanes 0..K-1 of
// warp 0 run the masked softmax with shuffles and take the weighted sum
// of the K rows from the tile. Only
// when C exceeds the tile (C > 256 at W = 32) does that sum read the K
// rows from device memory again, a third trip. The row storage type is a template parameter that
// shows only where a row is staged or gathered: one 16-byte load holds 4
// f32, 8 bf16 or 16 int8 values. W must be a multiple of those 4, 8 or
// 16; 1 <= K <= 8 and K <= C.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "rows.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kLoads = 8;             // 16-byte loads a thread has in flight
constexpr int kMaxK = 8;
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr int kDefaultSmem = 49152;   // bytes a block may use unasked
constexpr int kMaxDevices = 64;
constexpr float kInvalid = -1e9f;     // the score of an invalid candidate
constexpr unsigned kFull = 0xffffffffu;

using Key = unsigned long long;

// (value desc, position asc) as one unsigned order: the float's bits made
// monotone in the high word (+0 for -0, so the two tie as in the plain
// sort), the position reversed in the low word. No key is 0.
__device__ __forceinline__ Key make_key(float v, int pos) {
  unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((Key)u << 32) | (0xffffffffu - (unsigned)pos);
}

__device__ __forceinline__ float key_value(Key key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_pos(Key key) {
  return (int)(0xffffffffu - (unsigned)key);
}

// x sorted descending over the warp (a bitonic network of shuffles): lane
// k returns the k-th largest of the 32 lanes' values.
__device__ __forceinline__ Key warp_sort_desc(Key x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const Key y = __shfl_xor_sync(kFull, x, j);
      const bool keep_max = ((lane & j) == 0) == ((lane & k) == 0);
      x = keep_max ? (x > y ? x : y) : (x < y ? x : y);
    }
  }
  return x;
}

// q (W floats in shared memory) times rsqrt(|q|² + 1e-6), in place, by
// one warp: |q|² with shuffles.
__device__ __forceinline__ void normalise_q(float* qn, int W, int lane) {
  float s = 0.0f;
  for (int w = lane; w < W; w += 32) s = fmaf(qn[w], qn[w], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  const float r = rsqrtf(s + 1e-6f);
  for (int w = lane; w < W; w += 32) qn[w] *= r;
}

__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Dynamic shared memory (sizes in smem_bytes): the tile (tile x W + 4
// floats), q, normalised in place (W), the warps' lists (K keys a warp a
// tile), the selection (K keys) and the ids (C).
template <class R>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_read_candidates_kernel(const float* __restrict__ q,
                             const typename R::T* __restrict__ mem,
                             const float* __restrict__ scale,
                             long long rows_per_b,
                             const float* __restrict__ beta,
                             const int* __restrict__ cand, int H, int C,
                             int K, int W, int tile,
                             float* __restrict__ read,
                             float* __restrict__ w_out,
                             int* __restrict__ idx_out) {
  extern __shared__ float4 smem4[];
  const int P = W + 4;                             // tile row pitch, floats
  const int W4 = W / 4;
  const int V = W / R::kPer;                       // 16-byte loads per row
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int warps = blockDim.x >> 5;
  float* rows = reinterpret_cast<float*>(smem4);
  float* qn = rows + tile * P;
  Key* lists = reinterpret_cast<Key*>(qn + W);
  const int n_lists = (C + tile - 1) / tile * warps * K;
  Key* sel = lists + n_lists;
  int* sid = reinterpret_cast<int*>(sel + K);

  const int bh = blockIdx.x, b = bh / H;
  const int* cb = cand + (long long)bh * C;
  const typename R::T* mb = mem + b * rows_per_b * W;
  const float* sb = R::kScaled ? scale + b * rows_per_b : nullptr;

  // Trip 1: the ids, q and beta; one loop, each round's loads all issued
  // before its stores, so the loads go out together.
  const float bt = warp == 0 ? beta[bh] : 0.0f;
  for (int i = t; i < max(C, W); i += blockDim.x) {
    const int id = i < C ? cb[i] : 0;
    const float qv = i < W ? q[(long long)bh * W + i] : 0.0f;
    if (i < C) sid[i] = id;
    if (i < W) qn[i] = qv;
  }
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += tile) {
    const int n = min(tile, C - c0);
    const int nf = n * V;                          // loads in this tile
    if (c0 > 0) __syncthreads();                   // the last tile is scored
    // Trip 2: the tile's rows.
    for (int e0 = 0; e0 < nf; e0 += kLoads * blockDim.x) {
      uint4 v[kLoads];
      float sc[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * blockDim.x + t;
        if (e < nf) {
          const int cr = e / V;
          const int row = max(sid[c0 + cr], 0);
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              mb + (long long)row * W) + (e - cr * V));
          sc[u] = R::kScaled ? __ldg(sb + row) : 1.0f;
        }
      }
      if (c0 == 0 && e0 == 0 && warp == 0) normalise_q(qn, W, lane);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * blockDim.x + t;
        if (e < nf) {
          const int cr = e / V;
          R::unpack(v[u], sc[u], rows + cr * P + R::kPer * (e - cr * V));
        }
      }
    }
    __syncthreads();
    Key key = 0;                                   // 0: no candidate
    if (t < n) {                                   // the plan: threads >= tile
      const float4* xr = reinterpret_cast<const float4*>(rows + t * P);
      const float4* q4 = reinterpret_cast<const float4*>(qn);
      float dot = 0.0f, ss = 0.0f;
      for (int j = 0; j < W4; ++j) {
        const float4 m = xr[j], qq = q4[j];
        dot = fmaf(m.x, qq.x, dot);
        dot = fmaf(m.y, qq.y, dot);
        dot = fmaf(m.z, qq.z, dot);
        dot = fmaf(m.w, qq.w, dot);
        ss = fmaf(m.x, m.x, ss);
        ss = fmaf(m.y, m.y, ss);
        ss = fmaf(m.z, m.z, ss);
        ss = fmaf(m.w, m.w, ss);
      }
      const float v = sid[c0 + t] < 0 ? kInvalid : dot * rsqrtf(ss + 1e-6f);
      key = make_key(v, c0 + t);
    }
    // Each warp's K best keys of this tile, lane k the k-th.
    key = warp_sort_desc(key, lane);
    if (lane < K) lists[(c0 / tile * warps + warp) * K + lane] = key;
  }
  __syncthreads();
  if (warp != 0) return;

  // Warp 0 merges the lists: the key that r others beat is selection r
  // (the keys are distinct; 0, no candidate, is never selected).
  for (int i = lane; i < n_lists; i += 32) {
    const Key mine = lists[i];
    int rank = 0;
#pragma unroll 4
    for (int o = 0; o < n_lists; ++o) rank += lists[o] > mine;
    if (mine != 0 && rank < K) sel[rank] = mine;
  }
  __syncwarp();
  const Key key = lane < K ? sel[lane] : 0;

  // The masked softmax on lanes 0..K-1 (fused_read.py:70-78).
  const bool mine = lane < K;
  const int pos = mine ? key_pos(key) : 0;
  const int id = mine ? sid[pos] : -1;
  const bool valid = id >= 0;
  const float val = mine ? (valid ? key_value(key) * bt : kInvalid)
                         : -INFINITY;
  const float mx = group8_max(val);
  const float e = mine ? expf(val - mx) : 0.0f;
  const float sum = group8_sum(e);
  float wk = valid ? e / sum : 0.0f;
  wk = wk / fmaxf(group8_sum(wk), 1e-6f);
  if (mine) {
    w_out[(long long)bh * K + lane] = wk;
    idx_out[(long long)bh * K + lane] = id;
  }

  // The read: sum_k w_k · row_k, from the tile when it holds every
  // candidate, else from device memory. The loops are uniform over the
  // warp, so every lane takes part in each shuffle.
  const bool one_tile = C <= tile;
  const int at = one_tile ? pos : max(id, 0);      // tile row, or memory row
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float wsel = __shfl_sync(kFull, wk, k);
      const int r = __shfl_sync(kFull, at, k);
      if (w < W) {
        const float x = one_tile
            ? rows[r * P + w]
            : R::at(mb + (long long)r * W, w,
                    R::kScaled ? __ldg(sb + r) : 1.0f);
        acc = fmaf(wsel, x, acc);
      }
    }
    if (w < W) read[(long long)bh * W + w] = acc;
  }
}

size_t smem_bytes(int C, int W, int K, int tile, int threads) {
  const size_t lists = (size_t)((C + tile - 1) / tile) * (threads / 32) * K;
  return sizeof(float) * ((size_t)tile * (W + 4) + W + C)
         + sizeof(Key) * (lists + K);
}

// Lets the kernel take more than 48 KB of shared memory, once per device
// (the launch itself asks for what it uses).
template <class R>
cudaError_t allow_smem(size_t smem) {
  static bool allowed[kMaxDevices] = {};
  if (smem <= (size_t)kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fused_read_candidates_kernel<R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices)
    allowed[dev] = true;
  return err;
}

template <class R>
cudaError_t launch(const float* q, const void* mem, const float* scale,
                   long long rows_per_b, const float* beta, const int* cand,
                   int batch, int H, int C, int K, int W, int tile,
                   int threads, float* read, float* w_out, int* idx_out,
                   cudaStream_t s) {
  if (W % R::kPer != 0 || (R::kScaled && scale == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, W, K, tile, threads);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<R>(smem);
  if (err != cudaSuccess) return err;
  fused_read_candidates_kernel<R><<<batch * H, threads, smem, s>>>(
      q, static_cast<const typename R::T*>(mem), scale, rows_per_b, beta,
      cand, H, C, K, W, tile, read, w_out, idx_out);
  return cudaGetLastError();
}

}  // namespace

// row_dtype: 0 = f32, 1 = bf16 (raw 16-bit patterns), 2 = int8 with
// scale (B, rows_per_b) f32; scale is ignored (may be null) otherwise.
// The plan (fused_read_candidates.py::cand_plan): ``tile`` rows staged at
// a time, ``threads`` a block (a multiple of 32, at least the tile).
extern "C" int fused_read_candidates_launch(
    const float* q, const void* mem, const float* scale, const float* beta,
    const int* cand, int batch, int H, int C, int K, int W,
    long long rows_per_b, int row_dtype, int tile, int threads, float* read,
    float* w_out, int* idx_out, void* stream) {
  if (H < 1 || K < 1 || K > kMaxK || C < K || W < 4 || batch < 1 ||
      (long long)batch * H > INT_MAX || tile < 1 || tile > C ||
      threads < tile || threads % 32 != 0 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (row_dtype == 0)
    err = launch<RowsF32>(q, mem, scale, rows_per_b, beta, cand, batch, H, C,
                          K, W, tile, threads, read, w_out, idx_out, s);
  else if (row_dtype == 1)
    err = launch<RowsBF16>(q, mem, scale, rows_per_b, beta, cand, batch, H,
                           C, K, W, tile, threads, read, w_out, idx_out, s);
  else if (row_dtype == 2)
    err = launch<RowsI8>(q, mem, scale, rows_per_b, beta, cand, batch, H, C,
                         K, W, tile, threads, read, w_out, idx_out, s);
  return (int)err;
}
