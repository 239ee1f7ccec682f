// fused_read_sweep: the exact SAM read (cosine top-K, softmax, weighted sum).
//
// Replaces src/repro/kernels/fused_read.py::fused_read_sweep (_sweep_kernel,
// fused_read.py:85-143, called at :180) on f32 rows, on bf16 rows (:101)
// and on int8 rows with their per-row scales (quantized=True, :102-106).
//
// Computes: q (B, H, W), mem (B, N+1, W) of which rows [0, valid_n) are
// swept, beta (B, H) -> (on the rows as f32: bf16 upcast, int8 q
// dequantized as float(q)·scale[row], before the norm)
//   idx  (B, H, K) int32: the K rows of highest cosine similarity
//        x·q / (sqrt(|x|² + 1e-6) sqrt(|q|² + 1e-6)), ordered by
//        (similarity desc, index asc) — lax.top_k's tie rule;
//   w    (B, H, K) f32: softmax of similarity·beta, renormalised as in
//        fused_read.py:70-78;
//   read (B, H, W) f32: sum_k w_k · mem[b, idx_k].
//
// What bounds it on the H100: bytes. Each call streams the swept memory
// once, B·N·W·4 bytes in f32: 1.07 GB at B = 8, N = 2^20, W = 32, about
// 0.32 ms at 3.35 TB/s; half that in bf16 (0.16 ms) and B·N·(W + 4) bytes
// in int8 with the scales (0.09 ms). The arithmetic (about 2·H·W flops per
// row) is far below the card's f32 rate.
//
// Design: the TPU grid (B·H, N/block_n) runs in order and streams each
// batch row's memory once per head. Here pass 1 runs a grid over
// (chunk of N, b): each 256-thread block stages a 256-row tile with
// coalesced 16-byte loads, all in flight at once, into shared memory (rows
// padded to W+4 floats so that thread t reading row t with 16-byte loads is
// free of bank conflicts). Each thread scores its row against all H
// normalised queries, so the memory is read once for all heads. H is a
// template parameter and the queries are laid out [w][h], so one broadcast
// 16-byte load serves four heads: the kernel issues few instructions per
// byte, which is what limited its first version. Each thread keeps a
// sorted per-head top-K list in shared memory; K rounds of a block-wide
// arg-best then write the chunk's top-K per head as (value, index)
// candidates. Splitting N into chunks fills the 132 SMs even when B·H is
// small. Pass 2 runs one small block per (b, h): it merges the chunks·K
// candidates by the same (value desc, index asc) rule, applies the softmax
// tail and gathers the K rows for the weighted sum. The two launches count
// as one kernel of the port.
//
// topk_read (topk_read_launch, f32 rows) is the same two launches with
// pass 2's tail switched off at compile time: it replaces
// src/repro/kernels/topk_read.py::topk_read (_kernel, pallas_call at
// topk_read.py:69), the tiled cosine top-K of the slot-sharded memory's
// read, and returns (vals (B, H, K) f32, idx (B, H, K) int32) over rows
// [0, valid_n) in the same (similarity desc, index asc) order. Sharing
// pass 1 gives the sharded sweep the single-device read's scores bit for
// bit, so a shard picks exactly the rows the fused read picks, near-ties
// included. Its bound is the fused read's: the bytes of the swept rows.
//
// Storage types: the row type is a template parameter (rows.cuh), and
// the one place it shows is the staging of a tile: each thread loads 16
// bytes (4 f32, 8 bf16 or 16 int8 values, the latter with their row's
// scale) and writes them as f32 into the shared tile, so the scoring, the
// per-thread top-K, the block arg-best, pass 2's merge and the tail are
// one code path. Pass 2 gathers its K rows the same way. W must be a
// multiple of the values per load: 4 (f32), 8 (bf16) or 16 (int8).
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;         // pass 1: one row per thread per tile
constexpr int kTilesPerChunk = 16;
constexpr int kChunkRows = kThreads * kTilesPerChunk;
constexpr int kMergeThreads = 128;    // pass 2
constexpr int kMaxH = 8;
constexpr int kMaxK = 8;
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Best (value desc, index asc) over the block; sv/si hold 33 slots.
__device__ void block_best(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(v, i);
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const bool have = lane < (int)(blockDim.x >> 5);
    v = have ? sv[lane] : -INFINITY;
    i = have ? si[lane] : INT_MAX;
    warp_best(v, i);
    if (lane == 0) { sv[32] = v; si[32] = i; }
  }
  __syncthreads();
  v = sv[32];
  i = si[32];
  __syncthreads();
}

// Row of load e in a tile of rows of V loads: e / V as one multiply-high,
// (2e)·magic / 2^32 with magic = ceil(2^31 / V), exact for every V >= 1
// while e < 2^31 / V (here e < kThreads·V and V <= W/4 < 64). A select
// for V = 1 instead cost the f32 pass registers, a spill and 3 % of its
// time on the H100.
__device__ __forceinline__ int row_of(int e, unsigned magic) {
  return (int)__umulhi((unsigned)e << 1, magic);
}

// Query heads padded to a multiple of 4: one float4 holds four heads.
__host__ __device__ constexpr int padded_heads(int h) {
  return (h + 3) / 4 * 4;
}

size_t pass1_smem(int H, int K, int W) {
  return sizeof(float) * ((size_t)kThreads * (W + 4)
                          + (size_t)W * padded_heads(H)
                          + 2 * (size_t)H * K * kThreads + 2 * 33);
}

template <class R, int H>
__global__ void __launch_bounds__(kThreads)
fused_read_pass1(const float* __restrict__ q,
                 const typename R::T* __restrict__ mem,
                 const float* __restrict__ scale, long long rows_per_b,
                 long long mem_stride, int valid_n, int K, int W, int chunks,
                 float* __restrict__ cand_v, int* __restrict__ cand_i) {
  constexpr int HP = padded_heads(H);
  const int P = W + 4;                             // tile row pitch, floats
  const int W4 = W / 4;
  const int V = W / R::kPer;                       // 16-byte loads per row
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);   // kThreads x P
  float* qn = tile + kThreads * P;                 // W x HP, [w][h]
  float* lv = qn + W * HP;                         // (H*K) x kThreads
  int* li = reinterpret_cast<int*>(lv + H * K * kThreads);
  float* rv = reinterpret_cast<float*>(li + H * K * kThreads);
  int* ri = reinterpret_cast<int*>(rv + 33);

  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  if (t < H) {
    const float* qh = q + ((long long)b * H + t) * W;
    float s = 0.0f;
    for (int w = 0; w < W; ++w) s = fmaf(qh[w], qh[w], s);
    const float r = rsqrtf(s + 1e-6f);
    for (int w = 0; w < W; ++w) qn[w * HP + t] = qh[w] * r;
  } else if (t < HP) {
    for (int w = 0; w < W; ++w) qn[w * HP + t] = 0.0f;
  }
  for (int e = 0; e < H * K; ++e) {
    lv[e * kThreads + t] = -INFINITY;
    li[e * kThreads + t] = INT_MAX;
  }
  float thr_v[H];
  int thr_i[H];
#pragma unroll
  for (int h = 0; h < H; ++h) { thr_v[h] = -INFINITY; thr_i[h] = INT_MAX; }

  const unsigned magic = 0x7fffffffu / (unsigned)V + 1u;
  const uint4* mb =
      reinterpret_cast<const uint4*>(mem + (long long)b * mem_stride);
  const float* sb = R::kScaled ? scale + b * rows_per_b : nullptr;
  const int chunk_end = min((c + 1) * kChunkRows, valid_n);
  for (int r0 = c * kChunkRows; r0 < chunk_end; r0 += kThreads) {
    const int rows = min(kThreads, chunk_end - r0);
    const int nf = rows * V;                       // loads in this tile
    const uint4* src = mb + (long long)r0 * V;
    __syncthreads();                               // tile free to refill
    for (int e0 = 0; e0 < nf; e0 += 8 * kThreads) {
      uint4 v[8];
      float sc[R::kScaled ? 8 : 1];   // the rows' scales (int8 only)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads + t;
        if (e < nf) {
          v[u] = __ldg(src + e);
          if constexpr (R::kScaled)
            sc[u] = __ldg(sb + r0 + row_of(e, magic));
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads + t;
        if (e < nf) {
          const int rr = row_of(e, magic);
          float s = 1.0f;
          if constexpr (R::kScaled) s = sc[u];
          R::unpack(v[u], s, tile + rr * P + R::kPer * (e - rr * V));
        }
      }
    }
    __syncthreads();
    if (t < rows) {
      const float4* mr = reinterpret_cast<const float4*>(tile + t * P);
      const float4* q4 = reinterpret_cast<const float4*>(qn);
      float ss = 0.0f;
      float dot[HP];
#pragma unroll
      for (int h = 0; h < HP; ++h) dot[h] = 0.0f;
      for (int j = 0; j < W4; ++j) {
        const float4 m4 = mr[j];
        const float m[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          ss = fmaf(m[u], m[u], ss);
#pragma unroll
          for (int g = 0; g < HP / 4; ++g) {
            const float4 qq = q4[(4 * j + u) * (HP / 4) + g];
            const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * g + e < H)
                dot[4 * g + e] = fmaf(m[u], qv[e], dot[4 * g + e]);
          }
        }
      }
      const float rn = rsqrtf(ss + 1e-6f);
      const int r = r0 + t;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float s = dot[h] * rn;
        if (!better(s, r, thr_v[h], thr_i[h])) continue;
        float* v = lv + h * K * kThreads + t;
        int* ix = li + h * K * kThreads + t;
        int p = K - 1;
        while (p > 0 && better(s, r, v[(p - 1) * kThreads],
                               ix[(p - 1) * kThreads])) {
          v[p * kThreads] = v[(p - 1) * kThreads];
          ix[p * kThreads] = ix[(p - 1) * kThreads];
          --p;
        }
        v[p * kThreads] = s;
        ix[p * kThreads] = r;
        thr_v[h] = v[(K - 1) * kThreads];
        thr_i[h] = ix[(K - 1) * kThreads];
      }
    }
  }
  __syncthreads();

  // K rounds per head: the block's best remaining list head is emitted and
  // its owner advances. Real indices are unique, so exactly one thread
  // advances unless every list is exhausted.
  for (int h = 0; h < H; ++h) {
    int p = 0;
    for (int k = 0; k < K; ++k) {
      const float hv = p < K ? lv[(h * K + p) * kThreads + t] : -INFINITY;
      const int hi = p < K ? li[(h * K + p) * kThreads + t] : INT_MAX;
      float bv = hv;
      int bi = hi;
      block_best(bv, bi, rv, ri);
      if (bi == hi && bv == hv) ++p;
      if (t == 0) {
        const long long o = (((long long)b * H + h) * chunks + c) * K + k;
        cand_v[o] = bv;
        cand_i[o] = bi;
      }
    }
  }
}

// kTail = false is topk_read: the merged (value, index) pairs are written to
// w_out and idx_out, and beta, read and the memory are not touched.
template <class R, bool kTail>
__global__ void __launch_bounds__(kMergeThreads)
fused_read_pass2(const float* __restrict__ cand_v,
                 const int* __restrict__ cand_i, int ncand,
                 const typename R::T* __restrict__ mem,
                 const float* __restrict__ scale, long long rows_per_b,
                 const float* __restrict__ beta, int H, int K, int W,
                 float* __restrict__ read, float* __restrict__ w_out,
                 int* __restrict__ idx_out) {
  __shared__ float rv[33];
  __shared__ int ri[33];
  __shared__ float sel_v[kMaxK];
  __shared__ int sel_i[kMaxK];
  __shared__ float sel_s[kMaxK];
  const int bh = blockIdx.x, b = bh / H, t = threadIdx.x;
  const float* cv = cand_v + (long long)bh * ncand;
  const int* ci = cand_i + (long long)bh * ncand;

  float tv[kMaxK];
  int ti[kMaxK];
#pragma unroll
  for (int p = 0; p < kMaxK; ++p) { tv[p] = -INFINITY; ti[p] = INT_MAX; }
  for (int c = t; c < ncand; c += kMergeThreads) {
    const float v = cv[c];
    const int i = ci[c];
#pragma unroll
    for (int p = kMaxK - 1; p >= 0; --p) {
      if (p < K && better(v, i, tv[p], ti[p])) {
        const int q = p > 0 ? p - 1 : 0;
        if (p > 0 && better(v, i, tv[q], ti[q])) { tv[p] = tv[q]; ti[p] = ti[q]; }
        else { tv[p] = v; ti[p] = i; }
      }
    }
  }
  for (int k = 0; k < K; ++k) {
    float bv = tv[0];
    int bi = ti[0];
    block_best(bv, bi, rv, ri);
    if (bi == ti[0] && bv == tv[0]) {
#pragma unroll
      for (int p = 0; p < kMaxK - 1; ++p) { tv[p] = tv[p + 1]; ti[p] = ti[p + 1]; }
      tv[kMaxK - 1] = -INFINITY;
      ti[kMaxK - 1] = INT_MAX;
    }
    if (t == 0) { sel_v[k] = bv; sel_i[k] = bi; }
  }
  __syncthreads();
  if constexpr (!kTail) {
    if (t < K) {
      w_out[(long long)bh * K + t] = sel_v[t];
      idx_out[(long long)bh * K + t] = sel_i[t];
    }
    return;
  }
  if (t == 0) {
    // Softmax tail of fused_read.py:70-78 (exact reads are all valid).
    const float bt = beta[bh];
    float mx = -INFINITY;
    for (int k = 0; k < K; ++k) mx = fmaxf(mx, sel_v[k] * bt);
    float sum = 0.0f;
    for (int k = 0; k < K; ++k) {
      sel_v[k] = expf(sel_v[k] * bt - mx);
      sum += sel_v[k];
    }
    float sum2 = 0.0f;
    for (int k = 0; k < K; ++k) {
      sel_v[k] = sel_v[k] / sum;
      sum2 += sel_v[k];
    }
    const float d = fmaxf(sum2, 1e-6f);
    for (int k = 0; k < K; ++k) {
      sel_v[k] = sel_v[k] / d;
      sel_s[k] = R::kScaled ? scale[b * rows_per_b + sel_i[k]] : 1.0f;
      w_out[(long long)bh * K + k] = sel_v[k];
      idx_out[(long long)bh * K + k] = sel_i[k];
    }
  }
  __syncthreads();
  const typename R::T* mb = mem + b * rows_per_b * W;
  for (int w = t; w < W; w += kMergeThreads) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(sel_v[k], R::at(mb + (long long)sel_i[k] * W, w, sel_s[k]),
                 acc);
    read[(long long)bh * W + w] = acc;
  }
}

template <class R, int H>
cudaError_t launch_pass1(dim3 grid, size_t smem, cudaStream_t s,
                         const float* q, const void* mem, const float* scale,
                         long long rows_per_b, int valid_n, int K, int W,
                         int chunks, float* cand_v, int* cand_i) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_read_pass1<R, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_read_pass1<R, H><<<grid, kThreads, smem, s>>>(
      q, static_cast<const typename R::T*>(mem), scale, rows_per_b,
      rows_per_b * W, valid_n, K, W, chunks, cand_v, cand_i);
  return cudaGetLastError();
}

template <class R, bool kTail>
cudaError_t launch(const float* q, const void* mem, const float* scale,
                   const float* beta, int batch, int H, int K, int W,
                   int valid_n, long long rows_per_b, float* cand_v,
                   int* cand_i, float* read, float* w_out, int* idx_out,
                   cudaStream_t s) {
  if (W % R::kPer != 0 || (R::kScaled && scale == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = pass1_smem(H, K, W);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const int chunks = (valid_n + kChunkRows - 1) / kChunkRows;
  const dim3 grid(chunks, batch);
  cudaError_t err = cudaErrorInvalidValue;
  switch (H) {
#define PASS1(h) case h: err = launch_pass1<R, h>(grid, smem, s, q, mem, \
    scale, rows_per_b, valid_n, K, W, chunks, cand_v, cand_i); break;
    PASS1(1) PASS1(2) PASS1(3) PASS1(4) PASS1(5) PASS1(6) PASS1(7) PASS1(8)
#undef PASS1
  }
  if (err != cudaSuccess) return err;
  fused_read_pass2<R, kTail><<<batch * H, kMergeThreads, 0, s>>>(
      cand_v, cand_i, chunks * K, static_cast<const typename R::T*>(mem),
      scale, rows_per_b, beta, H, K, W, read, w_out, idx_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Candidates per (b, h) that pass 1 writes (the wrapper allocates them).
int fused_read_num_candidates(int valid_n, int k) {
  return ((valid_n + kChunkRows - 1) / kChunkRows) * k;
}

// row_dtype: 0 = f32, 1 = bf16 (raw 16-bit patterns), 2 = int8 with
// scale (B, rows_per_b) f32; scale is ignored (may be null) otherwise.
int fused_read_launch(const float* q, const void* mem, const float* scale,
                      const float* beta, int batch, int H, int K, int W,
                      int valid_n, long long rows_per_b, int row_dtype,
                      float* cand_v, int* cand_i, float* read, float* w_out,
                      int* idx_out, void* stream) {
  if (H < 1 || H > kMaxH || K < 1 || K > kMaxK || W < 4 || valid_n < K
      || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (row_dtype == 0)
    err = launch<RowsF32, true>(q, mem, scale, beta, batch, H, K, W, valid_n,
                          rows_per_b, cand_v, cand_i, read, w_out, idx_out, s);
  else if (row_dtype == 1)
    err = launch<RowsBF16, true>(q, mem, scale, beta, batch, H, K, W, valid_n,
                           rows_per_b, cand_v, cand_i, read, w_out, idx_out,
                           s);
  else if (row_dtype == 2)
    err = launch<RowsI8, true>(q, mem, scale, beta, batch, H, K, W, valid_n,
                         rows_per_b, cand_v, cand_i, read, w_out, idx_out, s);
  return (int)err;
}

// topk_read: q (B, H, W), mem (B, rows_per_b, W) f32 -> vals, idx (B, H, K)
// over rows [0, valid_n); cand_v/cand_i as for fused_read_launch.
int topk_read_launch(const float* q, const float* mem, int batch, int H,
                     int K, int W, int valid_n, long long rows_per_b,
                     float* cand_v, int* cand_i, float* vals, int* idx,
                     void* stream) {
  if (H < 1 || H > kMaxH || K < 1 || K > kMaxK || W < 4 || valid_n < K
      || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch<RowsF32, false>(
      q, mem, nullptr, nullptr, batch, H, K, W, valid_n, rows_per_b, cand_v,
      cand_i, nullptr, vals, idx, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
