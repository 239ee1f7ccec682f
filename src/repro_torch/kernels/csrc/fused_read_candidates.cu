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
// What bounds it on the H100: launch latency. One call reads B·H·C rows,
// B·H·C·W·4 bytes (606 KB at B = 8, H = 4, C = 148, W = 32, 0.18 µs at
// 3.35 TB/s), whatever N is.
//
// Design: the Pallas grid (B·H, C) walks the candidates in order, carrying
// a running top-K in VMEM scratch. Here one 256-thread block per (b, h)
// stages up to 256 candidate rows at a time into shared memory with
// 16-byte loads, all in flight at once (an invalid id loads row 0, as the
// clamped block map of the TPU kernel does), and thread c scores candidate
// c against the normalised query. The C scores stay in shared memory, and
// each thread ranks its candidate by counting the candidates that beat it
// under (value desc, position asc), stopping at K: the ranks are distinct,
// so the ones below K are the selection, in order, after one pass and one
// barrier. Thread 0 runs the softmax tail and the threads along W take
// the weighted sum of the K rows. A first version with 128 threads and K
// rounds of a block-wide arg-best took about as long, 16.7 against 18.0 µs
// per launch (PERF.md): the three dependent trips to device memory (the
// ids, the rows, the K rows again) and the launch set the time. The row
// storage type is a template parameter that shows only where a row is
// staged or gathered: one 16-byte load holds 4 f32, 8 bf16 or 16 int8
// values, written as f32 into the tile (int8 times the row's scale).
// W must be a multiple of those 4, 8 or 16; 1 <= K <= 8 and C >= K.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;         // one candidate per thread per tile
constexpr int kMaxK = 8;
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr float kInvalid = -1e9f;     // the score of an invalid candidate

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

size_t smem_bytes(int C, int W) {
  return sizeof(float) * ((size_t)kThreads * (W + 4) + W + C + 3 * kMaxK);
}

template <class R>
__global__ void __launch_bounds__(kThreads)
fused_read_candidates_kernel(const float* __restrict__ q,
                             const typename R::T* __restrict__ mem,
                             const float* __restrict__ scale,
                             long long rows_per_b,
                             const float* __restrict__ beta,
                             const int* __restrict__ cand, int H, int C,
                             int K, int W, float* __restrict__ read,
                             float* __restrict__ w_out,
                             int* __restrict__ idx_out) {
  extern __shared__ float4 smem4[];
  const int P = W + 4;                             // tile row pitch, floats
  const int W4 = W / 4;
  const int V = W / R::kPer;                       // 16-byte loads per row
  float* tile = reinterpret_cast<float*>(smem4);   // kThreads x P
  float* qn = tile + kThreads * P;                 // W
  float* score = qn + W;                           // C
  float* sel_v = score + C;                        // kMaxK
  int* sel_i = reinterpret_cast<int*>(sel_v + kMaxK);  // kMaxK
  float* sel_s = reinterpret_cast<float*>(sel_i + kMaxK);  // kMaxK

  const int bh = blockIdx.x, b = bh / H, t = threadIdx.x;
  const int* cb = cand + (long long)bh * C;
  const typename R::T* mb = mem + b * rows_per_b * W;
  const float* sb = R::kScaled ? scale + b * rows_per_b : nullptr;
  if (t == 0) {
    const float* qh = q + (long long)bh * W;
    float s = 0.0f;
    for (int w = 0; w < W; ++w) s = fmaf(qh[w], qh[w], s);
    const float r = rsqrtf(s + 1e-6f);
    for (int w = 0; w < W; ++w) qn[w] = qh[w] * r;
  }

  for (int c0 = 0; c0 < C; c0 += kThreads) {
    const int n = min(kThreads, C - c0);
    const int nf = n * V;                          // loads in this tile
    __syncthreads();                               // tile free, qn ready
    for (int e0 = 0; e0 < nf; e0 += 8 * kThreads) {
      uint4 v[8];
      float sc[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads + t;
        if (e < nf) {
          const int cr = e / V;
          const int row = max(cb[c0 + cr], 0);
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              mb + (long long)row * W) + (e - cr * V));
          sc[u] = R::kScaled ? __ldg(sb + row) : 1.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads + t;
        if (e < nf) {
          const int cr = e / V;
          R::unpack(v[u], sc[u], tile + cr * P + R::kPer * (e - cr * V));
        }
      }
    }
    __syncthreads();
    if (t < n) {
      const float4* xr = reinterpret_cast<const float4*>(tile + t * P);
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
      score[c0 + t] = cb[c0 + t] < 0 ? kInvalid : dot * rsqrtf(ss + 1e-6f);
    }
  }
  __syncthreads();

  // Rank each candidate among all C; the ranks below K are the selection.
  // (A NaN score, beaten by nothing, could share a rank: the slots start
  // as invalid selections, so every slot holds one.)
  if (t < K) {
    sel_v[t] = kInvalid;
    sel_i[t] = -1;
  }
  __syncthreads();
  for (int c = t; c < C; c += kThreads) {
    const float v = score[c];
    int rank = 0;
    for (int o = 0; o < C && rank < K; ++o) rank += better(score[o], o, v, c);
    if (rank < K) {
      sel_v[rank] = v;
      sel_i[rank] = cb[c];
    }
  }
  __syncthreads();

  if (t == 0) {
    // Softmax tail of fused_read.py:70-78 with the validity mask.
    const float bt = beta[bh];
    float mx = -INFINITY;
    for (int k = 0; k < K; ++k) {
      sel_v[k] = sel_i[k] >= 0 ? sel_v[k] * bt : kInvalid;
      mx = fmaxf(mx, sel_v[k]);
    }
    float sum = 0.0f;
    for (int k = 0; k < K; ++k) {
      sel_v[k] = expf(sel_v[k] - mx);
      sum += sel_v[k];
    }
    float sum2 = 0.0f;
    for (int k = 0; k < K; ++k) {
      sel_v[k] = sel_i[k] >= 0 ? sel_v[k] / sum : 0.0f;
      sum2 += sel_v[k];
    }
    const float d = fmaxf(sum2, 1e-6f);
    for (int k = 0; k < K; ++k) {
      sel_v[k] = sel_v[k] / d;
      sel_s[k] = R::kScaled ? sb[max(sel_i[k], 0)] : 1.0f;
      w_out[(long long)bh * K + k] = sel_v[k];
      idx_out[(long long)bh * K + k] = sel_i[k];
    }
  }
  __syncthreads();
  for (int w = t; w < W; w += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(sel_v[k],
                 R::at(mb + (long long)max(sel_i[k], 0) * W, w, sel_s[k]),
                 acc);
    read[(long long)bh * W + w] = acc;
  }
}

template <class R>
cudaError_t launch(const float* q, const void* mem, const float* scale,
                   long long rows_per_b, const float* beta, const int* cand,
                   int batch, int H, int C, int K, int W, float* read,
                   float* w_out, int* idx_out, cudaStream_t s) {
  if (W % R::kPer != 0 || (R::kScaled && scale == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, W);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_read_candidates_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_read_candidates_kernel<R><<<batch * H, kThreads, smem, s>>>(
      q, static_cast<const typename R::T*>(mem), scale, rows_per_b, beta,
      cand, H, C, K, W, read, w_out, idx_out);
  return cudaGetLastError();
}

}  // namespace

// row_dtype: 0 = f32, 1 = bf16 (raw 16-bit patterns), 2 = int8 with
// scale (B, rows_per_b) f32; scale is ignored (may be null) otherwise.
extern "C" int fused_read_candidates_launch(
    const float* q, const void* mem, const float* scale, const float* beta,
    const int* cand, int batch, int H, int C, int K, int W,
    long long rows_per_b, int row_dtype, float* read, float* w_out,
    int* idx_out, void* stream) {
  if (H < 1 || K < 1 || K > kMaxK || C < K || W < 4
      || batch < 1 || (long long)batch * H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (row_dtype == 0)
    err = launch<RowsF32>(q, mem, scale, rows_per_b, beta, cand, batch, H, C,
                          K, W, read, w_out, idx_out, s);
  else if (row_dtype == 1)
    err = launch<RowsBF16>(q, mem, scale, rows_per_b, beta, cand, batch, H,
                           C, K, W, read, w_out, idx_out, s);
  else if (row_dtype == 2)
    err = launch<RowsI8>(q, mem, scale, rows_per_b, beta, cand, batch, H, C,
                         K, W, read, w_out, idx_out, s);
  return (int)err;
}
