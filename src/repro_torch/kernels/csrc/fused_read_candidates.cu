// fused_read_candidates: the ANN (LSH) SAM read over a candidate set.
//
// Replaces src/repro/kernels/fused_read.py::fused_read_candidates (the f32
// path of _cand_kernel, fused_read.py:210-275, called at :326).
//
// Computes: q (B, H, W), mem (B, rows, W), beta (B, H), and cand (B, H, C)
// int32 *signed, pre-deduped* candidate rows (-1 = invalid) ->
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
// ids, the rows, the K rows again) and the launch set the time.
// W must be a multiple of 4, 1 <= K <= 8 and C >= K.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;         // one candidate per thread per tile
constexpr int kMaxK = 8;
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr float kInvalid = -1e9f;     // the score of an invalid candidate

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

size_t smem_bytes(int C, int W) {
  return sizeof(float) * ((size_t)kThreads * (W + 4) + W + C + 2 * kMaxK);
}

__global__ void __launch_bounds__(kThreads)
fused_read_candidates_kernel(const float* __restrict__ q,
                             const float* __restrict__ mem,
                             long long mem_stride,
                             const float* __restrict__ beta,
                             const int* __restrict__ cand, int H, int C,
                             int K, int W, float* __restrict__ read,
                             float* __restrict__ w_out,
                             int* __restrict__ idx_out) {
  extern __shared__ float4 smem4[];
  const int P = W + 4;                             // tile row pitch, floats
  const int W4 = W / 4;
  float* tile = reinterpret_cast<float*>(smem4);   // kThreads x P
  float* qn = tile + kThreads * P;                 // W
  float* score = qn + W;                           // C
  float* sel_v = score + C;                        // kMaxK
  int* sel_i = reinterpret_cast<int*>(sel_v + kMaxK);  // kMaxK

  const int bh = blockIdx.x, b = bh / H, t = threadIdx.x;
  const int* cb = cand + (long long)bh * C;
  const float* mb = mem + (long long)b * mem_stride;
  if (t == 0) {
    const float* qh = q + (long long)bh * W;
    float s = 0.0f;
    for (int w = 0; w < W; ++w) s = fmaf(qh[w], qh[w], s);
    const float r = rsqrtf(s + 1e-6f);
    for (int w = 0; w < W; ++w) qn[w] = qh[w] * r;
  }

  for (int c0 = 0; c0 < C; c0 += kThreads) {
    const int n = min(kThreads, C - c0);
    const int nf = n * W4;                         // float4s in this tile
    __syncthreads();                               // tile free, qn ready
    for (int e0 = 0; e0 < nf; e0 += 8 * kThreads) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads + t;
        if (e < nf) {
          const int cr = e / W4;
          const int row = max(cb[c0 + cr], 0);
          v[u] = __ldg(reinterpret_cast<const float4*>(
              mb + (long long)row * W) + (e - cr * W4));
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads + t;
        if (e < nf) {
          const int cr = e / W4;
          *reinterpret_cast<float4*>(tile + cr * P + 4 * (e - cr * W4)) = v[u];
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
      w_out[(long long)bh * K + k] = sel_v[k];
      idx_out[(long long)bh * K + k] = sel_i[k];
    }
  }
  __syncthreads();
  for (int w = t; w < W; w += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(sel_v[k], mb[(long long)max(sel_i[k], 0) * W + w], acc);
    read[(long long)bh * W + w] = acc;
  }
}

}  // namespace

extern "C" int fused_read_candidates_launch(
    const float* q, const float* mem, const float* beta, const int* cand,
    int batch, int H, int C, int K, int W, long long mem_stride, float* read,
    float* w_out, int* idx_out, void* stream) {
  if (H < 1 || K < 1 || K > kMaxK || C < K || W < 4 || W % 4 != 0
      || batch < 1 || (long long)batch * H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, W);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_read_candidates_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_read_candidates_kernel<<<batch * H, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      q, mem, mem_stride, beta, cand, H, C, K, W, read, w_out, idx_out);
  return (int)cudaGetLastError();
}
