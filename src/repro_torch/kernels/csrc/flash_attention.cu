// Causal GQA attention, forward: o = softmax(q·kᵀ·D^-0.5, causal) · v.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (_kernel,
// flash_attention.py:27-61, pallas_call at :94): q (B, S, H, D) and k, v
// (B, S, Hkv, D), f32 or bf16, -> o (B, S, H, D) in q's dtype. Query head
// h reads kv head h / (H / Hkv) (:89-92). Scores are f32, masked to -1e30
// where pos_q < pos_k; an online softmax (running max, running sum, an f32
// accumulator rescaled by exp(m_prev - m_new)) takes the keys tile by tile,
// p·v is f32, and the row is divided by max(l, 1e-20) at the end.
//
// What bounds it on the H100: operations. The causal half of the S×S
// scores takes S(S+1)/2 · B · H · 4D flop (2.06e11 at B = 4, S = 2048,
// H = 48, D = 128: 3.08 ms at 67 TFLOP/s), against 436 MB of q, k, v and o
// at f32 (0.13 ms at 3.35 TB/s). f32 inputs must not go through TF32, whose
// 10-bit mantissa cannot hold the JAX suite's 2e-5; so every product here
// is an f32 FMA on the CUDA cores, and bf16 inputs are upcast as they are
// loaded (exactly) and take the same path. The card's bound for bf16
// inputs is lower: their q·kᵀ products are exact on the bf16 tensor cores
// with f32 sums (half the flop at 989 TFLOP/s), and only p·v, with p in
// f32 as the TPU kernel keeps it, needs the f32 rate: 1.64 ms at these
// shapes. This design does not reach for it; mma.sync for q·kᵀ would.
//
// Design: one block of 256 threads per (b·h, tile of 64 query rows),
// the heaviest tiles (the last rows, which see the most keys) first. The
// TPU kernel's sequential kv grid becomes a loop inside the block over the
// key tiles 0 .. the diagonal, the causal skip of its `pl.when`. The q
// tile, one k or v tile and the 64×64 tile of probabilities sit in shared
// memory as f32 (88 KB at D = 128, so two blocks share an SM). Each thread
// owns 4 query rows (ty + 16i) and, for the scores, 4 keys (tx + 16j): a
// register tile of 16 scores, 64 FMAs per 8 16-byte shared loads; for the
// output, 4 rows × D/16 columns of the accumulator, with the row's running
// max and sum, in registers. The 16 threads that share a row reduce its
// max and sum with warp shuffles. Rows and keys past S are zero on load
// and never stored, so any S works: the causal mask alone hides a ragged
// tile's padded keys from every real row.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 × 16: tx = key / column, ty = row
constexpr int kLDP = kBK + 16;   // padded row of the probability tile
constexpr float kNeg = -1e30f;   // the TPU kernel's mask value

template <int D>
struct Tile {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int LD = D + 4;                  // padded q/k/v row
  static constexpr int CW = D >= 64 ? 4 : D / 16;   // output columns a load
  static constexpr int NG = D / (16 * CW);          // loads a row
  static constexpr int SMEM = (2 * kBQ * LD + kBQ * kLDP) * 4;
};

// 16 bytes of the input as f32: four f32 values, or eight bf16 values
// (a bf16 is the high half of the f32 with the same bits).
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load16(const unsigned short* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// f32 -> bf16, round to nearest even (NaN stays a quiet NaN), as PyTorch's
// cast does.
__device__ __forceinline__ void store(unsigned short* p, float x) {
  const unsigned int u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    *p = (unsigned short)((u >> 16) | 0x40u);
    return;
  }
  *p = (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// Rows [0, 64) of a (·, row_stride) input from `src` into the f32 tile
// `dst` (row stride LD); rows at or past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int valid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = D / V;
  for (int e = threadIdx.x; e < kBQ * PER_ROW; e += kThreads) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * V;
    float x[V];
    if (r < valid) {
      load16(src + r * row_stride + c, x);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(dst + r * Tile<D>::LD + c + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
}

// Max and sum over the 16 lanes that share a row (a half warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hkv, float scale) {
  using Sh = Tile<D>;
  constexpr int LD = Sh::LD, CW = Sh::CW, NG = Sh::NG;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][LD]
  float* KVs = Qs + kBQ * LD;          // [kBK][LD], k then v
  float* Ps = KVs + kBK * LD;          // [kBQ][kLDP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int iq = gridDim.x - 1 - blockIdx.x;          // heaviest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const T* q_rows = q + ((long long)b * S * H + h) * D;
  const T* k_rows = k + ((long long)b * S * Hkv + hk) * D;
  const T* v_rows = v + ((long long)b * S * Hkv + hk) * D;
  const int q0 = iq * kBQ;

  load_tile<T, D>(Qs, q_rows + q0 * q_stride, q_stride, S - q0);

  float m[4], l[4], acc[4][NG][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][g][c] = 0.0f;
  }

  for (int kt = 0; kt <= iq; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // the last tile's p·v is done
    load_tile<T, D>(KVs, k_rows + k0 * kv_stride, kv_stride, S - k0);
    __syncthreads();

    // Scores: rows ty + 16i against keys tx + 16j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Online softmax of each row over this tile.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = kt < iq || tx + 16 * j <= row;
        s[i][j] = keep ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[row * kLDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][g][c] *= corr;
    }
    __syncthreads();                 // every read of k is done, p is whole
    load_tile<T, D>(KVs, v_rows + k0 * kv_stride, kv_stride, S - k0);
    __syncthreads();

    // acc[row, col] += p[row, key] · v[key, col] for columns
    // g·16·CW + tx·CW + c.
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kLDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[NG][CW];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* src = KVs + (j + jj) * LD + g * 16 * CW + tx * CW;
          if constexpr (CW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            vv[g][0] = x.x; vv[g][1] = x.y; vv[g][2] = x.z; vv[g][3] = x.w;
          } else if constexpr (CW == 2) {
            const float2 x = *reinterpret_cast<const float2*>(src);
            vv[g][0] = x.x; vv[g][1] = x.y;
          } else {
            vv[g][0] = src[0];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int c = 0; c < CW; ++c)
              acc[i][g][c] = fmaf(p, vv[g][c], acc[i][g][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* dst = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < CW; ++c)
        store(dst + g * 16 * CW + tx * CW + c, acc[i][g][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, Tile<D>::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int Hkv, int D, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, Hkv, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, Hkv, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, Hkv, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (B, S, H, D); k, v: (B, S, Hkv, D), all contiguous and 16-byte
// aligned, of one dtype: code 0 = f32, 1 = bf16 (`_build.ROW_CODE`).
// D is 16, 32, 64 or 128, and Hkv divides H.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int Hkv, int D,
                           int dtype, float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(q, k, v, o, B, S, H, Hkv, D, scale, s);
  if (dtype == 1)
    return launch_dim<unsigned short>(q, k, v, o, B, S, H, Hkv, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
