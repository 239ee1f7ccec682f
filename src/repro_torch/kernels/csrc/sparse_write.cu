// sparse_write_update: the fused SAM write, in place, on f32, bf16 or int8
// memory rows.
//
// Replaces src/repro/kernels/sparse_write.py::sparse_write_update: the
// _kernel of sparse_write.py:68-87 (pallas_call at :221) on f32 and bf16
// rows, and the int8 _kernel_q of sparse_write.py:90-122 (pallas_call at
// :201), each called with the memory, the usage table (and the scales)
// aliased in and out.
//
// Computes, for each batch row b and each of the J = H·(K+1) write
// columns j (head j / (K+1)):
//   mem[b, lra_idx]    = 0                              (erase, eq. 6)
//   mem[b, write_idx] += write_w · a                    (eqs. 3/5)
//   la[b, row]         = max(la[b, row], step[b])  where a column with
//                                                   w_j > delta hits row
// mem (B, N+1, W) and la (B, N+1) int32 are updated in place. Per row
// dtype, with the plain versions' rounding (kernels/ref.py):
//   f32:  acc = acc + w_j·a, multiply and add rounded apart;
//   bf16: acc = bf16(acc + bf16(w_j·a)), the JAX oracle's bf16 scatter-add;
//   int8: acc = (erased ? 0 : float(q)·s), then acc = fma(w_j, a, acc) per
//         column (what _kernel_q computes as XLA compiles it), then one
//         re-quantization: s' = max|acc|·fl(1/127), q' = rint(acc / s')
//         clipped to ±127 (s' = 0 for a zero row, which writes q' = 0).
// Only the first column naming a row owns it (the TPU wrapper's
// first_occurrence, sparse_write.py:182-186), so the TPU kernel's parked
// lanes (sparse_write.py:98-100, 118-119) have no counterpart here. The
// owner starts from the row's old value, or zero when the row is an LRA
// row, and adds every matching column in j order, with no atomics, so the
// result is deterministic. Precondition (as for the TPU kernel): every
// lra_idx row also appears in write_idx — only written rows are erased.
// Rows outside [0, N) are ignored, so row N, the write-scratch row, is
// never touched (the sharded write sends the columns a rank does not own
// there with weight 0). bf16 rows are raw 16-bit patterns (rows.cuh).
//
// What bounds it on the H100: latency. It touches J rows per batch row
// (J·W·4 bytes of f32 rows read and written, 20 KB at B = 8, J = 20,
// W = 32), independent of N, but the rows lie anywhere in a memory of up
// to a gigabyte, so each trip to device memory is a miss, and a chain of
// dependent trips pays them one after another.
//
// Design of the f32 and bf16 write (sparse_write_kernel): one block per
// (slice of W, batch row), the slices planned by the wrapper
// (sparse_write.py::write_plan: one slice at step 21's (J, W) = (20, 32),
// four of 32 words at the LM's (36, 128)). Two dependent trips:
//   trip 1: every load that does not depend on a row, all issued at once
//           and staged in shared memory: the J indices and weights, the H
//           LRA rows, step[b] and the slice's H·words words of a;
//   (in shared memory: the columns naming the same row form a group, by
//           __match_any_sync within a warp of columns and a scan of the
//           other warps' indices across warps, as scatter_rows.cu does;
//           each group's first column owns the row, each column links to
//           the next of its group, and an owner is erased if an LRA row
//           names its row;)
//   trip 2: each owned row's pieces of the slice (16 bytes: 4 f32 or 8
//           bf16 values, one a thread; single values where W or a buffer
//           is not aligned), skipped for an erased row, and, by the
//           thread of the row's first piece in slice 0, its la cell.
// Then each piece sums its group's columns in j order from shared memory
// and is stored, and the la cell is stamped where a group column has
// w > delta. The int8 write (sparse_write_q_kernel) keeps one 32-thread
// block per (column u, b): the owner scans the earlier columns, then keeps
// its f32 row in shared memory, takes max|row| with warp shuffles (a max
// is exact in any order) and writes codes and scale once.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "rows.cuh"

namespace {

constexpr int kThreads = 32;          // the int8 write's block
constexpr int kMaxThreads = 1024;     // the f32/bf16 write's block, at most
constexpr int kPer = 4;               // pieces a thread holds at once
constexpr int kMaxColumns = 1024;     // J: 4 ints a column of shared memory
constexpr int kMaxAWords = 4096;      // H·words floats of a: 16 KB
constexpr int kOwn = 1, kErase = 2;   // a column's flags

struct WriteF32 {
  using T = float;
  static __device__ float load(T v) { return v; }
  static __device__ float add(float acc, float w, float a) {
    return __fadd_rn(acc, __fmul_rn(w, a));
  }
  static __device__ T store(float acc) { return acc; }
};

struct WriteBF16 {
  using T = uint16_t;
  static __device__ float load(T v) { return bf16_to_f32(v); }
  static __device__ float add(float acc, float w, float a) {
    const float p = bf16_to_f32(f32_to_bf16(__fmul_rn(w, a)));
    return bf16_to_f32(f32_to_bf16(__fadd_rn(acc, p)));
  }
  static __device__ T store(float acc) { return f32_to_bf16(acc); }
};

// V values of a row as one access: 16 bytes, or a single value.
template <class T, int V>
__device__ __forceinline__ void load_piece(const T* p, T (&x)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    memcpy(x, &r, 16);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = p[i];
  }
}

template <class T, int V>
__device__ __forceinline__ void store_piece(T* p, const T (&x)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 r;
    memcpy(&r, x, 16);
    *reinterpret_cast<uint4*>(p) = r;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = x[i];
  }
}

// Piece e of a block is piece e % P of column e / P, P = words / V pieces a
// column (fewer in a ragged last slice). Dynamic shared memory: a's slice
// (H x words floats), then the columns' weights, rows, next columns and
// flags (J each), the H LRA rows and step[b].
template <class R, int V>
__global__ void __launch_bounds__(kMaxThreads)
sparse_write_kernel(typename R::T* __restrict__ mem, int* __restrict__ la,
                    const int* __restrict__ widx,
                    const float* __restrict__ ww,
                    const float* __restrict__ a,
                    const int* __restrict__ lra,
                    const int* __restrict__ step, int step_stride,
                    int n_rows, int J, int H, int W, int words, float delta) {
  using T = typename R::T;
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);
  float* sw = sa + H * words;
  int* sidx = reinterpret_cast<int*>(sw + J);
  int* snext = sidx + J;
  int* sflag = snext + J;
  int* slra = sflag + J;
  int* sstep = slra + H;
  const int s = blockIdx.x, b = blockIdx.y, t = threadIdx.x, T_ = blockDim.x;
  const int lane = t & 31;
  const int w0 = s * words, ws = min(words, W - w0);   // this slice's words
  const int P = ws / V, kp1 = J / H;

  // Trip 1: nothing here depends on a row. One loop, each round's loads
  // all issued before its stores, so the loads go out together.
  const float* ab = a + (long long)b * H * W + w0;
  const int n1 = max(J, H * ws);
  for (int i = t; i < n1; i += T_) {
    const int h = i / ws;
    const int wi = i < J ? widx[(long long)b * J + i] : 0;
    const float wv = i < J ? ww[(long long)b * J + i] : 0.0f;
    const int li = i < H ? lra[(long long)b * H + i] : 0;
    const int st = i == 0 ? step[(long long)b * step_stride] : 0;
    const float av = i < H * ws ? ab[(long long)h * W + (i - h * ws)] : 0.0f;
    if (i < J) {
      sidx[i] = wi;
      sw[i] = wv;
    }
    if (i < H) slra[i] = li;
    if (i == 0) sstep[0] = st;
    if (i < H * ws) sa[h * words + (i - h * ws)] = av;
  }
  __syncthreads();

  // The groups, in shared memory. Whole warps, lane l on column base + l;
  // a skipped column (past J or out of range) matches only other skipped
  // ones, under -1, and owns nothing.
  for (int base = t - lane; base < J; base += T_) {
    const int j = base + lane;
    const int row = j < J ? sidx[j] : -1;
    const bool ok = row >= 0 && row < n_rows;
    const unsigned same = __match_any_sync(0xffffffffu, ok ? row : -1);
    if (ok) {
      const unsigned below = same & ((1u << lane) - 1u);
      const unsigned above =
          lane == 31 ? 0u : same & (0xffffffffu << (lane + 1));
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
      bool erase = false;
      for (int h = 0; h < H; ++h) erase |= slra[h] == row;
      snext[j] = next;
      sflag[j] = first ? kOwn | (erase ? kErase : 0) : 0;
    } else if (j < J) {
      sflag[j] = 0;
    }
  }
  __syncthreads();

  T* mb = mem + (long long)b * (n_rows + 1) * W + w0;
  int* lb = la + (long long)b * (n_rows + 1);
  const int E = J * P;
  for (int e0 = 0; e0 < E; e0 += kPer * T_) {
    T x[kPer][V];
    int old[kPer];
    // Trip 2: the owned pieces (not an erased row's) and the la cells.
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = e0 + k * T_ + t;
      if (e < E) {
        const int j = e / P, f = sflag[j];
        if (f & kOwn) {
          const long long row = sidx[j];
          if (!(f & kErase)) load_piece(mb + row * W + (e - j * P) * V, x[k]);
          if (s == 0 && e == j * P) old[k] = lb[row];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = e0 + k * T_ + t;
      if (e >= E) continue;
      const int j = e / P, f = sflag[j];
      if (!(f & kOwn)) continue;
      const int p = (e - j * P) * V;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[i] = (f & kErase) ? 0.0f : R::load(x[k][i]);
      bool touched = false;
      for (int u = j; u >= 0; u = snext[u]) {
        const float wu = sw[u];
        touched |= wu > delta;
        const float* au = sa + (u / kp1) * words + p;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = R::add(acc[i], wu, au[i]);
      }
      T y[V];
#pragma unroll
      for (int i = 0; i < V; ++i) y[i] = R::store(acc[i]);
      const long long row = sidx[j];
      store_piece(mb + row * W + p, y);
      if (s == 0 && e == j * P && touched) lb[row] = max(old[k], sstep[0]);
    }
  }
}

// Whether this block owns its row (first column naming it, row in
// [0, N)); *row is the row.
__device__ __forceinline__ bool owner(const int* wi, int u, int n_rows,
                                      int* row) {
  *row = wi[u];
  if (*row < 0 || *row >= n_rows) return false;
  for (int j = 0; j < u; ++j)
    if (wi[j] == *row) return false;          // an earlier column owns it
  return true;
}

__device__ __forceinline__ bool erased(const int* lra, int b, int H,
                                       int row) {
  bool e = false;
  for (int h = 0; h < H; ++h) e |= lra[(long long)b * H + h] == row;
  return e;
}

__device__ __forceinline__ void stamp(int* la, long long la_stride,
                                      const int* wi, const float* wb, int J,
                                      int b, int row, int step, float delta) {
  bool touched = false;
  for (int j = 0; j < J; ++j) touched |= (wi[j] == row) && (wb[j] > delta);
  if (touched) {
    int* cell = la + (long long)b * la_stride + row;
    *cell = max(*cell, step);
  }
}

// The int8 write; dynamic shared memory holds the owner's f32 row (W).
__global__ void __launch_bounds__(kThreads)
sparse_write_q_kernel(int8_t* __restrict__ mem, float* __restrict__ scale,
                      int* __restrict__ la, const int* __restrict__ widx,
                      const float* __restrict__ ww,
                      const float* __restrict__ a,
                      const int* __restrict__ lra,
                      const int* __restrict__ step, int step_stride,
                      int n_rows, long long mem_stride, long long la_stride,
                      int J, int H, int kp1, int W, float delta) {
  extern __shared__ float acc[];
  const int u = blockIdx.x, b = blockIdx.y;
  const int* wi = widx + (long long)b * J;
  const float* wb = ww + (long long)b * J;
  int row;
  if (!owner(wi, u, n_rows, &row)) return;
  const bool erase = erased(lra, b, H, row);
  int8_t* mrow = mem + (long long)b * mem_stride + (long long)row * W;
  float* srow = scale + (long long)b * la_stride + row;
  const float s_old = *srow;
  const float* ab = a + (long long)b * H * W;
  float amax = 0.0f;
  for (int w = threadIdx.x; w < W; w += kThreads) {
    float x = erase ? 0.0f : __fmul_rn((float)mrow[w], s_old);
    for (int j = 0; j < J; ++j)
      if (wi[j] == row) x = __fmaf_rn(wb[j], ab[(j / kp1) * W + w], x);
    acc[w] = x;
    amax = fmaxf(amax, fabsf(x));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s_new = __fmul_rn(amax, 1.0f / 127.0f);
  const float safe = s_new > 0.0f ? s_new : 1.0f;
  __syncwarp();                        // every thread read s_old above
  for (int w = threadIdx.x; w < W; w += kThreads) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(acc[w], safe)), -127.0f),
                          127.0f);
    mrow[w] = (int8_t)c;
  }
  if (threadIdx.x == 0) {
    *srow = s_new;
    stamp(la, la_stride, wi, wb, J, b, row,
          step[(long long)b * step_stride], delta);
  }
}

bool bad_shape(int batch, int W, int J, int H) {
  return batch < 1 || batch > 65535 || H < 1 || J < 1 || J % H != 0 || W < 1;
}

template <class R, int V>
cudaError_t launch(void* mem, int* la, const int* widx, const float* ww,
                   const float* a, const int* lra, const int* step,
                   int step_stride, int batch, int n_rows, int W, int J,
                   int H, float delta, int words, int threads,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)H * words + 4 * J + H + 1);
  const dim3 grid((W + words - 1) / words, batch);
  sparse_write_kernel<R, V><<<grid, threads, smem, s>>>(
      static_cast<typename R::T*>(mem), la, widx, ww, a, lra, step,
      step_stride, n_rows, J, H, W, words, delta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// row_dtype: 0 = f32, 1 = bf16 (raw 16-bit patterns). Batch row b's step
// is step[b · step_stride] (0: one step for all). The plan
// (sparse_write.py::write_plan): slices of ``words`` words of W, ``threads``
// a block, pieces of ``vec`` values (16 bytes, which needs W, ``words``
// and the buffers aligned to it, or 1).
int sparse_write_launch(void* mem, int* la, const int* widx, const float* ww,
                        const float* a, const int* lra, const int* step,
                        int step_stride, int batch, int n_rows, int W, int J,
                        int H,
                        float delta, int row_dtype, int words, int threads,
                        int vec, void* stream) {
  const int per = row_dtype == 0 ? 4 : 8;
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(mem) |
        reinterpret_cast<std::uintptr_t>(a)) & 15) == 0 &&
      W % per == 0 && words % per == 0;
  if (bad_shape(batch, W, J, H) || step_stride < 0 || J > kMaxColumns ||
      words < 1 ||
      words > W || (long long)H * words > kMaxAWords || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || row_dtype < 0 ||
      row_dtype > 1 || !(vec == 1 || (vec == per && aligned)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_dtype == 0)
    return (int)(vec == 1
        ? launch<WriteF32, 1>(mem, la, widx, ww, a, lra, step, step_stride,
                              batch, n_rows, W, J, H, delta, words, threads,
                              s)
        : launch<WriteF32, 4>(mem, la, widx, ww, a, lra, step, step_stride,
                              batch, n_rows, W, J, H, delta, words, threads,
                              s));
  return (int)(vec == 1
      ? launch<WriteBF16, 1>(mem, la, widx, ww, a, lra, step, step_stride,
                             batch, n_rows, W, J, H, delta, words, threads, s)
      : launch<WriteBF16, 8>(mem, la, widx, ww, a, lra, step, step_stride,
                             batch, n_rows, W, J, H, delta, words, threads,
                             s));
}

int sparse_write_q_launch(int8_t* mem, float* scale, int* la, const int* widx,
                          const float* ww, const float* a, const int* lra,
                          const int* step, int step_stride, int batch,
                          int n_rows, int W, int J, int H, float delta,
                          void* stream) {
  if (bad_shape(batch, W, J, H) || step_stride < 0 ||
      W > 12288)                                    // W floats of smem
    return (int)cudaErrorInvalidValue;
  sparse_write_q_kernel<<<dim3(J, batch), kThreads, W * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
      mem, scale, la, widx, ww, a, lra, step, step_stride, n_rows,
      (long long)(n_rows + 1) * W, (long long)(n_rows + 1), J, H, J / H, W,
      delta);
  return (int)cudaGetLastError();
}

}  // extern "C"
