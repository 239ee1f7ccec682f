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
// row, and adds every matching column in j order, with no atomic adds, so
// the result is deterministic. Precondition (as for the TPU kernel): every
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
// w > delta.
//
// Design of the int8 write (sparse_write_q_kernel<V>): the same two
// trips, in one block per batch row (a row's scale needs max|row|, so a
// row is never split across blocks), ``threads`` planned by the wrapper
// (sparse_write.py::q_plan: 64 at step 21's J = 20, W = 32):
//   trip 1: the J indices and weights, the H LRA rows, step[b] and all
//           H·W words of a (where they fit beside the columns: a wider a
//           is read from device memory by the sums), every load of a
//           round issued before its stores; then the groups and flags as
//           above (group_columns);
//   trip 2: each owned, unerased row's codes in 16-byte pieces (16 codes;
//           single codes where W or the memory is not 16-byte aligned),
//           its old scale and, by the thread of its first piece, its la
//           cell, all at once.
// Each piece is dequantized (fl(q·s_old), zero for an erased row), takes
// its group's columns in j order as fmaf(w_j, a, acc) from shared memory,
// and puts max|acc| into its column's slot with a shared atomicMax on the
// bits (a max is exact in any order; |acc| >= 0 orders as its bits). After
// a barrier each piece forms s' = max·fl(1/127) and its codes
// clip(rint(acc / s'), ±127) (0 where s' = 0) and stores them; the first
// piece stores s' and stamps la.
// When a round of one piece a thread does not cover the J·W/V pieces (the
// LM's J = 36, W = 128 takes 288 threads; J = 592 at W = 128 takes more
// than the 512 a block has), the pieces go in rounds and the second pass
// loads and sums its piece again (the same arithmetic, so the same acc)
// instead of holding it.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "rows.cuh"

namespace {

constexpr int kMaxThreads = 1024;     // the f32/bf16 write's block, at most
constexpr int kMaxQThreads = 512;     // the int8 write's block, at most
constexpr int kStage = 4;             // loads a thread issues a round, trip 1
constexpr int kPer = 4;               // pieces a thread holds at once
constexpr int kMaxColumns = 1024;     // J: 4 ints a column of shared memory
constexpr int kMaxAWords = 4096;      // H·words floats of a: 16 KB
constexpr int kOwn = 1, kErase = 2;   // a column's flags
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr int kDefaultSmem = 49152;   // bytes a block may use unasked
constexpr int kMaxDevices = 64;

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

// The groups of a block's J columns, from their rows (sidx) and the H LRA
// rows (slra) in shared memory: snext[j] is the next column naming column
// j's row (-1 for none), sflag[j] kOwn for the first column naming a row in
// [0, n_rows), with kErase where an LRA row names it. Whole warps, lane l
// on column base + l, matched by __match_any_sync and a scan of the other
// warps' columns; a skipped column (past J or out of range) matches only
// other skipped ones, under -1, and owns nothing.
__device__ __forceinline__ void group_columns(const int* sidx,
                                              const int* slra, int* snext,
                                              int* sflag, int J, int H,
                                              int n_rows) {
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x - lane; base < J; base += blockDim.x) {
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

  group_columns(sidx, slra, snext, sflag, J, H, n_rows);
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

// One piece of an owned row: its V codes x (unused when erased) times
// s_old, then its group's columns from column j on, in j order, each as one
// FMA; returns whether a group column has w > delta. p: the piece's first
// word.
template <int V>
__device__ __forceinline__ bool sum_piece(float (&acc)[V],
                                          const int8_t (&x)[V], float s_old,
                                          bool erase, int j, int p,
                                          const int* snext, const float* sw,
                                          const float* sa, int W, int kp1,
                                          float delta) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    acc[i] = erase ? 0.0f : __fmul_rn((float)x[i], s_old);
  bool touched = false;
  for (int u = j; u >= 0; u = snext[u]) {
    const float wu = sw[u];
    touched |= wu > delta;
    const float* au = sa + (u / kp1) * W + p;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = __fmaf_rn(wu, au[i], acc[i]);
  }
  return touched;
}

// The int8 write: a block per batch row, piece e = column e / P's piece
// e % P (P = W / V). Dynamic shared memory: a (H x W floats, when kStageA;
// otherwise the sums read a from device memory), then the columns'
// weights, rows, next columns, flags, max|acc| bits and old scales (J
// each), the H LRA rows and step[b].
template <int V, bool kStageA>
__global__ void __launch_bounds__(kMaxQThreads)
sparse_write_q_kernel(int8_t* __restrict__ mem, float* __restrict__ scale,
                      int* __restrict__ la, const int* __restrict__ widx,
                      const float* __restrict__ ww,
                      const float* __restrict__ a,
                      const int* __restrict__ lra,
                      const int* __restrict__ step, int step_stride,
                      int n_rows, int J, int H, int W, float delta) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4) + (kStageA ? H * W : 0);
  int* sidx = reinterpret_cast<int*>(sw + J);
  int* snext = sidx + J;
  int* sflag = snext + J;
  unsigned* smax = reinterpret_cast<unsigned*>(sflag + J);
  float* sold = reinterpret_cast<float*>(smax + J);
  int* slra = reinterpret_cast<int*>(sold + J);
  int* sstep = slra + H;
  const int b = blockIdx.x, t = threadIdx.x, T_ = blockDim.x;
  const int P = W / V, kp1 = J / H, E = J * P;

  // Trip 1: nothing here depends on a row. kStage elements a thread a
  // round, every load of a round issued before its stores.
  const float* ab = a + (long long)b * H * W;
  float* sa = reinterpret_cast<float*>(smem4);
  const int n1 = max(J, kStageA ? H * W : 0);
  for (int i0 = 0; i0 < n1; i0 += kStage * T_) {
    int wi[kStage], li[kStage];
    float wv[kStage], av[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * T_ + t;
      wi[k] = i < J ? widx[(long long)b * J + i] : 0;
      wv[k] = i < J ? ww[(long long)b * J + i] : 0.0f;
      li[k] = i < H ? lra[(long long)b * H + i] : 0;
      av[k] = kStageA && i < H * W ? ab[i] : 0.0f;
    }
    const bool first = i0 == 0 && t == 0;
    const int st = first ? step[(long long)b * step_stride] : 0;
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * T_ + t;
      if (i < J) {
        sidx[i] = wi[k];
        sw[i] = wv[k];
        smax[i] = 0u;
      }
      if (i < H) slra[i] = li[k];
      if (kStageA && i < H * W) sa[i] = av[k];
    }
    if (first) sstep[0] = st;
  }
  __syncthreads();
  group_columns(sidx, slra, snext, sflag, J, H, n_rows);
  __syncthreads();

  int8_t* mb = mem + (long long)b * (n_rows + 1) * W;
  float* sb = scale + (long long)b * (n_rows + 1);
  int* lb = la + (long long)b * (n_rows + 1);
  const bool held = E <= T_;           // one round: acc stays in registers
  float acc[V];
  bool touched = false;
  int old = 0;
  // Trip 2 and the sums: each piece's max|acc| into its column's slot.
  for (int e0 = 0; e0 < E; e0 += T_) {
    const int e = e0 + t;
    const int j = e < E ? e / P : 0;
    const int f = e < E ? sflag[j] : 0;
    if (!(f & kOwn)) continue;
    const long long row = sidx[j];
    const int p = (e - j * P) * V;
    int8_t x[V] = {};
    float s_old = 0.0f;
    if (!(f & kErase)) {
      load_piece(mb + row * W + p, x);
      s_old = sb[row];
    }
    if (e == j * P) {
      old = lb[row];
      sold[j] = s_old;
    }
    touched = sum_piece(acc, x, s_old, f & kErase, j, p, snext, sw,
                        kStageA ? sa : ab, W, kp1, delta);
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(acc[i]));
    atomicMax(smax + j, __float_as_uint(amax));
  }
  __syncthreads();
  // The codes, the scale and the stamp.
  for (int e0 = 0; e0 < E; e0 += T_) {
    const int e = e0 + t;
    const int j = e < E ? e / P : 0;
    const int f = e < E ? sflag[j] : 0;
    if (!(f & kOwn)) continue;
    const long long row = sidx[j];
    const int p = (e - j * P) * V;
    if (!held) {   // this thread's piece of this round, summed again; the
      // old scale from shared memory, as the row's first piece may already
      // have stored the new one
      int8_t x[V] = {};
      if (!(f & kErase)) load_piece(mb + row * W + p, x);
      if (e == j * P) old = lb[row];
      touched = sum_piece(acc, x, sold[j], f & kErase, j, p, snext, sw,
                          kStageA ? sa : ab, W, kp1, delta);
    }
    const float s_new = __fmul_rn(__uint_as_float(smax[j]), 1.0f / 127.0f);
    const float safe = s_new > 0.0f ? s_new : 1.0f;
    int8_t y[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      y[i] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(acc[i], safe)), -127.0f),
                           127.0f);
    store_piece(mb + row * W + p, y);
    if (e == j * P) {
      sb[row] = s_new;
      if (touched) lb[row] = max(old, sstep[0]);
    }
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

// The int8 write's shared memory: six words a column, the LRA rows and the
// step, and all of a where that fits (`stage_a`).
size_t q_smem(int J, int H, int W, bool stage_a) {
  return sizeof(float) *
         ((stage_a ? (size_t)H * W : 0) + 6 * (size_t)J + H + 1);
}

// The dynamic shared-memory limit, raised once per device and
// instantiation, and only above 48 KB.
template <int V, bool kStageA>
cudaError_t allow_q_smem(size_t smem) {
  static bool allowed[kMaxDevices] = {};
  if (smem <= (size_t)kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(sparse_write_q_kernel<V, kStageA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

template <int V, bool kStageA>
cudaError_t launch_q(int8_t* mem, float* scale, int* la, const int* widx,
                     const float* ww, const float* a, const int* lra,
                     const int* step, int step_stride, int batch, int n_rows,
                     int W, int J, int H, float delta, int threads,
                     size_t smem, cudaStream_t s) {
  cudaError_t err = allow_q_smem<V, kStageA>(smem);
  if (err != cudaSuccess) return err;
  sparse_write_q_kernel<V, kStageA><<<batch, threads, smem, s>>>(
      mem, scale, la, widx, ww, a, lra, step, step_stride, n_rows, J, H, W,
      delta);
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

// The int8 write's plan (sparse_write.py::q_plan): ``threads`` a block,
// pieces of ``vec`` codes (16, which needs W and the memory 16-byte
// aligned, or 1). a goes to shared memory where it fits beside the
// columns, and is read from device memory otherwise.
int sparse_write_q_launch(int8_t* mem, float* scale, int* la, const int* widx,
                          const float* ww, const float* a, const int* lra,
                          const int* step, int step_stride, int batch,
                          int n_rows, int W, int J, int H, float delta,
                          int vec, int threads, void* stream) {
  const bool aligned =
      (reinterpret_cast<std::uintptr_t>(mem) & 15) == 0 && W % 16 == 0;
  const bool stage_a = q_smem(J, H, W, true) <= (size_t)kMaxSmem;
  const size_t smem = q_smem(J, H, W, stage_a);
  if (bad_shape(batch, W, J, H) || step_stride < 0 ||
      smem > (size_t)kMaxSmem || threads < 32 || threads > kMaxQThreads ||
      threads % 32 != 0 || !(vec == 1 || (vec == 16 && aligned)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = stage_a
      ? (vec == 1 ? launch_q<1, true> : launch_q<16, true>)
      : (vec == 1 ? launch_q<1, false> : launch_q<16, false>);
  return (int)go(mem, scale, la, widx, ww, a, lra, step, step_stride, batch,
                 n_rows, W, J, H, delta, threads, smem, s);
}

}  // extern "C"
