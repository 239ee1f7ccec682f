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
// Each entry becomes one int64 key value·2^32 + index, where an int32 value
// is itself and an f32 value is mapped to an int32 of the same signed
// order (`ordered`). Values can be negative (the -arange(N) stagger of
// SAM's table), and signed int64 order of the key is exactly (value,
// index) order, so the tie rule needs no extra compare and every key is
// unique. The TPU kernels' sequential grid has no counterpart: blocks run
// in parallel and meet in a merge.
//
// lra_topn: pass 1, a grid over (chunk of 8192 entries, b); each thread
// keeps its n smallest keys in a register list (loads issued four at a
// time), then n rounds of a block-wide min pick the chunk's n smallest.
// Pass 2: one block per b merges the chunks·n candidates the same way.
//
// usage_argmin (n = 1) has a sweep of its own, since a list of one is a
// running minimum: each thread keeps one (value, index) pair and replaces
// it only on a strictly smaller value (an f32 compare, in which -0.0
// equals +0.0), so among equal values it keeps the first it saw, the
// lowest index (a thread walks its entries in increasing order); the key
// is formed once, for the block's minimum. The body of a row is read as
// 16-byte float4 loads; a row starts 16-byte aligned only when its
// address does (rows % 4 == 0 for a whole table), so each row takes a
// scalar head up to its first aligned entry and a scalar tail after its
// last whole float4. A thread takes 16 float4s (ptxas keeps about four
// loads in flight, in 32 registers: 64 KB an SM, more than the memory
// needs in flight) and a block has 512 threads; a row gets about 4·SMs/B
// blocks, rounded to whole rounds of loads (B = 8, N = 2^20: 32 blocks a
// row, 256 in all, two an SM), so the table is swept in one wave. The
// loads carry an L2 evict-first policy: the table is read once, and its
// lines, not other kernels' (dirty ones cost a write-back), make room.
// Each block folds its minimum into its row's word with a 64-bit
// atomicMin (keys are unique, so the order of the blocks does not
// matter), and the last block of the row to finish (a ticket counter)
// writes the index, in the same launch.
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


constexpr int kArgThreads = 512;     // usage_argmin's block
constexpr int kVec = 16;             // float4 loads a thread
constexpr unsigned long long kSign = 1ULL << 63;

// float4s a block of usage_argmin's sweep takes: a row's share of about
// 4·SMs/batch blocks, rounded up to whole rounds of kVec loads a thread.
int argmin_per_block(int batch, int nvec) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const long long want = (4LL * sms + batch - 1) / batch;   // blocks a row
  const long long round = (long long)kVec * kArgThreads;
  long long per = (nvec + want - 1) / want;
  per = (per + round - 1) / round * round;
  return (int)(per < round ? round : per);
}

// 16 bytes of a table read once: through to L2 (no L1 line) under an
// evict-first policy there.
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ float4 load_once(const float4* p,
                                            unsigned long long pol) {
  float4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 "
      "{%0,%1,%2,%3}, [%4], %5;\n"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(p), "l"(pol));
  return r;
}

// The running minimum of one thread: a strictly smaller value replaces it
// (f32 compare: -0.0 equals +0.0), so among equal values the first seen,
// the lowest index, stays; the first entry is always taken (a row of +inf).
__device__ __forceinline__ void take(float& best_x, int& best_i, float x,
                                     int i) {
  if (x < best_x || best_i == INT_MAX) {
    best_x = x;
    best_i = i;
  }
}

__device__ __forceinline__ void take4(float& best_x, int& best_i, float4 x,
                                      int e) {
  take(best_x, best_i, x.x, e);
  take(best_x, best_i, x.y, e + 1);
  take(best_x, best_i, x.z, e + 2);
  take(best_x, best_i, x.w, e + 3);
}

// usage_argmin in one launch: block c of row b sweeps float4s
// [c·per, (c+1)·per) of the row's aligned body, block 0 also the head and
// the last block the tail. Each block folds its smallest key into
// row_min[b] (atomicMin on the key with its sign bit flipped, so unsigned
// order is signed order), then counts itself in tickets[b]; the last
// block of the row to count reads the minimum and puts both words back
// as it found them (all ones, zero).
__global__ void __launch_bounds__(kArgThreads)
argmin_kernel(const float* __restrict__ usage, long long row_stride,
              int valid_n, int per, unsigned long long* __restrict__ row_min,
              unsigned long long* __restrict__ tickets,
              int* __restrict__ out) {
  __shared__ long long sh[33];
  const int b = blockIdx.y, c = blockIdx.x, t = threadIdx.x;
  const int blocks = gridDim.x;
  const float* row = usage + (long long)b * row_stride;
  // Entries before the first 16-byte boundary, then whole float4s.
  const int mis = (int)((reinterpret_cast<unsigned long long>(row) >> 2) & 3);
  const int head = min((4 - mis) & 3, valid_n);
  const int nvec = (valid_n - head) >> 2;
  const int tail0 = head + 4 * nvec;
  const float4* body = reinterpret_cast<const float4*>(row + head);
  const int start = c * per, end = min(start + per, nvec);

  const unsigned long long pol = evict_first_policy();
  float best_x = 0.0f;
  int best_i = INT_MAX;
  if (c == 0 && t < head) take(best_x, best_i, row[t], t);
  int i = start + t;
  for (; i + (kVec - 1) * kArgThreads < end; i += kVec * kArgThreads) {
    float4 x[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      x[u] = load_once(body + i + u * kArgThreads, pol);
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      take4(best_x, best_i, x[u], head + 4 * (i + u * kArgThreads));
  }
  for (; i < end; i += kArgThreads)              // the last block's rest
    take4(best_x, best_i, load_once(body + i, pol), head + 4 * i);
  if (c == blocks - 1 && tail0 + t < valid_n)
    take(best_x, best_i, row[tail0 + t], tail0 + t);
  const long long key =
      best_i == INT_MAX ? kNone : make_key(ordered(best_x), best_i);
  const long long best = block_min(key, sh);
  if (t == 0) {
    atomicMin(row_min + b, (unsigned long long)best ^ kSign);
    // The ticket is taken with release and acquire order: this block's
    // atomicMin is done before its ticket counts, and the last block sees
    // every other block's.
    unsigned long long ticket;
    asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;\n"
                 : "=l"(ticket) : "l"(tickets + b) : "memory");
    if (ticket == (unsigned long long)(blocks - 1)) {
      const unsigned long long m = atomicExch(row_min + b, ~0ULL);
      tickets[b] = 0ULL;
      out[b] = (int)(m & 0xffffffffULL);
    }
  }
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

// state: 2·batch words, the rows' minima (all ones) then their tickets
// (zero), which the launch leaves as it found them; two launches must not
// share them at once (one set per stream).
int usage_argmin_launch(const float* usage, long long row_stride, int batch,
                        int valid_n, unsigned long long* state, int* out,
                        void* stream) {
  if (valid_n < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int nvec = valid_n / 4;
  const int per = argmin_per_block(batch, nvec);
  const int blocks = nvec > per ? (nvec + per - 1) / per : 1;
  argmin_kernel<<<dim3(blocks, batch), kArgThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      usage, row_stride, valid_n, per, state, state + batch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
