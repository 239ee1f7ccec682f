// fused_read_sweep: the exact SAM read (cosine top-K, softmax, weighted sum),
// and topk_read, which is the same sweep without the tail.
//
// Replaces src/repro/kernels/fused_read.py::fused_read_sweep (_sweep_kernel,
// fused_read.py:85-143, called at :180) on f32 rows, on bf16 rows (:101)
// and on int8 rows with their per-row scales (quantized=True, :102-106);
// and src/repro/kernels/topk_read.py::topk_read (_kernel, pallas_call at
// topk_read.py:69), the cosine top-K of the slot-sharded memory's read.
//
// Computes: q (B, H, W), mem (B, rows, W) of which rows [0, valid_n) are
// swept, beta (B, H) -> (on the rows as f32: bf16 upcast, int8 codes times
// their row's scale)
//   idx  (B, H, K) int32: the K rows of highest cosine similarity
//        x·q / (sqrt(|x|² + 1e-6) sqrt(|q|² + 1e-6)), ordered by
//        (similarity desc, index asc) — lax.top_k's tie rule;
//   w    (B, H, K) f32: softmax of similarity·beta, renormalised as in
//        fused_read.py:70-78;
//   read (B, H, W) f32: sum_k w_k · mem[b, idx_k].
// topk_read (topk_read_launch, f32 rows) returns the K (similarity, index)
// pairs instead, in the same order. 1 <= H, K <= 8; a row is a multiple of
// 16 bytes and at most 512 (256 for int8 rows at H > 4).
//
// What bounds it on the H100: bytes. A call streams the swept rows once:
// B·N·W·4 bytes in f32, 1.07 GB at B = 8, N = 2^20, W = 32, 0.32 ms at
// 3.35 TB/s; half that in bf16 (0.16 ms), B·N·(W + 4) with int8's scales
// (0.09 ms). The arithmetic, 2·(H + 1)·W flops a row, takes 0.04 ms at the
// CUDA cores' 67 TFLOP/s, so f32 FMAs suffice; no tensor cores, no TF32.
//
// What held the first version back (8, 2^20, 32, H = K = 4 on the H100:
// f32 0.459 ms at 18.3 G rows/s, bf16 0.322 ms at 26.1, int8 0.346 ms at
// 24.3; 25 % of the bound at the LM's (4, 65536, 128)):
// - the cost per row, not bytes, set the narrow rows' time: every row went
//   through shared memory as f32 (bf16 and int8 widened 2x and 4x there)
//   and each thread then read all W·H query values back from it;
// - a block loaded a tile, then scored it (one buffer, two barriers);
// - each thread kept a top-K per head over 16 rows, so about 57 % of the
//   rows shifted a list in shared memory, and every 4096-row chunk ended
//   in H·K block-wide arg-best rounds of 3 barriers each;
// - fixed 4096-row chunks gave (4, 65536) 64 blocks for 132 SMs, and its
//   203 KB of shared memory one block an SM; pass 2 was a second launch.
//
// The design:
// - The grid plan (kernels/fused_read.py::sweep_plan, which the wrapper
//   passes in as `Plan`) sizes chunks from B, valid_n and the SM count so
//   that the grid is one wave of resident blocks (264 blocks of 8 warps on
//   132 SMs where two fit); a block sweeps chunk_rows rows of one batch row.
// - Each warp runs its own ring of kStages stages in shared memory. Lane 0
//   fills a stage with one bulk copy (cp.async.bulk, completion on the
//   stage's mbarrier) of tile_rows raw rows, about 4 KB; for int8 the lanes
//   copy the tile's scales beside them with 4-byte cp.async, counted on the
//   same mbarrier. The warp scores a stage while the next two are in
//   flight and refills it once its lanes are past it (__syncwarp): there is
//   no block barrier in the sweep.
// - Rows are scored straight from the raw bytes: a row's 16-byte pieces
//   (8-byte for int8 at H > 4) go to `lanes` lanes, one piece each, and a
//   lane holds its slice of the normalised queries in registers for the
//   whole sweep. bf16 is widened in registers, int8 codes become exact
//   floats by a byte permute and a subtraction (magic 2^23), |c|² is a
//   dp4a (exact, as its f32 sum would be), and int8's scale is factored
//   out of the cosine: s·(c·q̂)/sqrt(s²|c|² + 1e-6).
// - A lane takes `bt` rows of a round (row s ^ jh ^ phi at slot s, jh the
//   lane's place among the row's lanes), so a reduce-scatter of shuffles
//   leaves each row's sums on one set of lanes in (bt - 1) exchanges of
//   H + 1 values; a butterfly over the rest completes them.
// - Shared loads are free of bank conflicts: the lanes a wavefront serves
//   (8 for 16-byte, 16 for 8-byte loads) read pieces of distinct banks.
//   The pieces of one row are adjacent; phi = (group >> phi_shift) & (bt-1)
//   staggers the rows that the groups of one wavefront read, and the plan
//   picks phi_shift by counting the banks (tests/test_torch_kernels.py
//   checks every power-of-two row width).
// - Top-K: a warp keeps one list per head in registers (lane k holds entry
//   k). A round's rows are tested against each list's last entry (value,
//   then index: at ties, as over zero rows, nothing enters) and one warp
//   vote says whether any enters; the few that do (about K·(1 + ln(n/K))
//   of a warp's n rows) are inserted one at a time with two shuffles. A
//   block merges its 8 warps' lists (one warp per head, K rounds of a warp
//   arg-best), writes K candidates per head, and takes a ticket; the last
//   block of a batch row merges the row's chunks·K candidates and runs the
//   softmax tail in the same launch (each writer fences before the ticket,
//   the last block fences after it and reads through L2).
//
// The invariant: a row's score is a function of the row, q (and H) and the
// row dtype alone: never of its position in a tile, chunk or block, of B,
// valid_n or the grid plan. q is normalised by the same warp butterfly in
// every block; each lane's partial sum runs over its piece in a fixed
// order; the shuffle tree pairs the lanes by the bits of their
// place in the row (so the lane that ends up holding a row does not change
// its sums: a + b = b + a), and lanes, bt and the piece size depend on the
// row's width, dtype and H only. The sharded read compares scores from
// different blocks of the memory, and topk_read's picks equal
// fused_read_sweep's bit for bit; both rest on this.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "rows.cuh"

// kernels/fused_read.py: SweepPlan; the wrapper computes it (outside the
// anonymous namespace: the C entry points take it).
struct Plan {
  int chunk_rows;    // rows a block sweeps, a multiple of kWarps·tile_rows
  int chunks;        // blocks per batch row
  int tile_rows;     // rows of one stage, a multiple of the round's rows
  int lanes;         // lanes a row is spread over (a power of 2, <= 32)
  int bt;            // rows a lane takes in a round (1, 2 or 4; <= lanes)
  int piece;         // bytes a lane loads from a row
  int phi_shift;     // the groups' row stagger
  int stage_bytes;   // tile_rows rows, then (int8) their scales
  int smem_bytes;
};

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kMaxBt = 4;
constexpr int kMaxH = 8;
constexpr int kMaxK = 8;
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr unsigned kAll = 0xffffffffu;

// Bytes a lane loads from a row: 16, or 8 for int8 at H > 4 (16 int8
// queries' values per head would be 128 registers at H = 8).
template <class R, int H>
__host__ __device__ constexpr int piece_bytes() {
  return R::kScaled && H > 4 ? 8 : 16;
}

__host__ __device__ constexpr size_t smem_bytes(int stage_bytes, int H,
                                                int K, int W) {
  return (size_t)kWarps * kStages * stage_bytes   // the warps' rings
         + (size_t)kWarps * kStages * 8           // their mbarriers
         + (size_t)kWarps * H * K * 8             // the warps' lists
         + (size_t)H * W * 4                      // normalised queries
         + (size_t)kWarps * 3 * kMaxK * 4         // the tail's selection
         + 16;                                    // the last-block flag
}

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kAll, v, o);
    const int oi = __shfl_xor_sync(kAll, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Raw row bytes as f32 values, in registers: value v of a piece of words.
template <class R> struct Raw;
template <> struct Raw<RowsF32> {
  static __device__ __forceinline__ float value(const uint32_t* w, int v,
                                                uint32_t) {
    return __uint_as_float(w[v]);
  }
};
template <> struct Raw<RowsBF16> {
  static __device__ __forceinline__ float value(const uint32_t* w, int v,
                                                uint32_t) {
    return __uint_as_float((v & 1) ? (w[v >> 1] & 0xffff0000u)
                                   : (w[v >> 1] << 16));
  }
};
// An int8 code c as the exact float c: with w's bytes flipped (c ^ 0x80 =
// c + 128), the byte goes into the mantissa of `magic` = 2^23, and
// 2^23 + 128 comes off. `magic` sits in a register, so the byte selector
// is the permute's immediate.
template <> struct Raw<RowsI8> {
  static __device__ __forceinline__ float value(const uint32_t* w, int v,
                                                uint32_t magic) {
    return __uint_as_float(__byte_perm(w[v >> 2], magic, 0x7440 | (v & 3)))
           - 8388736.0f;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on `bar`; the rows are read once, so they leave L2 first.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar,
                                          unsigned long long pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
         "l"(pol) : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed
// (.noinc: the barrier's count includes these arrivals).
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Inserts (v, i), which beats entry K-1, into a warp's list: lane k < K
// holds entry k; entries below it move down one lane.
__device__ __forceinline__ void insert(float& lv, int& li, float v, int i,
                                       int K, int lane) {
  const bool above = better(v, i, lv, li);
  const float pv = __shfl_up_sync(kAll, lv, 1);
  const int pi = __shfl_up_sync(kAll, li, 1);
  const bool above_prev = lane > 0 && better(v, i, pv, pi);
  if (lane < K && above) {
    lv = above_prev ? pv : v;
    li = above_prev ? pi : i;
  }
}

// 1/sqrt(x) for x >= 1e-6 (never subnormal, so without rsqrtf's fix-up).
__device__ __forceinline__ float rsqrt_normal(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// kTail = false is topk_read: the merged (similarity, index) pairs go to
// w_out and idx_out, and beta and read are not touched.
template <class R, int H, bool kTail>
__global__ void __launch_bounds__(kThreads, H <= 4 ? 2 : 1)
sweep_kernel(const float* __restrict__ q,
             const typename R::T* __restrict__ mem,
             const float* __restrict__ scale, long long rows_per_b,
             const float* __restrict__ beta, int valid_n, int K, int W,
             const Plan p, float* __restrict__ cand_v,
             int* __restrict__ cand_i, unsigned* __restrict__ tickets,
             float* __restrict__ read, float* __restrict__ w_out,
             int* __restrict__ idx_out) {
  using T = typename R::T;
  constexpr int kPiece = piece_bytes<R, H>();
  constexpr int kWords = kPiece / 4;
  constexpr int kV = kPiece / (int)sizeof(T);   // values a lane takes a row
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x, b = blockIdx.y;
  const int row_bytes = W * (int)sizeof(T);

  unsigned char* ring = smem + (size_t)warp * kStages * p.stage_bytes;
  unsigned char* after_rings = smem + (size_t)kWarps * kStages * p.stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(after_rings) + warp * kStages;
  float* list_v = reinterpret_cast<float*>(after_rings + kWarps * kStages * 8);
  int* list_i = reinterpret_cast<int*>(list_v + kWarps * H * K);
  float* qn = reinterpret_cast<float*>(list_i + kWarps * H * K);   // [h][w]
  float* sel_v = qn + H * W + warp * 3 * kMaxK;
  int* sel_i = reinterpret_cast<int*>(sel_v + kMaxK);
  float* sel_s = sel_v + 2 * kMaxK;
  int* last_flag = reinterpret_cast<int*>(qn + H * W + kWarps * 3 * kMaxK);

  const int first = c * p.chunk_rows;
  const int end = first + min(p.chunk_rows, valid_n - first);
  const int ntiles = (end - first + p.tile_rows - 1) / p.tile_rows;
  const unsigned char* mb = reinterpret_cast<const unsigned char*>(mem)
                            + (long long)b * rows_per_b * row_bytes;
  const float* sb = R::kScaled ? scale + (long long)b * rows_per_b : nullptr;
  const int scale_off = p.tile_rows * row_bytes;
  const unsigned long long pol = evict_first_policy();

  // Tile t (of tile_rows rows from `first`) into stage s; warp-uniform.
  auto issue = [&](int t, int s) {
    const int r0 = first + t * p.tile_rows;
    const int n = min(p.tile_rows, end - r0);
    unsigned char* dst = ring + (size_t)s * p.stage_bytes;
    if (lane == 0) {
      mbar_expect_tx(full + s, n * row_bytes);
      bulk_copy(dst, mb + (long long)r0 * row_bytes, n * row_bytes, full + s,
                pol);
    }
    if constexpr (R::kScaled) {
      for (int i = lane; i < n; i += 32)
        copy4(dst + scale_off + 4 * i, sb + r0 + i);
      copies_arrive(full + s);
    }
  };

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, R::kScaled ? 33 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int s = 0; s < kStages; ++s)
    if (warp + s * kWarps < ntiles) issue(warp + s * kWarps, s);

  // The normalised queries, while the first tiles are in flight: warp h
  // sums head h's squares (lane l over w = l, l + 32, ..., then a
  // butterfly: the same order in every block).
  if (warp < H) {
    const float* qh = q + ((long long)b * H + warp) * W;
    float s = 0.0f;
    for (int w = lane; w < W; w += 32) s = fmaf(qh[w], qh[w], s);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(kAll, s, m);
    const float r = rsqrtf(s + 1e-6f);
    for (int w = lane; w < W; w += 32) qn[warp * W + w] = qh[w] * r;
  }
  __syncthreads();

  // This lane's place: group g of `lanes` lanes takes bt rows a round; the
  // lane is j-th of them, and j = jh·cc + jl.
  const int G = p.lanes, bt = p.bt, cc = G / bt;
  const int g = lane / G, j = lane % G, jh = j / cc, jl = j % cc;
  const int phi = (g >> p.phi_shift) & (bt - 1);
  const bool live = j * kPiece < row_bytes;
  const int round_rows = 32 / cc;
  const int rounds = p.tile_rows / round_rows;
  // Slot s of a round reads piece j of row g·bt + (s ^ x).
  const int x = jh ^ phi;
  const int base = g * bt * row_bytes + j * kPiece;
  const int own_row = g * bt + x;            // the round's row it scores
  float qr[H][kV];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int v = 0; v < kV; ++v)
      qr[h][v] = live ? qn[h * W + j * kV + v] : 0.0f;
  // Lane k < K holds entry k of head h's list (lv, li); a row enters only
  // if it beats entry K-1.
  float lv[H];
  int li[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    lv[h] = -INFINITY;
    li[h] = INT_MAX;
  }
  uint32_t magic;
  asm("mov.b32 %0, 0x4b000000;\n" : "=r"(magic));

  int i = 0;
  for (int t = warp; t < ntiles; t += kWarps, ++i) {
    const int s = i % kStages;
    mbar_wait(full + s, (i / kStages) & 1);
    const unsigned char* tile = ring + (size_t)s * p.stage_bytes;
    const float* tsc = reinterpret_cast<const float*>(tile + scale_off);
    const int r0 = first + t * p.tile_rows;
    const int n = min(p.tile_rows, end - r0);
    for (int u = 0; u < rounds && u * round_rows < n; ++u) {
      const unsigned char* rb = tile + u * round_rows * row_bytes;
      float acc[kMaxBt][H + 1];        // [slot][0] = |x|², [slot][1 + h]
#pragma unroll
      for (int sl = 0; sl < kMaxBt; ++sl)
#pragma unroll
        for (int e = 0; e <= H; ++e) acc[sl][e] = 0.0f;
#pragma unroll
      for (int sl = 0; sl < kMaxBt; ++sl) {
        if (sl < bt && live) {
          uint32_t w[kWords];
          if constexpr (kWords == 4) {
            const uint4 d = *reinterpret_cast<const uint4*>(
                rb + base + ((sl ^ x) & (bt - 1)) * row_bytes);
            w[0] = d.x; w[1] = d.y; w[2] = d.z; w[3] = d.w;
          } else {
            const uint2 d = *reinterpret_cast<const uint2*>(
                rb + base + ((sl ^ x) & (bt - 1)) * row_bytes);
            w[0] = d.x; w[1] = d.y;
          }
          if constexpr (R::kScaled) {
            // |c|² in integers (exact, as f32 sums of these squares are).
            int sq = 0;
#pragma unroll
            for (int e = 0; e < kWords; ++e) {
              sq = __dp4a((int)w[e], (int)w[e], sq);
              w[e] ^= 0x80808080u;
            }
            acc[sl][0] = (float)sq;
          }
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const float val = Raw<R>::value(w, v, magic);
            if constexpr (!R::kScaled) acc[sl][0] = fmaf(val, val, acc[sl][0]);
#pragma unroll
            for (int h = 0; h < H; ++h)
              acc[sl][1 + h] = fmaf(val, qr[h][v], acc[sl][1 + h]);
          }
        }
      }
      // Reduce-scatter over jh (slot s + m goes to lane ^ m·cc, which holds
      // the same row in slot s), then a butterfly over jl.
      if (bt == 4) {
#pragma unroll
        for (int sl = 0; sl < 2; ++sl)
#pragma unroll
          for (int e = 0; e <= H; ++e)
            acc[sl][e] += __shfl_xor_sync(kAll, acc[sl + 2][e], 2 * cc);
      }
      if (bt >= 2) {
#pragma unroll
        for (int e = 0; e <= H; ++e)
          acc[0][e] += __shfl_xor_sync(kAll, acc[1][e], cc);
      }
      for (int m = cc >> 1; m > 0; m >>= 1) {
#pragma unroll
        for (int e = 0; e <= H; ++e)
          acc[0][e] += __shfl_xor_sync(kAll, acc[0][e], m);
      }

      const int rr = u * round_rows + own_row;    // row in the tile
      const int row = r0 + rr;
      const bool own = jl == 0 && rr < n;
      float g;                         // sim = dot · g
      if constexpr (R::kScaled) {
        const float f = tsc[rr];
        g = f * rsqrt_normal(fmaf(f * f, acc[0][0], 1e-6f));
      } else {
        g = rsqrt_normal(acc[0][0] + 1e-6f);
      }
      // One vote: does any row of the round beat a list's last entry?
      float sim[H];
      bool enters = false;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        sim[h] = acc[0][1 + h] * g;
        const float tv = __shfl_sync(kAll, lv[h], K - 1);
        const int ti = __shfl_sync(kAll, li[h], K - 1);
        enters |= own && better(sim[h], row, tv, ti);
      }
      if (!__any_sync(kAll, enters)) continue;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float tv = __shfl_sync(kAll, lv[h], K - 1);
        int ti = __shfl_sync(kAll, li[h], K - 1);
        unsigned m = __ballot_sync(kAll, own && better(sim[h], row, tv, ti));
        while (m) {
          const int src = __ffs(m) - 1;
          insert(lv[h], li[h], __shfl_sync(kAll, sim[h], src),
                 __shfl_sync(kAll, row, src), K, lane);
          tv = __shfl_sync(kAll, lv[h], K - 1);
          ti = __shfl_sync(kAll, li[h], K - 1);
          m &= m - 1;
          m &= __ballot_sync(kAll, own && better(sim[h], row, tv, ti));
        }
      }
    }
    __syncwarp();                      // every lane is past stage s
    if (t + kStages * kWarps < ntiles) issue(t + kStages * kWarps, s);
  }

  // The block's K candidates per head: warp h merges the warps' lists.
  if (lane < K) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      list_v[(warp * H + h) * K + lane] = lv[h];
      list_i[(warp * H + h) * K + lane] = li[h];
    }
  }
  __syncthreads();
  if (warp < H) {
    const int h = warp;
    const long long o = (((long long)b * H + h) * p.chunks + c) * K;
    int pos = 0;
    for (int k = 0; k < K; ++k) {
      const bool have = lane < kWarps && pos < K;
      const float hv = have ? list_v[(lane * H + h) * K + pos] : -INFINITY;
      const int hi = have ? list_i[(lane * H + h) * K + pos] : INT_MAX;
      float bv = hv;
      int bi = hi;
      warp_best(bv, bi);
      if (have && bv == hv && bi == hi) ++pos;
      if (lane == 0) {
        cand_v[o + k] = bv;
        cand_i[o + k] = bi;
      }
    }
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket = atomicAdd(tickets + b, 1u);
    const int last = ticket == (unsigned)(p.chunks - 1);
    if (last) {
      tickets[b] = 0u;                 // as the wrapper handed it over
      __threadfence();
    }
    *last_flag = last;
  }
  __syncthreads();
  if (!*last_flag || warp >= H) return;

  // The last block of batch row b: warp h merges the row's chunks·K
  // candidates for head h (each lane a sorted list of K, then K rounds of a
  // warp arg-best) and runs the tail.
  const int h = warp;
  const int ncand = p.chunks * K;
  const long long bh = (long long)b * H + h;
  float mv[kMaxK];
  int mi[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) { mv[k] = -INFINITY; mi[k] = INT_MAX; }
  for (int e0 = lane; e0 < ncand; e0 += 4 * 32) {
    float cv[4];
    int ci[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {       // four loads in flight
      const int e = e0 + 32 * u;
      cv[u] = e < ncand ? __ldcg(cand_v + bh * ncand + e) : -INFINITY;
      ci[u] = e < ncand ? __ldcg(cand_i + bh * ncand + e) : INT_MAX;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float v = cv[u];
      const int ix = ci[u];
#pragma unroll
      for (int k = kMaxK - 1; k >= 0; --k) {
        if (k < K && better(v, ix, mv[k], mi[k])) {
          const int a = k > 0 ? k - 1 : 0;
          if (k > 0 && better(v, ix, mv[a], mi[a])) {
            mv[k] = mv[a];
            mi[k] = mi[a];
          } else {
            mv[k] = v;
            mi[k] = ix;
          }
        }
      }
    }
  }
  for (int k = 0; k < K; ++k) {
    float bv = mv[0];
    int bi = mi[0];
    warp_best(bv, bi);
    if (bv == mv[0] && bi == mi[0]) {
#pragma unroll
      for (int e = 0; e < kMaxK - 1; ++e) {
        mv[e] = mv[e + 1];
        mi[e] = mi[e + 1];
      }
      mv[kMaxK - 1] = -INFINITY;
      mi[kMaxK - 1] = INT_MAX;
    }
    if (lane == 0) { sel_v[k] = bv; sel_i[k] = bi; }
  }
  __syncwarp();
  if constexpr (!kTail) {
    if (lane < K) {
      w_out[bh * K + lane] = sel_v[lane];
      idx_out[bh * K + lane] = sel_i[lane];
    }
    return;
  }
  if (lane < K) sel_s[lane] = R::kScaled ? scale[b * rows_per_b + sel_i[lane]]
                                         : 1.0f;
  __syncwarp();
  if (lane == 0) {
    // Softmax tail of fused_read.py:70-78 (exact reads are all valid).
    const float bt_ = beta[bh];
    float mx = -INFINITY;
    for (int k = 0; k < K; ++k) mx = fmaxf(mx, sel_v[k] * bt_);
    float sum = 0.0f;
    for (int k = 0; k < K; ++k) {
      sel_v[k] = expf(sel_v[k] * bt_ - mx);
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
      w_out[bh * K + k] = sel_v[k];
      idx_out[bh * K + k] = sel_i[k];
    }
  }
  __syncwarp();
  const T* mrow = mem + b * rows_per_b * W;
  for (int w = lane; w < W; w += 32) {
    float x[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)     // the K rows' loads in flight at once
      x[k] = k < K ? R::at(mrow + (long long)sel_i[k] * W, w, sel_s[k]) : 0.0f;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) acc = fmaf(sel_v[k], x[k], acc);
    read[bh * W + w] = acc;
  }
}

// The plan's fields against what the kernel assumes of them.
template <class R, int H>
bool plan_ok(const Plan& p, int K, int W, int valid_n) {
  constexpr int kPiece = piece_bytes<R, H>();
  const int row_bytes = W * (int)sizeof(typename R::T);
  const int pieces = row_bytes / kPiece;
  if (p.piece != kPiece || row_bytes % kPiece != 0 || pieces < 1
      || pieces > 32)
    return false;
  if (p.lanes < pieces || p.lanes >= 2 * pieces || (p.lanes & (p.lanes - 1)))
    return false;
  if ((p.bt != 1 && p.bt != 2 && p.bt != kMaxBt) || p.bt > p.lanes
      || p.phi_shift < 0 || p.phi_shift > 5)
    return false;
  const int round_rows = 32 * p.bt / p.lanes;
  if (p.tile_rows < round_rows || p.tile_rows % round_rows != 0
      || p.stage_bytes != p.tile_rows * (row_bytes + (R::kScaled ? 4 : 0))
      || p.stage_bytes % 16 != 0)
    return false;
  if (p.chunks < 1 || p.chunk_rows < 1
      || p.chunk_rows % (kWarps * p.tile_rows) != 0
      || (long long)(p.chunks - 1) * p.chunk_rows >= valid_n
      || (long long)p.chunks * p.chunk_rows < valid_n)
    return false;
  return (size_t)p.smem_bytes == smem_bytes(p.stage_bytes, H, K, W)
         && p.smem_bytes <= kMaxSmem;
}

template <class R, int H, bool kTail>
cudaError_t launch_h(const Plan& p, int batch, cudaStream_t s, const float* q,
                     const void* mem, const float* scale, long long rows_per_b,
                     const float* beta, int valid_n, int K, int W,
                     float* cand_v, int* cand_i, unsigned* tickets,
                     float* read, float* w_out, int* idx_out) {
  if (!plan_ok<R, H>(p, K, W, valid_n)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<R, H, kTail>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem_bytes);
  if (err != cudaSuccess) return err;
  sweep_kernel<R, H, kTail><<<dim3(p.chunks, batch), kThreads, p.smem_bytes,
                              s>>>(
      q, static_cast<const typename R::T*>(mem), scale, rows_per_b, beta,
      valid_n, K, W, p, cand_v, cand_i, tickets, read, w_out, idx_out);
  return cudaGetLastError();
}

template <class R, bool kTail>
cudaError_t launch(const Plan& p, int batch, int H, cudaStream_t s,
                   const float* q, const void* mem, const float* scale,
                   long long rows_per_b, const float* beta, int valid_n,
                   int K, int W, float* cand_v, int* cand_i,
                   unsigned* tickets, float* read, float* w_out,
                   int* idx_out) {
  if (R::kScaled && scale == nullptr) return cudaErrorInvalidValue;
  switch (H) {
#define SWEEP(h) case h: return launch_h<R, h, kTail>(p, batch, s, q, mem, \
    scale, rows_per_b, beta, valid_n, K, W, cand_v, cand_i, tickets, read,  \
    w_out, idx_out);
    SWEEP(1) SWEEP(2) SWEEP(3) SWEEP(4) SWEEP(5) SWEEP(6) SWEEP(7) SWEEP(8)
#undef SWEEP
  }
  return cudaErrorInvalidValue;
}

bool args_ok(int batch, int H, int K, int valid_n, const void* plan,
             const void* tickets) {
  return H >= 1 && H <= kMaxH && K >= 1 && K <= kMaxK && valid_n >= K
         && batch >= 1 && batch <= 65535 && plan != nullptr
         && tickets != nullptr;
}

}  // namespace

extern "C" {

// row_dtype: 0 = f32, 1 = bf16 (raw 16-bit patterns), 2 = int8 with
// scale (B, rows_per_b) f32; scale is ignored (may be null) otherwise.
// cand_v/cand_i: (B, H, plan.chunks·K) scratch; tickets: B words of zero,
// which the launch leaves as it found them (one set per stream).
int fused_read_launch(const float* q, const void* mem, const float* scale,
                      const float* beta, int batch, int H, int K, int W,
                      int valid_n, long long rows_per_b, int row_dtype,
                      const Plan* plan, float* cand_v, int* cand_i,
                      unsigned* tickets, float* read, float* w_out,
                      int* idx_out, void* stream) {
  if (!args_ok(batch, H, K, valid_n, plan, tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_dtype == 0)
    return (int)launch<RowsF32, true>(*plan, batch, H, s, q, mem, scale,
                                      rows_per_b, beta, valid_n, K, W, cand_v,
                                      cand_i, tickets, read, w_out, idx_out);
  if (row_dtype == 1)
    return (int)launch<RowsBF16, true>(*plan, batch, H, s, q, mem, scale,
                                       rows_per_b, beta, valid_n, K, W,
                                       cand_v, cand_i, tickets, read, w_out,
                                       idx_out);
  if (row_dtype == 2)
    return (int)launch<RowsI8, true>(*plan, batch, H, s, q, mem, scale,
                                     rows_per_b, beta, valid_n, K, W, cand_v,
                                     cand_i, tickets, read, w_out, idx_out);
  return (int)cudaErrorInvalidValue;
}

// topk_read: q (B, H, W), mem (B, rows_per_b, W) -> vals, idx (B, H, K)
// over rows [0, valid_n): the sweep above with its tail compiled out, on
// the row storage row_dtype (0 = f32, 1 = bf16, 2 = int8 with scale, as
// fused_read_launch), so a row scores as it does there; plan, cand_v,
// cand_i and tickets as above.
int topk_read_launch(const float* q, const void* mem, const float* scale,
                     int batch, int H, int K, int W, int valid_n,
                     long long rows_per_b, int row_dtype, const Plan* plan,
                     float* cand_v, int* cand_i, unsigned* tickets,
                     float* vals, int* idx, void* stream) {
  if (!args_ok(batch, H, K, valid_n, plan, tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_dtype == 0)
    return (int)launch<RowsF32, false>(*plan, batch, H, s, q, mem, nullptr,
                                       rows_per_b, nullptr, valid_n, K, W,
                                       cand_v, cand_i, tickets, nullptr,
                                       vals, idx);
  if (row_dtype == 1)
    return (int)launch<RowsBF16, false>(*plan, batch, H, s, q, mem, nullptr,
                                        rows_per_b, nullptr, valid_n, K, W,
                                        cand_v, cand_i, tickets, nullptr,
                                        vals, idx);
  if (row_dtype == 2)
    return (int)launch<RowsI8, false>(*plan, batch, H, s, q, mem, scale,
                                      rows_per_b, nullptr, valid_n, K, W,
                                      cand_v, cand_i, tickets, nullptr,
                                      vals, idx);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
