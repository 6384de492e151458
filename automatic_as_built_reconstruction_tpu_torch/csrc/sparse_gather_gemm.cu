// Sparse-convolution joins on Hopper's tensor cores: gather-GEMM and
// key-match GEMM.
//
// Replaces the TPU kernels of
//   automatic_as_built_reconstruction_tpu/ops/pallas/sparse_gather_gemm.py
//   gather_gemm   (:331) -> _pallas_gather_gemm (:74, pallas_call :96) and
//                           _pallas_gather_gemm_shared (:146, :168)
//   keymatch_gemm (:1098) -> _pallas_keymatch_gemm (:500, :524),
//                           _pallas_keymatch_gemm_shared (:585, :609),
//                           _pallas_keymatch_gemm_subwin (:678, :703) and
//                           _pallas_keymatch_gemm_grouped (:782, :810).
//
//   gather:    out[r] = sum_k found[k, r] * feats[idx[k, r]] @ W[k]
//   key-match: out[m] = sum_k [exists j: in_keys[j] == q_keys[k, m]]
//                             * feats[j] @ W[k]
//
// Both take fp32 feats and W, and both have a bfloat16 form
// (gather_gemm_bf16_kernel and keymatch_gemm_bf16_kernel, the second part
// of this file): bf16 feats and W, fp32 out, for the middle of
// compute_dtype="bfloat16" (car.fhd.mixed's gather joins; the key-match
// joins of car.fhd and car.fhd.serving with enable_mixed_precision).
//
// The TPU bodies of one family differ only in how a tile finds the window
// of feature rows it copies into VMEM (per tap, shared, per-tap
// subwindows, grouped taps), because the TPU gathers rows with a one-hot
// matmul over a contiguous window.  A GPU thread reads any row, so there
// is no window: both families run one tile, with two lookups.
//
// Design.  One block of 4 warps per tile of 64 output rows (and per scan:
// blockIdx.y); 78 704 bytes of shared memory at 27 taps of 64 -> 64, so
// two blocks an SM, and __launch_bounds__ lets ptxas use the 128
// registers a thread may then have (more registers, more independent
// loads and mmas in flight: 1.00 -> 0.75 ms at the largest join on an
// H100 80GB HBM3 at 700 W).
//   1. Lookups first, once per tile.  Warp w takes taps w, w + 4, ..., four
//      at once so that their loads overlap, and writes the source row of
//      each of the tile's rows into shared src[K][64]: the rulebook entry,
//      or the match of the query key in the sorted in_keys.  A tap's query
//      keys ascend along key-sorted rows, so per (tile, tap) two half-warp
//      16-ary searches (4 rounds at 61 184 keys) find the window of
//      in_keys that holds the tile's [min, max] query, and each row
//      bisects only inside it (about 64 keys, cached in L1).  The
//      non-empty taps are listed in ascending order; a tap no row of the
//      tile finds costs nothing further.
//   2. A 2-stage cp.async ring over the listed taps: while tap t is
//      multiplied, tap t+1's W[k] and gathered rows (16-byte cp.async.cg
//      chunks; 4-byte ones where Cin % 4 != 0 or a base is not 16-byte
//      aligned) land in the other stage.  A row with no source is
//      zero-filled by cp.async with src-size 0.  The k dimension is
//      zero-padded to KP = Cin rounded up to 8; rows are KP + 4 floats
//      apart and W's rows COUT + 8 (24 at COUT = 8), so that every
//      fragment load hits 32 distinct banks.
//   3. mma.sync.aligned.m16n8k8 TF32 with a 3xTF32 split.  Each warp
//      owns 16 rows x COUT columns: COUT / 8 accumulators of 4 fp32
//      registers that live across all taps, stored once at the end.  A
//      warp whose 16 rows have no source for a tap skips its products.
//
// Why 3xTF32.  The port serves fp32 with TF32 off, and each join is held
// to its fp32 plain version at 1e-4.  One TF32 rounding keeps 11 bits: a
// 27 x 64-term sum of order-1 products then errs by ~1e-3.  The kernel
// splits a = a_big + a_small, with a_big = a rounded to TF32 (to nearest,
// ties away, as cvt.rna does) and a_small = a - a_big, whose low 13 bits
// the tensor core ignores; b alike.  It adds a_small * b_big + a_big *
// b_small, then a_big * b_big: what it drops (a_small * b_small, the
// truncation of the small parts) is ~2^-21 of a product, fp32 accuracy.
// The rounding is two integer ops: cvt.rna.tf32.f32 is emulated on sm_90
// (about eight instructions, with an inf/NaN test), and with it the
// splits, not the mmas, bounded the tile.
// The tensor core rounds each mma's sum toward zero, so an accumulator
// carried through every mma of a join drifts by up to an ulp of the
// running sum per mma (2e-4 at 27 taps of 64 -> 64, values ~60, on the
// card): each k-step's three mmas therefore start from zero and their
// 8-term partial is added into the accumulator by an ordinary fp32 add
// (round to nearest).  That is as accurate as the fp32 plain version
// (tests/test_torch_sparse_gemm.py models both).  A non-finite input
// gives NaN (inf - inf in the split) where fp32 gives +-inf, and so does
// a value within a TF32 half-ulp of FLT_MAX; the served inputs are finite.
//
// Determinism.  No atomics, no split of the taps across blocks: a tile
// adds its taps, and each tap its k-steps, in ascending order, so a batch
// element and its unbatched call, every call form and every run give the
// same bits.
//
// Bound: operations, 2 * hits * Cin * Cout needed flops at the 3xTF32
// rate of the tensor cores (495 / 3 = 165 TFLOP/s; the SIMT tile this
// replaces was held to the 67 TFLOP/s fp32 rate); the bytes (features
// and output once, keys or rulebook, weights) bound only the narrow first
// layers.  The tensor cores do 64 x KP x COUT per non-empty (tile, tap)
// however few of its rows hit: the share the data needs is the tile
// occupancy that chip_smoke.py reports per join.
//
// in_keys must be ascending (sentinels last) for the search.  The wrapper
// computes that on the device into *sorted_flag; where it is 0 each row
// scans in_keys linearly, which is exact for any order (and slow: it is
// there so that no order gives a wrong answer, not to be fast).
//
// ptxas -v, sm_90a (nvcc 12.9): registers at COUT = 8 / 16 / 32 / 64 / 128,
// keymatch_gemm_kernel 80 / 87 / 105 / 130 / 192, gather_gemm_kernel
// 74 / 67 / 80 / 128 / 192; no stack, no spills; shared memory is dynamic,
// Layout::bytes (78 704 B at 27 taps of 64 -> 64).  Where the time goes
// (sparse_gemm_ablation.py): PERF.md.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_R = 64;              // output rows per block
constexpr int WARPS = TILE_R / 16;      // each owns 16 rows x COUT
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 2;           // per SM: what shared memory allows
constexpr int TB = 4;                   // taps a warp looks up at once
constexpr int KEY_NONE = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// W's row stride in floats: 8 or 24 mod 32, so that the B fragment's
// (k = t, n = g) loads of a warp fall on 32 distinct banks
__host__ __device__ constexpr int w_stride(int cout) {
  return cout == 8 ? 24 : cout + 8;
}

// Shared memory of one tile: two stages of the gathered rows [TILE_R][lda]
// and of W[k] [kp][w_stride], the sources [K][TILE_R], and K + 1 ints for
// the list of non-empty taps and its length.
struct Layout {
  int kp, lda;
  __host__ __device__ explicit Layout(int Cin)
      : kp((Cin + 7) / 8 * 8), lda((Cin + 7) / 8 * 8 + 4) {}
  __host__ __device__ size_t a_floats() const { return (size_t)TILE_R * lda; }
  __host__ __device__ size_t w_floats(int cout) const {
    return (size_t)kp * w_stride(cout);
  }
  __host__ __device__ size_t bytes(int K, int cout) const {
    return (2 * (a_floats() + w_floats(cout)) + (size_t)K * TILE_R + K + 1)
           * 4;
  }
};

// ---- PTX wrappers ------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = big + small: big is x rounded to TF32 (to nearest, ties away from
// zero, as cvt.rna.tf32.f32), small the rest as fp32 bits, of which the
// tensor core reads the top 19 (x to ~2^-21)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a (16 x 8, row) @ b (8 x 8, col), TF32 in, fp32 out (the sum is
// rounded toward zero)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- lookups: the source rows of rows r + 32 i (i < NRPL) at the taps
// k[b] (b < TB; k[b] >= K: no tap), for the 32 lanes of a warp at once;
// -1 where there is none.  TB taps in flight, so that their loads overlap.

struct RulebookLookup {
  const int* __restrict__ idx;        // [K, R]
  const uint8_t* __restrict__ found;  // [K, R]
  int N;
  template <int NRPL>
  __device__ void warp_rows(const int (&k)[TB], int K, int r, int R,
                            int (&j)[TB][NRPL]) const {
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int i = 0; i < NRPL; ++i) {
        const int row = r + 32 * i;
        j[b][i] = -1;
        if (k[b] < K && row < R) {
          const size_t o = (size_t)k[b] * R + row;
          const int s = idx[o];
          if (found[o] && s >= 0 && s < N) j[b][i] = s;
        }
      }
  }
};

// For each b: the smallest i in [lo[b], hi[b]) with keys[i] >= q[b], or
// hi[b], into lo[b]; keys ascending.  Each half-warp searches its own
// (lo, hi, q), uniform within the half, with 16 probes a round; the TB
// searches are interleaved.  All 32 lanes call it.
__device__ void half_warp_lower_bounds(const int* __restrict__ keys,
                                       const int (&q)[TB], int (&lo)[TB],
                                       int (&hi)[TB]) {
  const int lane16 = threadIdx.x & 15, shift = threadIdx.x & 16;
  for (;;) {
    bool open = false;
#pragma unroll
    for (int b = 0; b < TB; ++b) open |= lo[b] < hi[b];
    if (!__any_sync(FULL, open)) break;
    bool less[TB];
    int step[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int n = hi[b] - lo[b];
      step[b] = (n + 15) >> 4;
      const int p = lo[b] + lane16 * step[b];
      less[b] = n > 0 && p < hi[b] && __ldg(keys + p) < q[b];
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int c = __popc((__ballot_sync(FULL, less[b]) >> shift) & 0xffffu);
      if (lo[b] < hi[b]) {
        // keys[lo + (c-1) step] < q <= keys[lo + c step] (or that is >= hi)
        const int base = lo[b];
        if (c == 0) {
          hi[b] = base;
        } else {
          lo[b] = base + (c - 1) * step[b] + 1;
          hi[b] = min(hi[b], base + c * step[b]);
        }
      }
    }
  }
}

struct KeyLookup {
  const int* __restrict__ in_keys;  // [N]
  const int* __restrict__ q_keys;   // [K, R]
  int N;
  bool sorted;
  __device__ int scan(int q) const {
    if (q == KEY_NONE) return -1;
    for (int j = 0; j < N; ++j)
      if (__ldg(in_keys + j) == q) return j;
    return -1;
  }
  template <int NRPL>
  __device__ void warp_rows(const int (&k)[TB], int K, int r, int R,
                            int (&j)[TB][NRPL]) const {
    int q[TB][NRPL];
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int i = 0; i < NRPL; ++i) {
        const int row = r + 32 * i;
        q[b][i] = (k[b] < K && row < R)
                      ? __ldg(q_keys + (size_t)k[b] * R + row) : KEY_NONE;
      }
    if (!sorted) {
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int i = 0; i < NRPL; ++i) j[b][i] = scan(q[b][i]);
      return;
    }
    // per tap, the window [lo, hi) of in_keys within the tile's [min, max]
    // query: a tap's queries ascend along key-sorted rows, so it holds
    // about as many keys as the tile has rows
    int target[TB], lo[TB], hi[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      int mn = KEY_NONE, mx = KEY_NONE;
#pragma unroll
      for (int i = 0; i < NRPL; ++i)
        if (q[b][i] != KEY_NONE) {
          mn = min(mn, q[b][i]);
          mx = mx == KEY_NONE ? q[b][i] : max(mx, q[b][i]);
        }
      mn = __reduce_min_sync(FULL, mn);
      // sentinels count as the smallest query here; mx < KEY_NONE after
      mx = __reduce_max_sync(FULL, mx == KEY_NONE ? mn : mx);
      target[b] = (threadIdx.x & 16) ? mx + (mn != KEY_NONE) : mn;
      lo[b] = 0;
      hi[b] = mn == KEY_NONE ? 0 : N;   // no query: no search
    }
    half_warp_lower_bounds(in_keys, target, lo, hi);
    // each row: the lower bound of its query inside the window, all
    // TB x NRPL bisections interleaved
    int a[TB][NRPL], z[TB][NRPL];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int wlo = __shfl_sync(FULL, lo[b], 0);
      const int whi = __shfl_sync(FULL, lo[b], 16);
#pragma unroll
      for (int i = 0; i < NRPL; ++i) {
        a[b][i] = wlo;
        z[b][i] = q[b][i] == KEY_NONE ? wlo : whi;
      }
    }
    for (;;) {
      int mid[TB][NRPL], v[TB][NRPL];
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int i = 0; i < NRPL; ++i) {
          mid[b][i] = (a[b][i] + z[b][i]) >> 1;
          v[b][i] = a[b][i] < z[b][i] ? __ldg(in_keys + mid[b][i]) : 0;
        }
      bool open = false;
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int i = 0; i < NRPL; ++i) {
          if (a[b][i] < z[b][i]) {
            if (v[b][i] < q[b][i]) a[b][i] = mid[b][i] + 1;
            else z[b][i] = mid[b][i];
          }
          open |= a[b][i] < z[b][i];
        }
      if (!open) break;
    }
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int i = 0; i < NRPL; ++i)
        j[b][i] = (q[b][i] != KEY_NONE && a[b][i] < N
                   && __ldg(in_keys + a[b][i]) == q[b][i]) ? a[b][i] : -1;
  }
};

// src[k][r] for every tap and each of the ROWS rows of the tile (each
// lane looks up rows lane + 32 i, i < ROWS / 32, at TB taps at once);
// taps[k] = which 64-row parts of the tile have a source for tap k, as
// bits (a 64-row tile: 1 if any row has one).  Warp w takes taps w,
// w + NWARPS, ...
template <int ROWS, int NWARPS, class Lookup>
__device__ void find_sources(const Lookup& lookup, int* src, int* taps,
                             int row0, int R, int K) {
  constexpr int NRPL = ROWS / 32;
  const int lane = threadIdx.x & 31;
  for (int k0 = threadIdx.x >> 5; k0 < K; k0 += NWARPS * TB) {
    int k[TB], j[TB][NRPL];
#pragma unroll
    for (int b = 0; b < TB; ++b) k[b] = k0 + b * NWARPS;
    lookup.warp_rows(k, K, row0 + lane, R, j);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (k[b] >= K) break;
      int parts = 0;
#pragma unroll
      for (int i = 0; i < NRPL; ++i) {
        src[k[b] * ROWS + lane + 32 * i] = j[b][i];
        if (j[b][i] >= 0) parts |= 1 << (i / 2);
      }
      int any;
      if constexpr (ROWS <= 64)
        any = __any_sync(FULL, parts != 0);
      else
        any = __reduce_or_sync(FULL, parts);
      if (lane == 0) taps[k[b]] = any;
    }
  }
}

// In place, by one warp: the flags taps[0, K) -> taps[0, n) the non-empty
// taps in ascending order, taps[K] = n
__device__ void list_taps(int* taps, int K) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int base = 0; base < K; base += 32) {
    const bool f = base + lane < K && taps[base + lane] != 0;
    const unsigned m = __ballot_sync(FULL, f);
    __syncwarp();                     // the chunk is read before it is written
    if (f) taps[n + __popc(m & ((1u << lane) - 1))] = base + lane;
    n += __popc(m);
  }
  if (lane == 0) taps[K] = n;
}

// Issue the copies of tap k into one stage: W[k] (Cin x COUT) and the
// tile's rows (zeros where src < 0)
template <int COUT>
__device__ void load_tap(float* As, float* Ws, const float* __restrict__ feats,
                         const float* __restrict__ Wk, const int* src,
                         int Cin, int lda, bool vec_a, bool vec_w) {
  constexpr int LDW = w_stride(COUT), WQ = COUT / 4;
  if (vec_w) {
    for (int i = threadIdx.x; i < Cin * WQ; i += THREADS) {
      const int c = i / WQ, q = i - c * WQ;
      cp_async16(Ws + c * LDW + 4 * q, Wk + 4 * i, true);
    }
  } else {
    for (int i = threadIdx.x; i < Cin * COUT; i += THREADS) {
      const int c = i / COUT, n = i - c * COUT;
      cp_async4(Ws + c * LDW + n, Wk + i, true);
    }
  }
  // chunk (r, q) of the rows, q < w; thread i takes chunks i, i + THREADS,
  // ... stepped without a division
  const int w = vec_a ? Cin / 4 : Cin;
  const int dr = THREADS / w, dq = THREADS - dr * w;
  for (int r = threadIdx.x / w, q = threadIdx.x % w; r < TILE_R;) {
    const int j = src[r];
    const float* from = feats + (size_t)(j < 0 ? 0 : j) * Cin;
    if (vec_a)
      cp_async16(As + r * lda + 4 * q, from + 4 * q, j >= 0);
    else
      cp_async4(As + r * lda + q, from + q, j >= 0);
    r += dr;
    q += dq;
    if (q >= w) {
      q -= w;
      ++r;
    }
  }
}

// acc += the warp's 16 rows of As [TILE_R][lda] @ Ws [kp][LDW], 3xTF32,
// one round-to-nearest add of each k-step's partial
template <int COUT>
__device__ void multiply(float (&acc)[COUT / 8][4], const float* As,
                         const float* Ws, int kp, int lda) {
  constexpr int LDW = w_stride(COUT), NT = COUT / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a_lo = As + ((threadIdx.x >> 5) * 16 + g) * lda + t;
  const float* a_hi = a_lo + 8 * lda;
  const float* b = Ws + t * LDW + g;
  for (int k0 = 0; k0 < kp; k0 += 8) {
    // A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    uint32_t ab[4], as[4];
    split(a_lo[k0], ab[0], as[0]);
    split(a_hi[k0], ab[1], as[1]);
    split(a_lo[k0 + 4], ab[2], as[2]);
    split(a_hi[k0 + 4], ab[3], as[3]);
    const float* bk = b + k0 * LDW;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // B fragment: (k = t, n = g), (k = t + 4, n = g)
      uint32_t b0b, b0s, b1b, b1s;
      split(bk[nt * 8], b0b, b0s);
      split(bk[4 * LDW + nt * 8], b1b, b1s);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma(d, as, b0b, b1b);
      mma(d, ab, b0s, b1s);
      mma(d, ab, b0b, b1b);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += d[i];
    }
  }
}

template <int COUT, class Lookup>
__device__ void sparse_gemm_tile(const float* __restrict__ feats,
                                 const float* __restrict__ W,
                                 float* __restrict__ out, int R, int K,
                                 int Cin, bool vec_a, bool vec_w,
                                 const Lookup& lookup) {
  static_assert(COUT % 8 == 0 && COUT <= 128, "COUT: 8, 16, 32, 64 or 128");
  constexpr int LDW = w_stride(COUT), NT = COUT / 8;
  extern __shared__ float4 smem4[];
  const Layout L(Cin);
  float* As = reinterpret_cast<float*>(smem4);                // [2][TILE_R][lda]
  float* Ws = As + 2 * L.a_floats();                          // [2][kp][LDW]
  int* src = reinterpret_cast<int*>(Ws + 2 * L.w_floats(COUT));  // [K][TILE_R]
  int* taps = src + (size_t)K * TILE_R;                       // [K + 1]
  const int row0 = blockIdx.x * TILE_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // zero the k padding of both stages (columns [Cin, kp) of the rows, rows
  // [Cin, kp) of W): the copies never write there
  const int pad = L.kp - Cin;
  for (int i = threadIdx.x; i < 2 * TILE_R * pad; i += THREADS) {
    const int r = i / pad;
    As[r * L.lda + Cin + (i - r * pad)] = 0.f;
  }
  for (int i = threadIdx.x; i < 2 * pad * COUT; i += THREADS) {
    const int s = i / (pad * COUT), e = i - s * pad * COUT;
    Ws[s * L.w_floats(COUT) + (Cin + e / COUT) * LDW + e % COUT] = 0.f;
  }

  find_sources<TILE_R, WARPS>(lookup, src, taps, row0, R, K);
  __syncthreads();
  if (warp == 0) list_taps(taps, K);
  __syncthreads();
  const int n = taps[K];

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  if (n > 0) {
    load_tap<COUT>(As, Ws, feats, W + (size_t)taps[0] * Cin * COUT,
                   src + taps[0] * TILE_R, Cin, L.lda, vec_a, vec_w);
    cp_async_commit();
  }
  for (int t = 0; t < n; ++t) {
    const int s = t & 1;
    if (t + 1 < n) {                  // the next tap into the other stage
      const int k1 = taps[t + 1];
      load_tap<COUT>(As + (s ^ 1) * L.a_floats(),
                     Ws + (s ^ 1) * L.w_floats(COUT), feats,
                     W + (size_t)k1 * Cin * COUT, src + k1 * TILE_R, Cin,
                     L.lda, vec_a, vec_w);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // stage s has landed for every thread
    const int k = taps[t];
    if (__any_sync(FULL, src[k * TILE_R + warp * 16 + (lane & 15)] >= 0))
      multiply<COUT>(acc, As + s * L.a_floats(), Ws + s * L.w_floats(COUT),
                     L.kp, L.lda);
    __syncthreads();                  // stage s is free for tap t + 2
  }

  // C fragment: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  const int r = row0 + warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (r < R)
      *reinterpret_cast<float2*>(out + (size_t)r * COUT + nt * 8 + c) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r + 8 < R)
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * COUT + nt * 8 + c) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <int COUT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gather_gemm_kernel(const float* __restrict__ feats,
                   const int* __restrict__ idx,
                   const uint8_t* __restrict__ found,
                   const float* __restrict__ W, float* __restrict__ out,
                   int N, int R, int K, int Cin, bool vec_a, bool vec_w) {
  const size_t b = blockIdx.y;
  const RulebookLookup lookup{idx + b * K * R, found + b * K * R, N};
  sparse_gemm_tile<COUT>(feats + b * N * Cin, W, out + b * R * COUT, R, K,
                         Cin, vec_a, vec_w, lookup);
}

template <int COUT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
keymatch_gemm_kernel(const float* __restrict__ feats,
                     const int* __restrict__ in_keys,
                     const int* __restrict__ q_keys,
                     const uint8_t* __restrict__ sorted_flag,
                     const float* __restrict__ W, float* __restrict__ out,
                     int N, int R, int K, int Cin, bool vec_a, bool vec_w) {
  const size_t b = blockIdx.y;
  const KeyLookup lookup{in_keys + b * N, q_keys + b * K * R, N,
                         *sorted_flag != 0};
  sparse_gemm_tile<COUT>(feats + b * N * Cin, W, out + b * R * COUT, R, K,
                         Cin, vec_a, vec_w, lookup);
}

// ---- the key-match join's rulebook, for its backward --------------------
//
// The backward of the key-match join needs the rulebook (idx, found) of
// its keys.  The reference's _keymatch_bwd (:1237) gets it from
// ops/sparse_conv.py::_merge_lookup (:345) in XLA, a sort and a search of
// every query key, and so did the port's backward (the same function in
// PyTorch).  Here it goes through a hash table of the keys instead, in
// whatever order the keys come (key-sorted, or in first-appearance order
// as all.fhd.config gives them, which has no sort_voxels_by_key):
// keymatch_table_kernel inserts each valid key with its row (open
// addressing, linear probing, at most half full; keys are unique, so each
// key's row is found whatever the order of the inserts), after the
// launch has cleared the table (-1: empty; valid keys are non-negative);
// keymatch_rulebook_kernel looks every query key up, a thread each, and
// writes idx (0 where no source) and found.  On key-sorted keys this is
// faster than the join tile's own window search (find_sources), which it
// replaced: 0.0872 against 0.1057 ms at car.fhd's largest join (B = 6,
// 63 872 rows, 27 taps; join_grad_ablation.py on an H100 80GB HBM3 at
// 700 W).  It replaces no TPU
// kernel.  Bound: bytes (the keys and query keys read once, idx and found
// written once).
constexpr int TABLE_THREADS = 256;

__device__ __forceinline__ unsigned table_slot(int key, int bits) {
  return ((unsigned)key * 2654435761u) >> (32 - bits);
}

__global__ void __launch_bounds__(TABLE_THREADS)
keymatch_table_kernel(const int* __restrict__ in_keys,
                      int* __restrict__ table_keys,
                      int* __restrict__ table_rows, int N, int bits) {
  const int j = blockIdx.x * TABLE_THREADS + threadIdx.x;
  if (j >= N) return;
  const size_t b = blockIdx.y;
  const int key = in_keys[b * N + j];
  if (key == KEY_NONE) return;
  const unsigned mask = (1u << bits) - 1;
  int* keys = table_keys + (b << bits);
  for (unsigned h = table_slot(key, bits);; h = (h + 1) & mask) {
    const int prev = atomicCAS(keys + h, -1, key);
    if (prev == -1 || prev == key) {
      table_rows[(b << bits) + h] = j;
      return;
    }
  }
}

__global__ void __launch_bounds__(TABLE_THREADS)
keymatch_rulebook_kernel(const int* __restrict__ q_keys,
                         const int* __restrict__ table_keys,
                         const int* __restrict__ table_rows,
                         int* __restrict__ idx, uint8_t* __restrict__ found,
                         long long KR, int bits) {
  const long long i = (long long)blockIdx.x * TABLE_THREADS + threadIdx.x;
  if (i >= KR) return;
  const size_t b = blockIdx.y, o = b * KR + i;
  const int q = __ldg(q_keys + o);
  const int* keys = table_keys + (b << bits);
  const unsigned mask = (1u << bits) - 1;
  int j = -1;
  if (q != KEY_NONE)
    for (unsigned h = table_slot(q, bits);; h = (h + 1) & mask) {
      const int k = __ldg(keys + h);
      if (k == q) {
        j = __ldg(table_rows + (b << bits) + h);
        break;
      }
      if (k == -1) break;
    }
  idx[o] = j < 0 ? 0 : j;
  found[o] = j >= 0;
}

// ---- the bfloat16 form of both joins, on wgmma ---------------------------
//
// K3s as car.fhd.mixed runs it, and K4 (all four forms) as the key-match
// middle runs it under enable_mixed_precision (the JAX kernels' bf16
// operands with preferred_element_type=float32, sparse_gather_gemm.py
// :65-70 and :491-496, :576-581, :668-674, :767-778 there): bf16 feats
// [B, N, Cin] and W [K, Cin, Cout], out [B, R, Cout] in fp32.  One tile,
// templated on the same two lookups as the fp32 tile (the rulebook, or
// the query key's match in the sorted in_keys, with the on-device
// ascending flag and the linear scan it selects).
//
// Design (Hopper).  A block of BF_ROWS = 128 output rows, two warpgroups
// of 64 rows each.
//   1. Lookups first, by all eight warps: the source row of every (tap,
//      row) into shared src[K][128] (find_sources, as in the fp32 tile;
//      each lane looks up four rows of TB taps at once), and for each tap
//      which of the two 64-row halves has any source.  The taps with any
//      are listed in ascending order, each with its halves.
//   2. A ring of 3 stages on mbarriers, each a tap's gathered rows
//      [128][Cin] and its W[k] [Cin][Cout], both bf16: a "full" barrier a
//      stage, which counts each thread's arrival once its cp.asyncs have
//      landed (cp.async.mbarrier.arrive.noinc) and the bytes of W[k], and
//      an "empty" one, which every thread arrives at once its
//      warpgroup's products of the stage are done.  W[k] comes by the
//      tensor memory accelerator (cp.async.bulk.tensor, one box of Cin
//      rows a 64-column block, from a tensor map of W with the stage's
//      swizzle); one stage serves both halves, so W's copy per output
//      row is half the 64-row tile's.  Every thread copies its share of
//      its own warpgroup's rows, if the tap reaches them, in 16-byte
//      cp.async chunks (8- or 4-byte ones for narrow or unaligned rows; a
//      row with no source has src-size 0 and is zero-filled without
//      touching memory).  A warpgroup copies tap t + 2 into the stage of
//      tap t - 1 once both are done with it: the copies run two taps
//      ahead of the products.
//   3. Products on wgmma.mma_async m64n{Cout}k16 bf16 x bf16 -> fp32, one
//      warpgroup per 64 rows, both operands from shared memory: A (the
//      gathered rows, Cin contiguous) K-major, B (W[k] as stored, Cout
//      contiguous) MN-major with the transpose flag.  Both lie in wgmma's
//      canonical layout for their row width: a 128-byte swizzle for rows of
//      64 values (wider rows in 64-value blocks), 64 bytes at 32, 32 bytes
//      at 16, none for 16-byte rows (B at Cout = 8); Cin is zero-padded to
//      16, 32 or a multiple of 64 once, at the start.  The copying threads
//      write each chunk at its swizzled address.
//   4. The sum order, fixed: each tap's first k-step starts from zero
//      (scale-d = 0) and its Cin / 16 k-steps accumulate inside the tensor
//      core (which rounds each toward zero); the tap's partial is added to
//      the fp32 sums in registers by an ordinary round-to-nearest add, taps
//      in ascending order.  A warpgroup whose 64 rows have no source at a
//      tap skips its products.  No atomics, no split of a tile's taps
//      across blocks: every run, a batch element and its unbatched call,
//      and every call form but the grouped one give the same bits.
// What was measured against it (sparse_gemm_ablation.py --bf16, PERF.md):
// one producer warp for all copies (it cannot keep enough in flight: 1.8x
// slower than the tile this one replaced), two partials alternating so
// that tap t + 1's products overlap tap t's add (spills, one step less of
// copy lead: slower), four stages, 64-row tiles, W by cp.async,
// zero-filling only chunks that may hold another tap's rows, and a
// persistent grid whose third warpgroup looks up the next tile's sources
// while two multiply this one (slower: fewer warps copy, and the lookups'
// chains of loads run on fewer warps).
// Shared memory (LayoutBf16: 3 stages, each 1024-byte aligned): 88 844
// bytes at 27 taps of 64 -> 64, so two blocks an SM, which
// __launch_bounds__ also holds the registers to (one at Cout = 128).
// ptxas -v (sm_90a, nvcc 12.9): keymatch_gemm_bf16_kernel 79 / 79 / 93 /
// 116 / 168 registers at COUT = 8 / 16 / 32 / 64 / 128,
// gather_gemm_bf16_kernel 54 / 62 / 76 / 106 / 171; no stack, no spills.
//
// Bound: operations, 2 * hits * Cin * Cout needed flops at the dense bf16
// tensor-core rate (989 TFLOP/s on an H100 SXM), or bytes (bf16 features
// and weights, the rulebook or the int32 keys read once, fp32 output
// written once), whichever is larger; the served joins are bound by
// bytes.  Where the time goes: sparse_gemm_ablation.py --bf16, PERF.md.
//
// A sentinel key (INT32_MAX: a padding row, a tap with no query) never
// matches in the key lookup, so a sentinel row contributes nothing: the
// JAX package zeroes those rows' features instead (_keymatch_impl), which
// gives the same sums.

typedef uint16_t bf16_bits;         // a bfloat16 value, as its bits

constexpr int BF_CONSUMERS = 2;     // warpgroups of 64 output rows each
constexpr int BF_ROWS = 64 * BF_CONSUMERS;
constexpr int BF_THREADS = 128 * BF_CONSUMERS;
constexpr int BF_WARPS = BF_THREADS / 32;
constexpr int BF_STAGES = 3;          // a warpgroup copies 2 taps ahead
constexpr int BF_ALIGN = 1024;      // the period of the 128-byte swizzle
constexpr int BF_SMEM_MAX = 232448; // what one block may have on an H100
// blocks an SM that __launch_bounds__ keeps the registers for: two,
// except where wide accumulators need more
#define BF_MIN_BLOCKS(COUT) ((COUT) >= 128 ? 1 : 2)

// the swizzle of a canonical layout whose rows are row_bytes long: the
// bits of the byte offset that the row bits above 16 * rows-per-128 B are
// XORed into (128 B: 0x70, 64 B: 0x30, 32 B: 0x10; 16 B rows: none)
__host__ __device__ constexpr uint32_t swizzle_mask(int row_bytes) {
  return row_bytes == 128 ? 0x70u : row_bytes == 64 ? 0x30u
         : row_bytes == 32 ? 0x10u : 0u;
}

// wgmma's descriptor layout type for the same rows: 1 = 128-byte
// swizzle, 2 = 64, 3 = 32, 0 = none (interleaved 8 x 16-byte cores)
__host__ __device__ constexpr int swizzle_type(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : row_bytes == 32 ? 3 : 0;
}

__device__ __forceinline__ uint32_t swizzled(uint32_t off, uint32_t mask) {
  return off ^ ((off >> 3) & mask);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// One block's shared memory: [stages] x (A [kp / 64 blocks][BF_ROWS][<= 64]
// and W [Cout / 64 blocks][kp][<= 64], each 1024-byte aligned), the full
// and empty barriers, src [K][BF_ROWS], the tap flags [K] and the list
// [K + 1]; BF_ALIGN bytes of slack to align the base.
struct LayoutBf16 {
  int kp;             // Cin padded to 16, 32 or a multiple of 64
  int a_row, b_row;   // bytes of a row of A's and of W's canonical layout
  int a_bytes, w_bytes;
  __host__ __device__ LayoutBf16(int Cin, int cout)
      : kp(Cin <= 16 ? 16 : Cin <= 32 ? 32 : round_up(Cin, 64)),
        a_row((kp < 64 ? kp : 64) * 2),
        b_row((cout < 64 ? cout : 64) * 2),
        a_bytes(round_up(BF_ROWS * kp * 2, BF_ALIGN)),
        w_bytes(round_up(kp * cout * 2, BF_ALIGN)) {}
  __host__ __device__ size_t ring_bytes() const {
    return (size_t)BF_STAGES * (a_bytes + w_bytes);
  }
  __host__ __device__ size_t bytes(int K) const {
    return BF_ALIGN + ring_bytes() + 2 * BF_STAGES * 8
           + ((size_t)K * BF_ROWS + 2 * K + 1) * 4;
  }
  // byte offsets of value (r, col) of A and (c, n) of W in their stage,
  // before the swizzle
  __device__ uint32_t a_offset(int r, int col) const {
    return (col >> 6) * (BF_ROWS * 128) + r * a_row + (col & 63) * 2;
  }
  __device__ uint32_t w_offset(int c, int n) const {
    return (n >> 6) * (kp * 128) + c * b_row + (n & 63) * 2;
  }
};

// ---- PTX wrappers: cp.async to a shared address, mbarriers, wgmma ------

// one cp.async of `bytes` (16, 8 or 4; uniform in the warp) bytes to the
// shared address dst, zeros where !valid
__device__ __forceinline__ void cp_async_to(uint32_t dst, const void* src,
                                            int bytes, bool valid) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// whether the phase of parity `parity` of the barrier has completed (the
// thread may be suspended a while first)
__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// until that phase has completed; a build with -DSPARSE_GEMM_WAIT_LIMIT=n
// traps after n tries, so that a fault in the ring fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
#ifdef SPARSE_GEMM_WAIT_LIMIT
  for (long long i = 0; !mbar_try(bar, parity); ++i)
    if (i == SPARSE_GEMM_WAIT_LIMIT) __trap();
#else
  while (!mbar_try(bar, parity)) {
  }
#endif
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// the barrier counts one arrival of this thread once its cp.asyncs so far
// have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// the barrier counts one arrival of this thread and `bytes` more bytes
// to land before its phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one box of a 2-D tensor map at (x, y) into shared memory at dst, its
// bytes counted on the barrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int x,
                                            int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(bar) : "memory");
}

// shared-memory matrix descriptor: start address, leading and stride
// byte offsets, layout type (swizzle_type)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, int type) {
  return (uint64_t)((addr & 0x3ffff) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3fff) << 16
         | (uint64_t)((sbo >> 4) & 0x3fff) << 32
         | (uint64_t)type << 62;
}

// d (64 x N fp32 over the warpgroup) = A (64 x 16, K-major) @ B (16 x N,
// MN-major) [+ d if accumulate], A and B by descriptor
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fences and waits
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING)
               : "memory");
}

// By one warp: the taps with flags[k] != 0, ascending, as k | flags[k] <<
// 16 into list[0, n), and list[K] = n
__device__ void list_taps_bf16(const int* flags, int* list, int K) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int base = 0; base < K; base += 32) {
    const int f = base + lane < K ? flags[base + lane] : 0;
    const unsigned m = __ballot_sync(FULL, f != 0);
    if (f) list[n + __popc(m & ((1u << lane) - 1))] = (base + lane) | f << 16;
    n += __popc(m);
  }
  if (lane == 0) list[K] = n;
}

// One thread's copies of tap k's rows into a stage (shared address a_s):
// if its warpgroup's 64 rows reach the tap (bit g of halves), its share
// of them in chunks of a_chunk bytes (zeros where src < 0), each at its
// swizzled address.
__device__ void copy_rows_bf16(uint32_t a_s,
                               const bf16_bits* __restrict__ feats,
                               const int* src, int halves, int Cin,
                               const LayoutBf16& L, int a_chunk) {
  const int g = threadIdx.x >> 7, x = threadIdx.x & 127;
  if (!(halves >> g & 1)) return;
  const uint32_t a_mask = swizzle_mask(L.a_row);
  const int e = a_chunk / 2, w = Cin / e;   // values a chunk, chunks a row
  const int dr = 128 / w, dq = 128 - dr * w;
  // chunk (r, q) of the warpgroup's rows; thread x takes chunks x, x +
  // 128, ... stepped without a division
  for (int r = 64 * g + x / w, q = x % w; r < 64 * g + 64;) {
    const int j = src[r];
    cp_async_to(a_s + swizzled(L.a_offset(r, e * q), a_mask),
                feats + (size_t)(j < 0 ? 0 : j) * Cin + e * q, a_chunk,
                j >= 0);
    r += dr;
    q += dq;
    if (q >= w) {
      q -= w;
      ++r;
    }
  }
}

// The products of one tap by one warpgroup: ksteps wgmmas into the
// partial p, the first from zero (the group is committed by the caller)
template <int COUT>
__device__ __forceinline__ void multiply_tap_bf16(float (&p)[COUT / 2],
                                                  uint32_t a_s, uint32_t w_s,
                                                  const LayoutBf16& L,
                                                  int ksteps) {
  const int g = threadIdx.x >> 7;
  const uint32_t a_type = swizzle_type(L.a_row), b_type = swizzle_type(L.b_row);
  const uint32_t a0 = a_s + g * 64 * L.a_row;
  // A: K-major, 8-row groups 8 rows apart (SBO); B: MN-major, 8-row (k)
  // groups SBO apart, 64-column blocks LBO apart (for 16-byte rows, the
  // interleaved layout: 8 x 16-byte cores, the next k core LBO = 128 B on)
  const uint32_t b_lbo = b_type ? L.kp * L.b_row : 128;
  const uint32_t b_sbo = b_type ? 8 * L.b_row : 256;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  pin<COUT / 2>(p);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint32_t a = a0 + (kk >> 2) * (BF_ROWS * 128)
                       + (kk & 3) * 32;           // 16 values = 32 B a k-step
    const uint32_t b = w_s + kk * 16 * L.b_row;
    wgmma_bf16<COUT>(p, wgmma_desc(a, 16, 8 * L.a_row, a_type),
                     wgmma_desc(b, b_lbo, b_sbo, b_type), kk > 0);
  }
  pin<COUT / 2>(p);
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int COUT, class Lookup>
__device__ void sparse_gemm_tile_bf16(const bf16_bits* __restrict__ feats,
                                      float* __restrict__ out, int R, int K,
                                      int Cin, int a_chunk,
                                      const CUtensorMap& w_map,
                                      const Lookup& lookup) {
  static_assert(COUT % 8 == 0 && COUT <= 128, "COUT: 8, 16, 32, 64 or 128");
  constexpr int NP = COUT / 2;           // accumulator values a thread
  extern __shared__ uint8_t smem_bf16[];
  const LayoutBf16 L(Cin, COUT);
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_bf16);
  uint8_t* smem = smem_bf16 + ((BF_ALIGN - raw % BF_ALIGN) % BF_ALIGN);
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t bars = base + (uint32_t)L.ring_bytes();   // full, empty
  int* src = reinterpret_cast<int*>(smem + L.ring_bytes() + 16 * BF_STAGES);
  int* flags = src + (size_t)K * BF_ROWS;                  // [K]
  int* list = flags + K;                                   // [K + 1]
  const int row0 = blockIdx.x * BF_ROWS;
  const int warp = threadIdx.x >> 5;
  const int stage_bytes = L.a_bytes + L.w_bytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < BF_STAGES; ++s) {
      mbar_init(bars + 8 * s, BF_THREADS + 1);              // full
      mbar_init(bars + 8 * (BF_STAGES + s), BF_THREADS);    // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the k padding of every stage: the copies never write there
  const uint32_t a_mask = swizzle_mask(L.a_row), w_mask = swizzle_mask(L.b_row);
  const int pad = L.kp - Cin;
  for (int i = threadIdx.x; i < BF_STAGES * BF_ROWS * pad; i += BF_THREADS) {
    const int s = i / (BF_ROWS * pad), e = i - s * BF_ROWS * pad;
    const int r = e / pad, col = Cin + (e - r * pad);
    *reinterpret_cast<bf16_bits*>(
        smem + s * stage_bytes + swizzled(L.a_offset(r, col), a_mask)) = 0;
  }
  for (int i = threadIdx.x; i < BF_STAGES * pad * COUT; i += BF_THREADS) {
    const int s = i / (pad * COUT), e = i - s * pad * COUT;
    const int c = Cin + e / COUT, n = e % COUT;
    *reinterpret_cast<bf16_bits*>(smem + s * stage_bytes + L.a_bytes
                                  + swizzled(L.w_offset(c, n), w_mask)) = 0;
  }
  if (pad) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  find_sources<BF_ROWS, BF_WARPS>(lookup, src, flags, row0, R, K);
  __syncthreads();
  if (warp == 0) list_taps_bf16(flags, list, K);
  __syncthreads();
  const int listed = list[K];

  // Tap u into stage u % stages: W[k] by the tensor memory accelerator
  // (one box of Cin rows a 64-column block, swizzled by the map as the
  // stage wants it; thread 0 sets the barrier to expect its bytes), and
  // every thread's share of the rows, after which the thread's arrival
  // counts once its copies land.  Tap u + stages - 1 goes into the stage
  // of tap u - 1 once both warpgroups are done with that (its empty
  // barrier), so that each warpgroup copies stages - 1 taps ahead of its
  // products.
  const int g = threadIdx.x >> 7;
  const int ahead = BF_STAGES - 1;
  auto copy = [&](int u) {
    const int s = u % BF_STAGES, e = list[u], k = e & 0xffff;
    const uint32_t full = bars + 8 * s, a_s = base + s * stage_bytes;
    if (u >= BF_STAGES)                 // tap u - stages done by both
      mbar_wait(bars + 8 * (BF_STAGES + s), (u / BF_STAGES - 1) & 1);
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full, Cin * COUT * 2);
      for (int nb = 0; nb < COUT; nb += 64)
        tma_load_2d(a_s + L.a_bytes + (nb / 64) * L.kp * 128, &w_map, nb,
                    k * Cin, full);
    }
    copy_rows_bf16(a_s, feats, src + k * BF_ROWS, e >> 16, Cin, L, a_chunk);
    cp_async_arrive(full);
  };
  for (int u = 0; u < ahead && u < listed; ++u) copy(u);

  // the products: warpgroup g, rows g * 64 .. g * 64 + 63 of the tile.
  // Tap t's partial p from zero, if this warpgroup's rows reach it (the
  // group is committed either way); then its stage released, tap t +
  // ahead copied and p added to the sums.
  const int ksteps = (Cin + 15) / 16;
  float acc[NP], p[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) acc[i] = p[i] = 0.f;
  for (int t = 0; t < listed; ++t) {
    const int s = t % BF_STAGES;
    mbar_wait(bars + 8 * s, (t / BF_STAGES) & 1);
    __syncwarp();
    if (list[t] >> (16 + g) & 1)
      multiply_tap_bf16<COUT>(p, base + s * stage_bytes,
                              base + s * stage_bytes + L.a_bytes, L, ksteps);
    wgmma_commit();
    wgmma_wait<0>();
    pin<NP>(p);
    mbar_arrive(bars + 8 * (BF_STAGES + s));
    if (t + ahead < listed) copy(t + ahead);
    if (list[t] >> (16 + g) & 1) {
#pragma unroll
      for (int i = 0; i < NP; ++i) acc[i] += p[i];
    }
  }

  // the accumulator fragment of warp w of the warpgroup: rows 16 w + l / 4
  // and + 8, columns 8 i + 2 (l % 4) and + 1 (l the lane)
  const int lane = threadIdx.x & 31;
  const int r = row0 + g * 64 + (warp & 3) * 16 + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < COUT / 8; ++nt) {
    if (r < R)
      *reinterpret_cast<float2*>(out + (size_t)r * COUT + nt * 8 + c) =
          make_float2(acc[4 * nt], acc[4 * nt + 1]);
    if (r + 8 < R)
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * COUT + nt * 8 + c) =
          make_float2(acc[4 * nt + 2], acc[4 * nt + 3]);
  }
}

template <int COUT>
__global__ void __launch_bounds__(BF_THREADS, BF_MIN_BLOCKS(COUT))
gather_gemm_bf16_kernel(const bf16_bits* __restrict__ feats,
                        const int* __restrict__ idx,
                        const uint8_t* __restrict__ found,
                        const bf16_bits* __restrict__ W,
                        float* __restrict__ out, int N, int R, int K,
                        int Cin, int a_chunk,
                        const __grid_constant__ CUtensorMap w_map) {
  const size_t bz = blockIdx.y;
  const RulebookLookup lookup{idx + bz * K * R, found + bz * K * R, N};
  sparse_gemm_tile_bf16<COUT>(feats + bz * N * Cin, out + bz * R * COUT, R,
                              K, Cin, a_chunk, w_map, lookup);
}

template <int COUT>
__global__ void __launch_bounds__(BF_THREADS, BF_MIN_BLOCKS(COUT))
keymatch_gemm_bf16_kernel(const bf16_bits* __restrict__ feats,
                          const int* __restrict__ in_keys,
                          const int* __restrict__ q_keys,
                          const uint8_t* __restrict__ sorted_flag,
                          const bf16_bits* __restrict__ W,
                          float* __restrict__ out, int N, int R, int K,
                          int Cin, int a_chunk,
                          const __grid_constant__ CUtensorMap w_map) {
  const size_t bz = blockIdx.y;
  const KeyLookup lookup{in_keys + bz * N, q_keys + bz * K * R, N,
                         *sorted_flag != 0};
  sparse_gemm_tile_bf16<COUT>(feats + bz * N * Cin, out + bz * R * COUT, R,
                              K, Cin, a_chunk, w_map, lookup);
}

template <class Kernel, class... Args>
int launch(Kernel kernel, size_t smem, int B, int R, cudaStream_t stream,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((R + TILE_R - 1) / TILE_R, B);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Lets a bf16 tile kernel have `smem` bytes of dynamic shared memory,
// carved out of L1 in full, so that two blocks fit an SM
cudaError_t allow_smem_bf16(const void* kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

// The bf16 tile: BF_ROWS rows a block, BF_THREADS threads, the shared
// memory of LayoutBf16
template <class Kernel, class... Args>
int launch_bf16(Kernel kernel, size_t smem, int B, int R, cudaStream_t stream,
                Args... args) {
  if (smem > (size_t)BF_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem_bf16((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + BF_ROWS - 1) / BF_ROWS, B);
  kernel<<<grid, BF_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

// The bf16 tile's tensor map of W [K, Cin, Cout] (bf16, 16-byte aligned):
// W as K * Cin rows of Cout, boxes of Cin rows by up to 64 columns, with
// the swizzle of the stage's layout for that row width; made for each
// launch.  The encoder, cuTensorMapEncodeTiled, is looked up through the
// runtime once, so nothing links against libcuda.
int encode_weight_map(CUtensorMap* map, const uint16_t* W, int K, int Cin,
                      int Cout) {
  static void* const fn = [] {
    void* f = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault) != cudaSuccess)
      f = nullptr;
    return f;
  }();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const auto encode = reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(fn);
  if (!aligned16(W) || Cin > 256) return (int)cudaErrorInvalidValue;
  const int inner = Cout < 64 ? Cout : 64;
  const int type = swizzle_type(inner * 2);
  const CUtensorMapSwizzle swizzle =
      type == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
      : type == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
      : type == 3 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const cuuint64_t dims[2] = {(cuuint64_t)Cout, (cuuint64_t)K * Cin};
  const cuuint64_t strides[1] = {(cuuint64_t)Cout * 2};
  const cuuint32_t box[2] = {(cuuint32_t)inner, (cuuint32_t)Cin};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<uint16_t*>(W),
      dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The width of the bf16 tile's row copies: 16-byte chunks where Cin % 8
// == 0 and feats is 16-byte aligned, 8-byte ones for Cin % 4 == 0, else
// 4-byte ones (Cin even, feats 4-byte aligned: the wrapper sees to both).
int bf16_row_bytes(const uint16_t* feats, int Cin) {
  return (Cin % 8 == 0 && aligned16(feats)) ? 16
         : (Cin % 4 == 0 && aligned8(feats)) ? 8 : 4;
}

}  // namespace

// Shared-memory bytes a launch at (K, Cin, Cout) asks for; the wrapper
// holds it against the 227 KB a block may have.
extern "C" int sparse_gemm_smem_bytes(int K, int Cin, int Cout) {
  return (int)Layout(Cin).bytes(K, Cout);
}

// The same for the bfloat16 form of either join (the key lookup keeps
// nothing in shared memory beyond the sources and the tap list, which
// LayoutBf16 counts, so both joins ask for the same bytes).
extern "C" int sparse_gemm_bf16_smem_bytes(int K, int Cin, int Cout) {
  return (int)LayoutBf16(Cin, Cout).bytes(K);
}

// The bfloat16 tile at (K, Cin, Cout): out[0] its output rows a block,
// out[1] the stages of its ring, out[2] its shared-memory bytes,
// out[3] the blocks of its key-match kernel that fit an SM at once.
extern "C" int sparse_gemm_bf16_tile(int K, int Cin, int Cout, int* out) {
  const LayoutBf16 L(Cin, Cout);
  out[0] = BF_ROWS;
  out[1] = BF_STAGES;
  out[2] = (int)L.bytes(K);
  out[3] = 0;
#define BF16_OCCUPANCY(COUT)                                                \
  if (Cout == COUT) {                                                     \
    cudaError_t err = allow_smem_bf16(                                    \
        (const void*)keymatch_gemm_bf16_kernel<COUT>, out[2]);            \
    if (err == cudaSuccess)                                               \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
          out + 3, keymatch_gemm_bf16_kernel<COUT>, BF_THREADS, out[2]);  \
    return (int)err;                                                      \
  }
  BF16_OCCUPANCY(8)
  BF16_OCCUPANCY(16)
  BF16_OCCUPANCY(32)
  BF16_OCCUPANCY(64)
  BF16_OCCUPANCY(128)
#undef BF16_OCCUPANCY
  return (int)cudaErrorInvalidValue;
}

#define DISPATCH_COUT(LAUNCH, KERNEL, ...)                                \
  switch (Cout) {                                                         \
    case 8: return LAUNCH(KERNEL<8>, __VA_ARGS__);                        \
    case 16: return LAUNCH(KERNEL<16>, __VA_ARGS__);                      \
    case 32: return LAUNCH(KERNEL<32>, __VA_ARGS__);                      \
    case 64: return LAUNCH(KERNEL<64>, __VA_ARGS__);                      \
    case 128: return LAUNCH(KERNEL<128>, __VA_ARGS__);                    \
    default: return (int)cudaErrorInvalidValue;                           \
  }

// feats [B, N, Cin], idx / found [B, K, R], W [K, Cin, Cout] -> out
// [B, R, Cout]; found holds one byte per entry (0 = no source).
extern "C" int gather_gemm_launch(const float* feats, const int* idx,
                                  const uint8_t* found, const float* W,
                                  float* out, int B, int N, int R, int K,
                                  int Cin, int Cout, cudaStream_t stream) {
  if (B == 0 || R == 0) return (int)cudaSuccess;
  const bool vec_a = Cin % 4 == 0 && aligned16(feats);
  const bool vec_w = aligned16(W);
  DISPATCH_COUT(launch, gather_gemm_kernel, Layout(Cin).bytes(K, Cout), B,
                R, stream, feats, idx, found, W, out, N, R, K, Cin, vec_a,
                vec_w)
}

// The bfloat16 form: feats [B, N, Cin] and W [K, Cin, Cout] bf16 (as
// their bits), idx / found [B, K, R] -> out [B, R, Cout] fp32.  Cin must
// be even, feats 4-byte and W 16-byte aligned (the wrapper sees to it).
extern "C" int gather_gemm_bf16_launch(const uint16_t* feats, const int* idx,
                                       const uint8_t* found,
                                       const uint16_t* W, float* out, int B,
                                       int N, int R, int K, int Cin,
                                       int Cout, cudaStream_t stream) {
  if (B == 0 || R == 0) return (int)cudaSuccess;
  if (Cin % 2 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap w_map;
  const int err = encode_weight_map(&w_map, W, K, Cin, Cout);
  if (err != 0) return err;
  DISPATCH_COUT(launch_bf16, gather_gemm_bf16_kernel,
                LayoutBf16(Cin, Cout).bytes(K), B, R, stream, feats, idx,
                found, W, out, N, R, K, Cin, bf16_row_bytes(feats, Cin),
                w_map)
}

// feats [B, N, Cin], in_keys [B, N], q_keys [B, K, R], W [K, Cin, Cout]
// -> out [B, R, Cout]; *sorted_flag != 0 iff every scan's in_keys ascend.
extern "C" int keymatch_gemm_launch(const float* feats, const int* in_keys,
                                    const int* q_keys,
                                    const uint8_t* sorted_flag,
                                    const float* W, float* out, int B,
                                    int N, int R, int K, int Cin, int Cout,
                                    cudaStream_t stream) {
  if (B == 0 || R == 0) return (int)cudaSuccess;
  const bool vec_a = Cin % 4 == 0 && aligned16(feats);
  const bool vec_w = aligned16(W);
  DISPATCH_COUT(launch, keymatch_gemm_kernel, Layout(Cin).bytes(K, Cout),
                B, R, stream, feats, in_keys, q_keys, sorted_flag, W, out, N,
                R, K, Cin, vec_a, vec_w)
}

// The hash table of keymatch_rulebook_launch holds 2^bits slots a scan:
// at least twice N.
extern "C" int keymatch_table_bits(int N) {
  int bits = 1;
  while ((1LL << bits) < 2LL * N) ++bits;
  return bits;
}

// The rulebook of a key-match join for its backward: in_keys [B, N],
// q_keys [B, K, R] -> idx [B, K, R] int32 (0 where none) and found [B, K,
// R] bytes.  table_keys / table_rows [B, 2^bits] int32 (bits from
// keymatch_table_bits), table_keys cleared here.
extern "C" int keymatch_rulebook_launch(const int* in_keys,
                                        const int* q_keys, int* table_keys,
                                        int* table_rows, int* idx,
                                        uint8_t* found, int B, int N, int R,
                                        int K, cudaStream_t stream) {
  if (B == 0 || R == 0 || K == 0) return (int)cudaSuccess;
  const int bits = keymatch_table_bits(N);
  cudaError_t err = cudaMemsetAsync(
      table_keys, 0xff, ((size_t)B << bits) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (N > 0) {
    keymatch_table_kernel<<<dim3((N + TABLE_THREADS - 1) / TABLE_THREADS, B),
                            TABLE_THREADS, 0, stream>>>(
        in_keys, table_keys, table_rows, N, bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long KR = (long long)K * R;
  keymatch_rulebook_kernel<<<dim3((unsigned)((KR + TABLE_THREADS - 1)
                                             / TABLE_THREADS), B),
                             TABLE_THREADS, 0, stream>>>(
      q_keys, table_keys, table_rows, idx, found, KR, bits);
  return (int)cudaGetLastError();
}

// The bfloat16 form of the key-match join: feats [B, N, Cin] and W [K,
// Cin, Cout] bf16 (as their bits), in_keys [B, N], q_keys [B, K, R] int32
// -> out [B, R, Cout] fp32; *sorted_flag as above.  Cin must be even,
// feats 4-byte and W 16-byte aligned (the wrapper sees to it).
extern "C" int keymatch_gemm_bf16_launch(const uint16_t* feats,
                                         const int* in_keys,
                                         const int* q_keys,
                                         const uint8_t* sorted_flag,
                                         const uint16_t* W, float* out,
                                         int B, int N, int R, int K, int Cin,
                                         int Cout, cudaStream_t stream) {
  if (B == 0 || R == 0) return (int)cudaSuccess;
  if (Cin % 2 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap w_map;
  const int err = encode_weight_map(&w_map, W, K, Cin, Cout);
  if (err != 0) return err;
  DISPATCH_COUT(launch_bf16, keymatch_gemm_bf16_kernel,
                LayoutBf16(Cin, Cout).bytes(K), B, R, stream, feats,
                in_keys, q_keys, sorted_flag, W, out, N, R, K, Cin,
                bf16_row_bytes(feats, Cin), w_map)
}
