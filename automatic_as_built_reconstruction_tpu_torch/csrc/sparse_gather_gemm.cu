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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_R = 64;              // output rows per block
constexpr int WARPS = TILE_R / 16;      // each owns 16 rows x COUT
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 2;           // per SM: what shared memory allows
constexpr int RPL = TILE_R / 32;        // rows per lane in the lookups
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

// ---- lookups: the source rows of rows r + 32 i (i < RPL) at the taps
// k[b] (b < TB; k[b] >= K: no tap), for the 32 lanes of a warp at once;
// -1 where there is none.  TB taps in flight, so that their loads overlap.

struct RulebookLookup {
  const int* __restrict__ idx;        // [K, R]
  const uint8_t* __restrict__ found;  // [K, R]
  int N;
  __device__ void warp_rows(const int (&k)[TB], int K, int r, int R,
                            int (&j)[TB][RPL]) const {
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
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
  __device__ void warp_rows(const int (&k)[TB], int K, int r, int R,
                            int (&j)[TB][RPL]) const {
    int q[TB][RPL];
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const int row = r + 32 * i;
        q[b][i] = (k[b] < K && row < R)
                      ? __ldg(q_keys + (size_t)k[b] * R + row) : KEY_NONE;
      }
    if (!sorted) {
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int i = 0; i < RPL; ++i) j[b][i] = scan(q[b][i]);
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
      for (int i = 0; i < RPL; ++i)
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
    // TB x RPL bisections interleaved
    int a[TB][RPL], z[TB][RPL];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int wlo = __shfl_sync(FULL, lo[b], 0);
      const int whi = __shfl_sync(FULL, lo[b], 16);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        a[b][i] = wlo;
        z[b][i] = q[b][i] == KEY_NONE ? wlo : whi;
      }
    }
    for (;;) {
      int mid[TB][RPL], v[TB][RPL];
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          mid[b][i] = (a[b][i] + z[b][i]) >> 1;
          v[b][i] = a[b][i] < z[b][i] ? __ldg(in_keys + mid[b][i]) : 0;
        }
      bool open = false;
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
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
      for (int i = 0; i < RPL; ++i)
        j[b][i] = (q[b][i] != KEY_NONE && a[b][i] < N
                   && __ldg(in_keys + a[b][i]) == q[b][i]) ? a[b][i] : -1;
  }
};

// src[k][r] for every tap and row of the tile; taps[k] = whether any row
// of the tile has a source for tap k.  Warp w takes taps w, w + WARPS, ...
template <class Lookup>
__device__ void find_sources(const Lookup& lookup, int* src, int* taps,
                             int row0, int R, int K) {
  const int lane = threadIdx.x & 31;
  for (int k0 = threadIdx.x >> 5; k0 < K; k0 += WARPS * TB) {
    int k[TB], j[TB][RPL];
#pragma unroll
    for (int b = 0; b < TB; ++b) k[b] = k0 + b * WARPS;
    lookup.warp_rows(k, K, row0 + lane, R, j);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (k[b] >= K) break;
      bool any = false;
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        src[k[b] * TILE_R + lane + 32 * i] = j[b][i];
        any |= j[b][i] >= 0;
      }
      any = __any_sync(FULL, any);
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

  find_sources(lookup, src, taps, row0, R, K);
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

template <class Kernel, class... Args>
int launch(Kernel kernel, int B, int R, int K, int Cin, int Cout,
           cudaStream_t stream, Args... args) {
  const size_t smem = Layout(Cin).bytes(K, Cout);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((R + TILE_R - 1) / TILE_R, B);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Shared-memory bytes a launch at (K, Cin, Cout) asks for; the wrapper
// holds it against the 227 KB a block may have.
extern "C" int sparse_gemm_smem_bytes(int K, int Cin, int Cout) {
  return (int)Layout(Cin).bytes(K, Cout);
}

#define DISPATCH_COUT(KERNEL, ...)                                        \
  switch (Cout) {                                                         \
    case 8: return launch(KERNEL<8>, __VA_ARGS__);                        \
    case 16: return launch(KERNEL<16>, __VA_ARGS__);                      \
    case 32: return launch(KERNEL<32>, __VA_ARGS__);                      \
    case 64: return launch(KERNEL<64>, __VA_ARGS__);                      \
    case 128: return launch(KERNEL<128>, __VA_ARGS__);                    \
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
  DISPATCH_COUT(gather_gemm_kernel, B, R, K, Cin, Cout, stream, feats, idx,
                found, W, out, N, R, K, Cin, vec_a, vec_w)
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
  DISPATCH_COUT(keymatch_gemm_kernel, B, R, K, Cin, Cout, stream, feats,
                in_keys, q_keys, sorted_flag, W, out, N, R, K, Cin, vec_a,
                vec_w)
}
