// The backward of the sparse-convolution joins (gather-GEMM and key-match
// GEMM), over a rulebook (idx, found) [B, K, R] of the join.
//
// Replaces the backward of the TPU kernels' custom_vjp in
//   automatic_as_built_reconstruction_tpu/ops/pallas/sparse_gather_gemm.py
//   _gather_gemm_bwd (:411) and _keymatch_bwd (:1237), which the key-match
// form reaches after ops/sparse_conv.py::_merge_lookup (:345) has turned
// its keys into (idx, found).  The JAX package leaves that body to XLA (a
// masked scatter-add and per-tap GEMMs); here it is two routes:
//
//   dW[k]       = sum_{b,r} found[b,k,r] * feats[b, idx[b,k,r]]^T dout[b,r]
//   dfeats[b,j] = sum_{k,r: idx[b,k,r] = j} found[b,k,r] * dout[b,r] W[k]^T
//
// with idx clipped to [0, N) where found, as the reference clips it.
//
// dW: the hits of each tap, then a reduction GEMM per tap on the tensor
// cores.
//   1. tap_hits_count_kernel + tap_hits_write_kernel compact the rulebook:
//      for each tap k, the int2 pairs (feature row b * N + j, dout row
//      b * R + r) of its hits in ascending dout row, at hits[k * B * R ..],
//      and their number counts[k].  Blocks of HIT_CHUNK rows of one tap:
//      the first kernel counts a block's hits, the second sums the counts
//      of the blocks before it (integers: exact in any order), then lists
//      its hits in row order by a scan of its threads' counts (each
//      thread's HIT_ROWS flags and entries loaded at once).  Nothing goes
//      back to the host: the grid is sized from the shape, the counts stay
//      on the device.
//   2. tap_grad_mma_kernel: block (k, p) takes part p of tap k's hits, a
//      fixed share [p * n / P, (p + 1) * n / P) of its n hits, P from the
//      shape alone, and computes partial[k, p] = A^T D over them, A the
//      gathered feature rows and D the gathered dout rows (a block takes a
//      64 x 64 tile of the Cin x Cout output; Cin or Cout of 128: two).
//      The hits stream through a ring of STAGES stages of CH hits each:
//      16-byte cp.async copies of both rows, zero-filled past the part's
//      end; the pairs of a chunk arrive by cp.async STAGES - 1 chunks
//      before its rows, so no copy waits on a load of its own address.
//      The products are mma.sync m16n8k8 TF32 in the 3xTF32 split of
//      csrc/sparse_gather_gemm.cu (split, mma): the output's rows are the
//      reduction's M (Cin), its columns N (Cout), the hits K.  A is read
//      transposed from rows of the gathered features, so a shared row is
//      padded to 8 or 24 floats mod 32 (pad_stride): the fragment's lanes
//      (hit t, channel g) then fall on 32 distinct banks; D alike.  Each
//      k-step of 8 hits adds its three mmas, started from zero, into the
//      fp32 accumulators by a round-to-nearest add, as the forward tile
//      does.  Four warps a block; where the output tile is smaller than
//      four warp tiles of 32 x 32, the warps split the k-steps of a stage
//      (SK) and add their sums in warp order at the end.  P: about
//      GW_BLOCKS = 32 blocks an SM in all, so that the taps of one stretch
//      of rows run side by side and share its rows in L2.
//      tap_grad_sum_kernel adds the P partials of a tap in ascending p.
//   Every width takes this path: Cin pads to 16, 32 or 64 rows (the first
//   join's Cin = 4 to one m-tile of 16, zeros), Cout to 8, 16, 32 or 64
//   columns; rows of a width that is not a multiple of 4 copy as 4-byte
//   chunks.
//   wgmma: Hopper's TF32 wgmma reads both operands K-major from shared
//   memory (only 16-bit types may be transposed), and here K runs along
//   the gathered rows: A and D would have to be transposed in shared
//   memory after every copy (CH x Cin and CH x Cout floats a stage) before
//   a warpgroup could take them.  mma.sync reads them as copied.
//
// dfeats: the rulebook's inverse, then a kernel that multiplies only the
// rows that hit.
//   3. rulebook_inverse_kernel: a convolution's rulebook takes each input
//      row at most once per tap (a submanifold output row r reads site
//      r + offset_k, a strided one reads o * stride + k - pad), so it
//      inverts: inv[b, k, idx[b,k,r]] = r where found, -1 elsewhere (the
//      wrapper clears it).  An entry that finds its slot taken (a rulebook
//      that is not a convolution's, whose dfeats would be wrong) is counted
//      into *collisions, which the wrapper exposes.
//   4. grad_features_kernel: a block takes TJ = 128 input rows j of one
//      batch element (64 at Cin = 128).  For each tap its warps ballot
//      over inv[b, k, j] (four taps' loads in flight at once) and list the
//      rows that have a source, and that source, in row order; the hits
//      of the tile's taps, in ascending tap order, are cut into units of
//      up to UNIT = 32 (two 16-row fragments).  Two stages of cp.async
//      copies: while unit u waits for its rows and is multiplied, unit
//      u + 1's dout rows are copied (only the hits' rows, the last
//      fragment zero-filled), and W[k] once a tap, into the W stage of the
//      tap's parity.  Each warp multiplies the unit's fragments by its
//      quarter of W[k]^T's columns (mma.sync m16n8k8, the 3xTF32 split;
//      W[k] read as stored, its rows Cout + 4 floats apart, which puts the
//      fragment's lanes on 32 banks), and adds each product row into that
//      input row's fp32 sum in shared memory.  Within a tap no two hits
//      are one input row (the rulebook reads a row at most once per tap),
//      and the units follow each other in order behind a barrier: each
//      row's sum is taken in ascending tap order, with no atomics.  A tap
//      no row of the tile hits costs its lookups only; rows that miss take
//      no tensor-core work beyond the last fragment's padding.
//      Where the time goes: join_grad_ablation.py (PERF.md).
//
// Determinism: no float atomics anywhere; the parts of a tap, the warps
// of a block and the taps of a row are added in a fixed order, P depends
// on the shape alone, so the same inputs give the same bits on every run.
//
// Bounds (chip_smoke.py::join_bound): each half reads its inputs once and
// writes its output once (bytes), or does 2 * hits * Cin * Cout flops at
// the 3xTF32 rate; at the SECOND joins the bytes bound.  A per-tap design
// reads a gathered row once per hit, not once: its own floor is
// hits * (Cin + Cout) * 4 bytes for dW and hits * Cout * 4 + the dfeats
// written for dfeats, which chip_smoke.py prints beside the bound.
#include <cuda_runtime.h>
#include <stdint.h>

// The tuning constants below, each overridable with -D at build time
// (join_grad_ablation.py builds its variants so); the port builds the
// defaults.
#ifndef JG_CH
#define JG_CH 32
#endif
#ifndef JG_GW_BLOCKS_PER_SM
#define JG_GW_BLOCKS_PER_SM 32
#endif
#ifndef JG_GF_WARPS
#define JG_GF_WARPS 4
#endif
#ifndef JG_UNIT
#define JG_UNIT 32
#endif
#ifndef JG_GF_TJ
#define JG_GF_TJ 128
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---- PTX wrappers (as in csrc/sparse_gather_gemm.cu) ---------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
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
// zero), small the rest as fp32 bits, of which the tensor core reads the
// top 19 (x to ~2^-21)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a (16 x 8, row) @ b (8 x 8, col), TF32 in, fp32 out
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a_small b_big + a_big b_small + a_big b_big, from zero: 3xTF32
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bs0, uint32_t bb1,
                                     uint32_t bs1) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

// Where row h of a copy comes from: entry h of a list (.x or .y of a pair,
// or an int), or row h itself
struct PairRow {
  const int2* p;
  bool second;
  __device__ long long operator()(int h) const {
    return second ? p[h].y : p[h].x;
  }
};
struct ListRow {
  const int* p;
  __device__ long long operator()(int h) const { return p[h]; }
};
struct SameRow {
  __device__ long long operator()(int h) const { return h; }
};

// Rows h < rows of a stage by cp.async: dst[h * ld + e q] <- src[row(h) *
// stride + e q] for the w chunks q of e floats a row (e = 4: 16-byte
// copies, else 4-byte ones), zeros where h >= valid.  Thread i takes
// chunks i, i + THREADS, ..., stepped without a division.
template <int THREADS, class Row>
__device__ __forceinline__ void gather_rows(float* dst, int ld, int rows,
                                            int valid,
                                            const float* __restrict__ src,
                                            long long stride, int w,
                                            bool vec, Row row) {
  const int dr = THREADS / w, dq = THREADS - dr * w;
  for (int h = threadIdx.x / w, q = threadIdx.x % w; h < rows;) {
    const bool ok = h < valid;
    const float* from = src + (ok ? row(h) : 0) * stride;
    if (vec)
      cp_async16(dst + h * ld + 4 * q, from + 4 * q, ok);
    else
      cp_async4(dst + h * ld + q, from + q, ok);
    h += dr;
    q += dq;
    if (q >= w) {
      q -= w;
      ++h;
    }
  }
}

__device__ __forceinline__ int block_sum(int v, int* scratch) {
  // scratch: one int a warp; every thread gets the sum
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = __reduce_add_sync(FULL, v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// ---- 1. the hits of each tap ---------------------------------------------

constexpr int HIT_THREADS = 256;
constexpr int HIT_ROWS = 8;           // rows a thread takes
constexpr int HIT_CHUNK = HIT_THREADS * HIT_ROWS;   // rows g = b * R + r a block

// found / idx offset of row g of tap k ([B, K, R])
__device__ __forceinline__ long long entry(int g, int k, int K, int R) {
  const int b = g / R;
  return ((long long)b * K + k) * R + (g - b * R);
}

__global__ void __launch_bounds__(HIT_THREADS)
tap_hits_count_kernel(const uint8_t* __restrict__ found,
                      int* __restrict__ chunk_counts, int BR, int K, int R,
                      int C) {
  __shared__ int scratch[HIT_THREADS / 32];
  const int c = blockIdx.x, k = blockIdx.y;
  int n = 0;
#pragma unroll
  for (int u = 0; u < HIT_ROWS; ++u) {
    const int g = c * HIT_CHUNK + u * HIT_THREADS + threadIdx.x;
    n += g < BR && found[entry(g, k, K, R)];
  }
  n = block_sum(n, scratch);
  if (threadIdx.x == 0) chunk_counts[(size_t)k * C + c] = n;
}

// Thread t lists rows HIT_ROWS t .. HIT_ROWS t + HIT_ROWS - 1 of its
// block's chunk: their flags and entries loaded at once, then one scan of
// the threads' counts places them
__global__ void __launch_bounds__(HIT_THREADS)
tap_hits_write_kernel(const int* __restrict__ idx,
                      const uint8_t* __restrict__ found,
                      const int* __restrict__ chunk_counts,
                      int2* __restrict__ hits, int* __restrict__ counts,
                      int BR, int K, int R, int N, int C) {
  __shared__ int scratch[HIT_THREADS / 32];
  __shared__ int warp_hits[HIT_THREADS / 32];
  const int c = blockIdx.x, k = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = c * HIT_CHUNK + HIT_ROWS * threadIdx.x;
  bool hit[HIT_ROWS];
  int j[HIT_ROWS];
  int mine = 0;
#pragma unroll
  for (int u = 0; u < HIT_ROWS; ++u) {
    const int g = g0 + u;
    const long long e = g < BR ? entry(g, k, K, R) : 0;
    hit[u] = g < BR && found[e];
    j[u] = g < BR ? idx[e] : 0;       // in flight with the flags
    mine += hit[u];
  }
  int before = 0;
  for (int i = threadIdx.x; i < c; i += HIT_THREADS)
    before += chunk_counts[(size_t)k * C + i];
  const int base = block_sum(before, scratch);
  int incl = mine;                    // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_hits[warp] = incl;
  __syncthreads();
  int pos = base + incl - mine, total = 0;
#pragma unroll
  for (int w = 0; w < HIT_THREADS / 32; ++w) {
    pos += w < warp ? warp_hits[w] : 0;
    total += warp_hits[w];
  }
  int2* out = hits + (size_t)k * BR;
#pragma unroll
  for (int u = 0; u < HIT_ROWS; ++u)
    if (hit[u]) {
      const int g = g0 + u;
      out[pos++] = make_int2((g / R) * N + min(max(j[u], 0), N - 1), g);
    }
  if (c == C - 1 && threadIdx.x == 0) counts[k] = base + total;
}

// ---- 2. dW: the per-tap reduction GEMM -----------------------------------

constexpr int GW_WARPS = 4;
constexpr int GW_THREADS = GW_WARPS * 32;
constexpr int CH = JG_CH;             // hits a stage: four k-steps of 8
constexpr int STAGES = 3;
constexpr int PSLOTS = 2 * STAGES;    // chunks of pairs in shared memory
constexpr int GW_BLOCKS = JG_GW_BLOCKS_PER_SM * 132;  // a launch, about (P)

// a shared row of n floats (n a multiple of 8): padded to 8 or 24 mod 32,
// so that rows t = 0..3 at columns g = 0..7 fall on 32 distinct banks
__host__ __device__ constexpr int pad_stride(int n) {
  return n + (n % 16 == 0 ? 8 : 16);
}

// a block's output tile: MT rows of Cin (16, 32, 64) x NT columns of
// Cout (8, 16, 32, 64); the four warps as WTM x WTN warp tiles of WM x WN,
// SK warps on each (splitting the k-steps)
template <int MT, int NT>
struct GradW {
  static constexpr int WM = MT < 32 ? MT : 32, WN = NT < 32 ? NT : 32;
  static constexpr int WTM = MT / WM, WTN = NT / WN;
  static constexpr int SK = GW_WARPS / (WTM * WTN);
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int LDA = pad_stride(MT), LDD = pad_stride(NT);
  static constexpr int STAGE = CH * (LDA + LDD);       // floats
  static constexpr size_t bytes() {
    return (size_t)STAGES * STAGE * 4 + (size_t)PSLOTS * CH * 8;
  }
  static_assert(SK * WTM * WTN == GW_WARPS, "four warps");
  static_assert(SK * MT * NT <= STAGES * STAGE, "the sums fit the ring");
};

// Issue the copies of chunk c: its feature rows (columns [ci0, ci0 + ca)
// of Cin) and dout rows (columns [co0, co0 + cd) of Cout), zeros past the
// part's nh hits
template <int MT, int NT>
__device__ __forceinline__ void gw_load(float* As, const int2* pairs, int hb,
                                        int nh,
                                        const float* __restrict__ feats,
                                        const float* __restrict__ dout,
                                        int Cin, int Cout, int ci0, int co0,
                                        int ca, int cd, bool vec_f,
                                        bool vec_d) {
  using G = GradW<MT, NT>;
  gather_rows<GW_THREADS>(As, G::LDA, CH, nh - hb, feats + ci0, Cin,
                          vec_f ? ca / 4 : ca, vec_f, PairRow{pairs, false});
  gather_rows<GW_THREADS>(As + CH * G::LDA, G::LDD, CH, nh - hb,
                          dout + co0, Cout, vec_d ? cd / 4 : cd, vec_d,
                          PairRow{pairs, true});
}

// The pairs of chunk c (CH of them, zeros past nh) into their slot
__device__ __forceinline__ void gw_load_pairs(int2* slot, const int2* list,
                                              int c, int nh) {
  if (threadIdx.x < CH) {
    const int h = c * CH + threadIdx.x;
    cp_async8(slot + threadIdx.x, list + (h < nh ? h : 0), h < nh);
  }
}

// acc += the warp's k-steps of one stage: A^T (MT x CH) @ D (CH x NT)
template <int MT, int NT>
__device__ __forceinline__ void gw_multiply(
    float (&acc)[GradW<MT, NT>::MI][GradW<MT, NT>::NI][4], const float* As,
    int wk, int m0, int n0) {
  using G = GradW<MT, NT>;
  const float* Ds = As + CH * G::LDA;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < CH / 8 / G::SK; ++i) {   // a known count: unrolled
    const int h = (wk + i * G::SK) * 8 + t;
    // A = feats^T: (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    // is channel m0 + 16 mi + g (+ 8) of hit h (+ 4)
    uint32_t ab[G::MI][4], as[G::MI][4];
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
      const float* a = As + h * G::LDA + m0 + 16 * mi + g;
      split(a[0], ab[mi][0], as[mi][0]);
      split(a[8], ab[mi][1], as[mi][1]);
      split(a[4 * G::LDA], ab[mi][2], as[mi][2]);
      split(a[4 * G::LDA + 8], ab[mi][3], as[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni) {
      // B = D: (k = t, n = g), (k = t + 4, n = g)
      const float* d = Ds + h * G::LDD + n0 + 8 * ni + g;
      uint32_t bb0, bs0, bb1, bs1;
      split(d[0], bb0, bs0);
      split(d[4 * G::LDD], bb1, bs1);
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        float p[4];
        mma3(p, ab[mi], as[mi], bb0, bs0, bb1, bs1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += p[e];
      }
    }
  }
}

// block (k, p, z): partial[k, p] over part p of tap k's hits, the output
// tile z (mb = z / nb along Cin, z % nb along Cout)
template <int MT, int NT>
__global__ void __launch_bounds__(GW_THREADS)
tap_grad_mma_kernel(const float* __restrict__ feats,
                    const float* __restrict__ dout,
                    const int2* __restrict__ hits,
                    const int* __restrict__ counts,
                    float* __restrict__ partial, int BR, int Cin, int Cout,
                    int P, int nb, bool vec_f, bool vec_d) {
  using G = GradW<MT, NT>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);              // [STAGES][STAGE]
  int2* pairs = reinterpret_cast<int2*>(ring + STAGES * G::STAGE);  // [PSLOTS][CH]
  const int k = blockIdx.x, p = blockIdx.y;
  const int ci0 = (blockIdx.z / nb) * MT, co0 = (blockIdx.z % nb) * NT;
  const int ca = min(MT, Cin - ci0), cd = min(NT, Cout - co0);
  const long long n = counts[k];
  const long long h0 = n * p / P, h1 = n * (p + 1) / P;
  const int nh = (int)(h1 - h0), nch = (nh + CH - 1) / CH;
  const int2* list = hits + (size_t)k * BR + h0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the column padding of every stage: the copies never write there
  for (int i = threadIdx.x; i < STAGES * CH * (MT - ca); i += GW_THREADS) {
    const int row = i / (MT - ca);
    ring[(row / CH) * G::STAGE + (row % CH) * G::LDA + ca + i % (MT - ca)] =
        0.f;
  }
  for (int i = threadIdx.x; i < STAGES * CH * (NT - cd); i += GW_THREADS) {
    const int row = i / (NT - cd);
    ring[(row / CH) * G::STAGE + CH * G::LDA + (row % CH) * G::LDD + cd
         + i % (NT - cd)] = 0.f;
  }

  const int wr = warp % (G::WTM * G::WTN), wk = warp / (G::WTM * G::WTN);
  const int m0 = (wr / G::WTN) * G::WM, n0 = (wr % G::WTN) * G::WN;
  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  // the pairs of the first STAGES - 1 chunks, then their rows, each group
  // with the pairs of the chunk STAGES - 1 further on
  for (int c = 0; c < STAGES - 1 && c < nch; ++c)
    gw_load_pairs(pairs + (c % PSLOTS) * CH, list, c, nh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nch) {
      gw_load<MT, NT>(ring + c * G::STAGE, pairs + (c % PSLOTS) * CH,
                      c * CH, nh, feats, dout, Cin, Cout, ci0, co0, ca, cd,
                      vec_f, vec_d);
      const int cp = c + STAGES - 1;
      if (cp < nch) gw_load_pairs(pairs + (cp % PSLOTS) * CH, list, cp, nh);
    }
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<STAGES - 2>();      // chunk c (and the pairs of c + S - 1)
    __syncthreads();                  // ... for every thread; stage of c - 1 free
    const int cn = c + STAGES - 1;
    if (cn < nch) {
      gw_load<MT, NT>(ring + (cn % STAGES) * G::STAGE,
                      pairs + (cn % PSLOTS) * CH, cn * CH, nh, feats, dout,
                      Cin, Cout, ci0, co0, ca, cd, vec_f, vec_d);
      const int cp = cn + STAGES - 1;
      if (cp < nch) gw_load_pairs(pairs + (cp % PSLOTS) * CH, list, cp, nh);
    }
    cp_async_commit();
    gw_multiply<MT, NT>(acc, ring + (c % STAGES) * G::STAGE, wk, m0, n0);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the SK warps of a warp tile add their sums in warp order
  float* sums = ring;                                         // [SK][MT][NT]
  {
    const int g = lane >> 2, t = lane & 3;
    float* mine = sums + wk * MT * NT;
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const int row = m0 + 16 * mi + g, col = n0 + 8 * ni + 2 * t;
        mine[row * NT + col] = acc[mi][ni][0];
        mine[row * NT + col + 1] = acc[mi][ni][1];
        mine[(row + 8) * NT + col] = acc[mi][ni][2];
        mine[(row + 8) * NT + col + 1] = acc[mi][ni][3];
      }
  }
  __syncthreads();
  float* out = partial + ((size_t)k * P + p) * Cin * Cout;
  for (int e = threadIdx.x; e < MT * NT; e += GW_THREADS) {
    const int row = e / NT, col = e - row * NT;
    if (row < ca && col < cd) {
      float s = sums[e];
#pragma unroll
      for (int w = 1; w < G::SK; ++w) s += sums[w * MT * NT + e];
      out[(size_t)(ci0 + row) * Cout + co0 + col] = s;
    }
  }
}

// dW[k, e] = sum_{p < P} partial[k, p, e], in ascending p
__global__ void tap_grad_sum_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dW, int K, int P,
                                    int CC) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)K * CC) return;
  const long long k = t / CC, e = t - k * CC;
  const float* in = partial + k * P * CC + e;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += in[(size_t)p * CC];
  dW[t] = s;
}

// ---- 3. the rulebook's inverse -------------------------------------------

constexpr int INV_THREADS = 256;

__global__ void rulebook_inverse_kernel(const int* __restrict__ idx,
                                        const uint8_t* __restrict__ found,
                                        int* __restrict__ inv,
                                        int* __restrict__ collisions,
                                        long long entries, int R, int N) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < entries; e += (long long)gridDim.x * blockDim.x) {
    if (!found[e]) continue;
    const long long bk = e / R;       // b * K + k
    const int r = (int)(e - bk * R);
    const int j = min(max(idx[e], 0), N - 1);
    if (atomicCAS(inv + bk * N + j, -1, r) != -1) atomicAdd(collisions, 1);
  }
}

// ---- 4. dfeats: the rows that hit, by tap ----------------------------------

constexpr int GF_WARPS = JG_GF_WARPS, GF_THREADS = GF_WARPS * 32;
constexpr int UNIT = JG_UNIT;         // hit rows a stage: two fragments
constexpr int GF_STAGES = 2;         // unit u + 1 in flight while u waits
constexpr int UNIT_BITS = 9;          // a unit: (k << 10) | (W stage << 9) | h0
constexpr int GF_TB = 4;              // taps a warp looks up at once
constexpr int GF_TJ = JG_GF_TJ;       // input rows a block (half at 128)

// TJ input rows a block (128; 64 at CIN = 128); CIN (8 .. 128) the
// output's width.  Shared memory: two stages of W[k] [CIN][ld] (a tap's
// units share its stage) and GF_STAGES of UNIT hit rows [UNIT][ld] (ld =
// Cout rounded up to 8, + 4), the sums
// [TJ][LACC]; the sources [K][TJ] and the units [K * TJ / UNIT + 1] as
// ints, the counts [K]; the rows [K][TJ] as bytes
template <int CIN, int TJ>
struct GradF {
  static constexpr int RPL = TJ / 32, NT = CIN / 8, LACC = CIN + 4;
  // the warps split a unit's n-tiles WN ways (NTW each) and its
  // fragments WF ways (up to FPW each)
  static constexpr int WN = NT < GF_WARPS ? NT : GF_WARPS;
  static constexpr int WF = GF_WARPS / WN, NTW = NT / WN;
  static constexpr int FPW = (UNIT / 16 + WF - 1) / WF;
  static_assert(TJ <= 256 && TJ < (1 << UNIT_BITS),
                "a row of the tile fits a byte and a unit's h0 its bits");
  static_assert(FPW <= 4, "at most four fragments a warp");
  static size_t bytes(int K, int Cout) {
    const int ld = (Cout + 7) / 8 * 8 + 4;
    return ((size_t)(2 * CIN + GF_STAGES * UNIT) * ld + (size_t)TJ * LACC)
               * 4
           + ((size_t)K * TJ + (size_t)K * (TJ / UNIT) + 1 + K) * 4
           + (size_t)K * TJ;
  }
};

// Issue the copies of one unit: the dout rows of hits [h0, h0 + UNIT) of
// the tap's nk into Ds, zero rows past nk up to a multiple of 16, and
// where the unit is its tap's first (h0 = 0) W[k] (CIN x Cout) into Ws
template <int CIN>
__device__ __forceinline__ void gf_load(float* Ws, float* Ds,
                                        const float* __restrict__ Wk,
                                        const float* __restrict__ doutb,
                                        const int* src, int h0, int nk,
                                        int Cout, int ld, bool vec_d,
                                        bool vec_w) {
  if (h0 == 0)
    gather_rows<GF_THREADS>(Ws, ld, CIN, CIN, Wk, Cout,
                            vec_w ? Cout / 4 : Cout, vec_w, SameRow{});
  const int n = min(UNIT, nk - h0);
  gather_rows<GF_THREADS>(Ds, ld, (n + 15) / 16 * 16, n, doutb, Cout,
                          vec_d ? Cout / 4 : Cout, vec_d, ListRow{src + h0});
}

// sums[the rows of FR fragments f, f + WF, ...] += their dout rows (16 x
// kp each) @ W[k]^T at the warp's NTW n-tiles from n-tile nt0; fragment
// row i is hit h0 + 16 f + i of the tap, input row rows[h0 + 16 f + i] of
// the tile where below nk.  The FR x NTW products are independent, so
// their mma chains overlap.
template <int CIN, int TJ, int FR>
__device__ __forceinline__ void gf_multiply(float* sums, const float* Ws,
                                            const float* Ds,
                                            const unsigned char* rows,
                                            int h0, int nk, int f, int nt0,
                                            int kp, int ld) {
  using G = GradF<CIN, TJ>;
  constexpr int NTW = G::NTW;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[FR][NTW][4];
#pragma unroll
  for (int fr = 0; fr < FR; ++fr)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      acc[fr][j][0] = acc[fr][j][1] = acc[fr][j][2] = acc[fr][j][3] = 0.f;
  const float* a = Ds + (16 * f + g) * ld + t;
  const float* b = Ws + (8 * nt0 + g) * ld + t;
  for (int k0 = 0; k0 < kp; k0 += 8) {
    // A = the dout rows: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    uint32_t ab[FR][4], as[FR][4];
#pragma unroll
    for (int fr = 0; fr < FR; ++fr) {
      const float* af = a + 16 * G::WF * fr * ld + k0;
      split(af[0], ab[fr][0], as[fr][0]);
      split(af[8 * ld], ab[fr][1], as[fr][1]);
      split(af[4], ab[fr][2], as[fr][2]);
      split(af[8 * ld + 4], ab[fr][3], as[fr][3]);
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      // B = W[k]^T: (k = t, n = g) is W[k][8 (nt0 + j) + g][k0 + t]
      const float* bj = b + 8 * j * ld + k0;
      uint32_t bb0, bs0, bb1, bs1;
      split(bj[0], bb0, bs0);
      split(bj[4], bb1, bs1);
#pragma unroll
      for (int fr = 0; fr < FR; ++fr) {
        float p[4];
        mma3(p, ab[fr], as[fr], bb0, bs0, bb1, bs1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[fr][j][e] += p[e];
      }
    }
  }
  // C fragment: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
  for (int fr = 0; fr < FR; ++fr) {
    const int i0 = h0 + 16 * (f + G::WF * fr) + g, i1 = i0 + 8;
    float* s0 = sums + (i0 < nk ? rows[i0] : 0) * G::LACC + 8 * nt0 + 2 * t;
    float* s1 = sums + (i1 < nk ? rows[i1] : 0) * G::LACC + 8 * nt0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (i0 < nk) {
        s0[8 * j] += acc[fr][j][0];
        s0[8 * j + 1] += acc[fr][j][1];
      }
      if (i1 < nk) {
        s1[8 * j] += acc[fr][j][2];
        s1[8 * j + 1] += acc[fr][j][3];
      }
    }
  }
}

// By one warp: the counts of the K taps -> units[0, n) the units of work
// in ascending tap order, (k << 10) | (o % 2 << 9) | h0 for hits [h0, h0
// + UNIT) of tap k, the o-th tap with a hit (its W stage o % 2), and
// units[cap] = n
__device__ void list_units(const int* cnt, int* units, int K, int cap) {
  const int lane = threadIdx.x & 31;
  int n = 0, o = 0;
  for (int base = 0; base < K; base += 32) {
    const int k = base + lane;
    const int u = k < K ? (cnt[k] + UNIT - 1) / UNIT : 0;
    int before = u;                   // inclusive scan over the lanes
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(FULL, before, d);
      if (lane >= d) before += v;
    }
    const unsigned m = __ballot_sync(FULL, u > 0);
    const int par = (o + __popc(m & ((1u << lane) - 1))) & 1;
    for (int i = 0; i < u; ++i)
      units[n + before - u + i] =
          (k << (UNIT_BITS + 1)) | (par << UNIT_BITS) | (i * UNIT);
    n += __shfl_sync(FULL, before, 31);
    o += __popc(m);
  }
  if (lane == 0) units[cap] = n;
}

template <int CIN, int TJ>
__global__ void __launch_bounds__(GF_THREADS)
grad_features_kernel(const float* __restrict__ dout,
                     const int* __restrict__ inv,
                     const float* __restrict__ W,
                     float* __restrict__ dfeats, int N, int R, int K,
                     int Cout, bool vec_d, bool vec_w) {
  using G = GradF<CIN, TJ>;
  extern __shared__ float4 smem4[];
  const int kp = (Cout + 7) / 8 * 8, ld = kp + 4;
  const int cap = K * (TJ / UNIT);
  float* ring = reinterpret_cast<float*>(smem4);   // W [2][CIN][ld]
  float* Drows = ring + 2 * CIN * ld;              // [GF_STAGES][UNIT][ld]
  float* sums = Drows + GF_STAGES * UNIT * ld;     // [TJ][LACC]
  int* src = reinterpret_cast<int*>(sums + TJ * G::LACC);   // [K][TJ]
  int* units = src + K * TJ;                       // [cap + 1]
  int* cnt = units + cap + 1;                      // [K]
  unsigned char* rows = reinterpret_cast<unsigned char*>(cnt + K);  // [K][TJ]
  const int b = blockIdx.y, j0 = blockIdx.x * TJ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* doutb = dout + (size_t)b * R * Cout;
  const int* invb = inv + (size_t)b * K * N;

  for (int i = threadIdx.x; i < TJ * G::LACC; i += GF_THREADS) sums[i] = 0.f;
  // the k padding (columns [Cout, kp)) of every stage's W and rows
  const int pad = kp - Cout;
  for (int i = threadIdx.x; i < (2 * CIN + GF_STAGES * UNIT) * pad;
       i += GF_THREADS)
    ring[(i / pad) * ld + Cout + i % pad] = 0.f;

  // the rows of the tile that have a source at tap k, in row order: warp
  // w takes taps w, w + GF_WARPS, ..., GF_TB of them at once, all their
  // loads issued before the first ballot
  for (int k0 = warp; k0 < K; k0 += GF_WARPS * GF_TB) {
    int r[GF_TB][G::RPL];
#pragma unroll
    for (int q = 0; q < GF_TB; ++q)
#pragma unroll
      for (int i = 0; i < G::RPL; ++i) {
        const int k = k0 + q * GF_WARPS, j = j0 + lane + 32 * i;
        r[q][i] = (k < K && j < N) ? __ldg(invb + (size_t)k * N + j) : -1;
      }
#pragma unroll
    for (int q = 0; q < GF_TB; ++q) {
      const int k = k0 + q * GF_WARPS;
      if (k >= K) break;
      int n = 0;
#pragma unroll
      for (int i = 0; i < G::RPL; ++i) {
        const unsigned m = __ballot_sync(FULL, r[q][i] >= 0);
        if (r[q][i] >= 0) {
          const int pos = n + __popc(m & ((1u << lane) - 1));
          src[k * TJ + pos] = r[q][i];
          rows[k * TJ + pos] = (unsigned char)(lane + 32 * i);
        }
        n += __popc(m);
      }
      if (lane == 0) cnt[k] = n;
    }
  }
  __syncthreads();
  if (warp == 0) list_units(cnt, units, K, cap);
  __syncthreads();
  const int nu = units[cap];

  // two stages over the units: unit u + 1 is copied while unit u waits
  // for its copies and is multiplied; W[k] once a tap, into the stage of
  // the tap's parity (the last tap's units are done by then)
  const int hmask = (1 << UNIT_BITS) - 1;
  for (int u = -1; u < nu; ++u) {
    if (u + 1 < nu) {
      const int v = units[u + 1], k = v >> (UNIT_BITS + 1);
      gf_load<CIN>(ring + ((v >> UNIT_BITS) & 1) * CIN * ld,
                   Drows + ((u + 1) & 1) * UNIT * ld,
                   W + (size_t)k * CIN * Cout, doutb, src + k * TJ,
                   v & hmask, cnt[k], Cout, ld, vec_d, vec_w);
      cp_async_commit();
    }
    if (u < 0) continue;
    if (u + 1 < nu)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();                  // unit u has landed
    const int v = units[u], k = v >> (UNIT_BITS + 1), h0 = v & hmask;
    const int nk = cnt[k];
    // warp w: n-tiles from (w % WN) NTW, fragments w / WN + WF i
    const int nf = (min(UNIT, nk - h0) + 15) / 16;
    const int f = warp / G::WN, nt0 = (warp % G::WN) * G::NTW;
    const float* Ws = ring + ((v >> UNIT_BITS) & 1) * CIN * ld;
    const float* Ds = Drows + (u & 1) * UNIT * ld;
    const int mine = f < nf ? (nf - f + G::WF - 1) / G::WF : 0;
    if (mine >= 4 && G::FPW >= 4)
      gf_multiply<CIN, TJ, 4>(sums, Ws, Ds, rows + k * TJ, h0, nk, f, nt0,
                              kp, ld);
    else if (mine == 3 && G::FPW >= 3)
      gf_multiply<CIN, TJ, 3>(sums, Ws, Ds, rows + k * TJ, h0, nk, f, nt0,
                              kp, ld);
    else if (mine == 2 && G::FPW >= 2)
      gf_multiply<CIN, TJ, 2>(sums, Ws, Ds, rows + k * TJ, h0, nk, f, nt0,
                              kp, ld);
    else if (mine >= 1)
      gf_multiply<CIN, TJ, 1>(sums, Ws, Ds, rows + k * TJ, h0, nk, f, nt0,
                              kp, ld);
    __syncthreads();                  // unit u added; its stages free
  }

  for (int i = threadIdx.x; i < TJ * (CIN / 4); i += GF_THREADS) {
    const int j = i / (CIN / 4), q = i - j * (CIN / 4);
    if (j0 + j < N)
      *reinterpret_cast<float4*>(dfeats + ((size_t)b * N + j0 + j) * CIN
                                 + 4 * q) =
          *reinterpret_cast<const float4*>(sums + j * G::LACC + 4 * q);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

int grid_1d(long long n) {
  const long long blocks = (n + INV_THREADS - 1) / INV_THREADS;
  return (int)(blocks < 132LL * 32 ? blocks : 132LL * 32);
}

int round_tile(int n, int lo) {        // lo, 2 lo, ... up to 64
  int t = lo;
  while (t < n && t < 64) t *= 2;
  return t;
}

template <int MT, int NT>
int launch_grad_w(const float* feats, const float* dout, const int2* hits,
                  const int* counts, float* partial, int BR, int K, int Cin,
                  int Cout, int P, int mb, int nb, cudaStream_t stream) {
  const size_t smem = GradW<MT, NT>::bytes();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tap_grad_mma_kernel<MT, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec_f = Cin % 4 == 0 && aligned16(feats);
  const bool vec_d = Cout % 4 == 0 && aligned16(dout);
  tap_grad_mma_kernel<MT, NT><<<dim3(K, P, mb * nb), GW_THREADS, smem,
                                stream>>>(feats, dout, hits, counts, partial,
                                          BR, Cin, Cout, P, nb, vec_f,
                                          vec_d);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_grad_w_nt(int NT, const float* feats, const float* dout,
                     const int2* hits, const int* counts, float* partial,
                     int BR, int K, int Cin, int Cout, int P, int mb, int nb,
                     cudaStream_t stream) {
  switch (NT) {
    case 8: return launch_grad_w<MT, 8>(feats, dout, hits, counts, partial,
                                        BR, K, Cin, Cout, P, mb, nb, stream);
    case 16: return launch_grad_w<MT, 16>(feats, dout, hits, counts,
                                          partial, BR, K, Cin, Cout, P, mb,
                                          nb, stream);
    case 32: return launch_grad_w<MT, 32>(feats, dout, hits, counts,
                                          partial, BR, K, Cin, Cout, P, mb,
                                          nb, stream);
    case 64: return launch_grad_w<MT, 64>(feats, dout, hits, counts,
                                          partial, BR, K, Cin, Cout, P, mb,
                                          nb, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int CIN, int TJ>
int launch_grad_f(const float* dout, const int* inv, const float* W,
                  float* dfeats, int B, int N, int R, int K, int Cout,
                  cudaStream_t stream) {
  using G = GradF<CIN, TJ>;
  const size_t smem = G::bytes(K, Cout);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grad_features_kernel<CIN, TJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec_d = Cout % 4 == 0 && aligned16(dout);
  const bool vec_w = Cout % 4 == 0 && aligned16(W);
  grad_features_kernel<CIN, TJ><<<dim3((N + TJ - 1) / TJ, B), GF_THREADS,
                                  smem, stream>>>(dout, inv, W, dfeats, N, R,
                                                  K, Cout, vec_d, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- the C interface -------------------------------------------------------

// The blocks of HIT_CHUNK rows the hit lists of B * R rows take per tap;
// the wrapper sizes chunk_counts [K, C] with it.
extern "C" int tap_hits_chunks(int B, int R) {
  const long long BR = (long long)B * R;
  return (int)((BR + HIT_CHUNK - 1) / HIT_CHUNK);
}

// hits [K, B * R] int2 and counts [K] from idx / found [B, K, R] through
// chunk_counts [K, C]: the hits of tap k in ascending dout row at
// hits[k, 0 .. counts[k]); B * R and B * N below 2^31.
extern "C" int tap_hits_launch(const int* idx, const uint8_t* found,
                               int* chunk_counts, int2* hits, int* counts,
                               int B, int K, int R, int N,
                               cudaStream_t stream) {
  if (K == 0) return (int)cudaSuccess;
  const int BR = B * R, C = tap_hits_chunks(B, R);
  if (BR == 0 || N == 0)
    return (int)cudaMemsetAsync(counts, 0, (size_t)K * sizeof(int), stream);
  tap_hits_count_kernel<<<dim3(C, K), HIT_THREADS, 0, stream>>>(
      found, chunk_counts, BR, K, R, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tap_hits_write_kernel<<<dim3(C, K), HIT_THREADS, 0, stream>>>(
      idx, found, chunk_counts, hits, counts, BR, K, R, N, C);
  return (int)cudaGetLastError();
}

// The output tiles of dW along Cin (mb) and Cout (nb), and the parts P of
// a tap's hits: about GW_BLOCKS blocks in all (eight an SM), at most one
// part a chunk of CH rows.  The wrapper sizes partial [K, P, Cin, Cout].
extern "C" int tap_grad_parts(int B, int R, int K, int Cin, int Cout) {
  const int tiles = ((Cin + 63) / 64) * ((Cout + 63) / 64);
  const long long chunks = ((long long)B * R + CH - 1) / CH;
  long long P = (GW_BLOCKS + (long long)K * tiles - 1) / ((long long)K * tiles);
  if (P > chunks) P = chunks;
  return (int)(P < 1 ? 1 : P);
}

// dW [K, Cin, Cout] from feats [B, N, Cin], dout [B, R, Cout] and the hit
// lists of tap_hits_launch, through partial [K, P, Cin, Cout] (P from
// tap_grad_parts).  Cin and Cout up to 128.
extern "C" int tap_grad_launch(const float* feats, const float* dout,
                               const int2* hits, const int* counts,
                               float* partial, float* dW, int B, int N,
                               int R, int K, int Cin, int Cout,
                               cudaStream_t stream) {
  const int CC = Cin * Cout;
  if (K == 0 || CC == 0) return (int)cudaSuccess;
  if (Cin > 128 || Cout > 128) return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0 || N == 0)
    return (int)cudaMemsetAsync(dW, 0, (size_t)K * CC * sizeof(float),
                                stream);
  const int P = tap_grad_parts(B, R, K, Cin, Cout);
  const int MT = round_tile(Cin, 16), NT = round_tile(Cout, 8);
  const int mb = (Cin + MT - 1) / MT, nb = (Cout + NT - 1) / NT;
  const int BR = B * R;
  int err;
  switch (MT) {
    case 16: err = launch_grad_w_nt<16>(NT, feats, dout, hits, counts,
                                        partial, BR, K, Cin, Cout, P, mb, nb,
                                        stream); break;
    case 32: err = launch_grad_w_nt<32>(NT, feats, dout, hits, counts,
                                        partial, BR, K, Cin, Cout, P, mb, nb,
                                        stream); break;
    default: err = launch_grad_w_nt<64>(NT, feats, dout, hits, counts,
                                        partial, BR, K, Cin, Cout, P, mb, nb,
                                        stream); break;
  }
  if (err != 0) return err;
  const long long n = (long long)K * CC;
  tap_grad_sum_kernel<<<(int)((n + 255) / 256), 256, 0, stream>>>(
      partial, dW, K, P, CC);
  return (int)cudaGetLastError();
}

// inv [B, K, N] int32 from idx / found [B, K, R]: cleared here first (-1);
// *collisions (one int, the caller zeroes it) counts the entries that found
// their slot taken.
extern "C" int rulebook_inverse_launch(const int* idx, const uint8_t* found,
                                       int* inv, int* collisions, int B,
                                       int K, int R, int N,
                                       cudaStream_t stream) {
  const size_t slots = (size_t)B * K * N;
  const cudaError_t err =
      cudaMemsetAsync(inv, 0xff, slots * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const long long entries = (long long)B * K * R;
  if (entries == 0 || N == 0) return (int)cudaSuccess;
  rulebook_inverse_kernel<<<grid_1d(entries), INV_THREADS, 0, stream>>>(
      idx, found, inv, collisions, entries, R, N);
  return (int)cudaGetLastError();
}

// Shared-memory bytes grad_features_launch asks for at (K, Cin, Cout): GF_TJ
// input rows a block, half as many at Cin = 128; the wrapper holds it
// against the 227 KB a block may have.
extern "C" int grad_features_smem_bytes(int K, int Cin, int Cout) {
  switch (Cin) {
    case 8: return (int)GradF<8, GF_TJ>::bytes(K, Cout);
    case 16: return (int)GradF<16, GF_TJ>::bytes(K, Cout);
    case 32: return (int)GradF<32, GF_TJ>::bytes(K, Cout);
    case 64: return (int)GradF<64, GF_TJ>::bytes(K, Cout);
    case 128: return (int)GradF<128, GF_TJ / 2>::bytes(K, Cout);
    default: return -1;
  }
}

// dfeats [B, N, Cin] from dout [B, R, Cout], inv [B, K, N] (the inverse of
// rulebook_inverse_launch) and W [K, Cin, Cout]; Cin in 8, 16, 32, 64, 128.
extern "C" int grad_features_launch(const float* dout, const int* inv,
                                    const float* W, float* dfeats, int B,
                                    int N, int R, int K, int Cin, int Cout,
                                    cudaStream_t stream) {
  if (B == 0 || N == 0) return (int)cudaSuccess;
  switch (Cin) {
    case 8: return launch_grad_f<8, GF_TJ>(dout, inv, W, dfeats, B, N, R, K,
                                        Cout, stream);
    case 16: return launch_grad_f<16, GF_TJ>(dout, inv, W, dfeats, B, N, R, K,
                                          Cout, stream);
    case 32: return launch_grad_f<32, GF_TJ>(dout, inv, W, dfeats, B, N, R, K,
                                          Cout, stream);
    case 64: return launch_grad_f<64, GF_TJ>(dout, inv, W, dfeats, B, N, R, K,
                                          Cout, stream);
    case 128: return launch_grad_f<128, GF_TJ / 2>(dout, inv, W, dfeats, B, N, R,
                                            K, Cout, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
