// Sparse-convolution joins: gather-GEMM and key-match GEMM.
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
// is no window: one kernel per family serves all of its forms.
//
// Design.  One block of 128 threads per tile of 64 output rows (and per
// scan: blockIdx.y), a loop over the K taps inside the block.  Per tap:
//   1. 64 threads find the tile's source rows: the rulebook entry, or a
//      binary search of the query key in the sorted in_keys (<= 16 steps
//      at 61 184 rows; INT32_MAX is "no query" and never matches);
//   2. if no row of the tile has a source for this tap, the tap is
//      skipped (one __syncthreads_or);
//   3. the block copies W[k] (Cin x Cout) and the 64 source rows (zeros
//      where there is none) into shared memory;
//   4. each thread multiplies its RM rows by its 4 output columns with
//      fp32 FMAs and keeps the sums in registers over all taps.
// The product is computed here: no library call.  Output is stored once.
//
// in_keys must be ascending (sentinels last) for the binary search.  The
// wrapper computes that on the device into *sorted_flag; where it is 0
// the kernel falls back to a linear scan of in_keys, which is exact for
// any order (and slow: it is there so that no order gives a wrong
// answer, not to be fast).
//
// Bound: operations (2 * hits * Cin * Cout fp32 flops at 67 TFLOP/s)
// for the 27-tap joins at 32 and 64 channels; the bytes (features and
// output once, keys or rulebook, weights) bound only the narrow first
// layers.  What this design does about it: the tile's rows and the tap's
// weights are read from shared memory, each thread holds an RM x 4
// register tile so that one float4 of weights feeds 4*RM FMAs, and empty
// (tile, tap) pairs cost one search and no arithmetic.  Tensor cores
// (mma.sync on TF32/bf16 tiles), cp.async double buffering and larger
// tiles are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_R = 64;     // output rows per block
constexpr int THREADS = 128;
constexpr int KEY_NONE = 0x7fffffff;

// source row of (tap k, output row r) from a rulebook
struct RulebookLookup {
  const int* __restrict__ idx;        // [K, R]
  const uint8_t* __restrict__ found;  // [K, R]
  int N;
  __device__ int operator()(int k, int r, int R) const {
    const size_t o = (size_t)k * R + r;
    if (!found[o]) return -1;
    const int j = idx[o];
    return (j >= 0 && j < N) ? j : -1;
  }
};

// source row of (tap k, output row r) by searching its query key
struct KeyLookup {
  const int* __restrict__ in_keys;  // [N]
  const int* __restrict__ q_keys;   // [K, R]
  int N;
  bool sorted;
  __device__ int operator()(int k, int r, int R) const {
    const int q = q_keys[(size_t)k * R + r];
    if (q == KEY_NONE) return -1;
    if (sorted) {
      int lo = 0, hi = N;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(in_keys + mid) < q) lo = mid + 1; else hi = mid;
      }
      return (lo < N && __ldg(in_keys + lo) == q) ? lo : -1;
    }
    for (int j = 0; j < N; ++j)
      if (__ldg(in_keys + j) == q) return j;
    return -1;
  }
};

// Dynamic shared memory: W[k] [Cin][COUT], the tile's rows
// [TILE_R][Cin + 1] (odd stride: rows of one warp fall on distinct
// banks), the tile's source rows [TILE_R].
__host__ __device__ inline size_t smem_bytes(int Cin, int Cout) {
  return ((size_t)Cin * Cout + (size_t)TILE_R * (Cin + 1) + TILE_R) * 4;
}

template <int COUT, class Lookup>
__device__ void gather_gemm_tile(const float* __restrict__ feats,
                                 const float* __restrict__ W,
                                 float* __restrict__ out, int R, int K,
                                 int Cin, const Lookup& lookup) {
  constexpr int TX = COUT / 4;        // threads along the output columns
  constexpr int TY = THREADS / TX;    // threads along the rows
  constexpr int RM = TILE_R / TY;     // rows per thread
  static_assert(TX * 4 == COUT && TX * TY == THREADS && RM * TY == TILE_R,
                "COUT must be 8, 16, 32, 64 or 128");
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);
  float* As = Ws + (size_t)Cin * COUT;
  int* src = reinterpret_cast<int*>(As + TILE_R * (Cin + 1));
  const int lda = Cin + 1;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.x * TILE_R;

  float4 acc[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k = 0; k < K; ++k) {
    int any = 0;
    if (tid < TILE_R) {
      const int r = row0 + tid;
      const int j = r < R ? lookup(k, r, R) : -1;
      src[tid] = j;
      any = j >= 0;
    }
    // barrier: src is published, and every thread is done with the
    // previous tap's As and Ws
    if (!__syncthreads_or(any)) continue;
    const float* Wk = W + (size_t)k * Cin * COUT;
    for (int i = tid; i < Cin * COUT; i += THREADS) Ws[i] = __ldg(Wk + i);
    for (int i = tid; i < TILE_R * Cin; i += THREADS) {
      const int r = i / Cin, c = i - r * Cin;
      const int j = src[r];
      As[r * lda + c] = j >= 0 ? __ldg(feats + (size_t)j * Cin + c) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < Cin; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(Ws + c * COUT
                                                        + tx * 4);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = As[(ty + i * TY) * lda + c];
        acc[i].x = fmaf(a, w.x, acc[i].x);
        acc[i].y = fmaf(a, w.y, acc[i].y);
        acc[i].z = fmaf(a, w.z, acc[i].z);
        acc[i].w = fmaf(a, w.w, acc[i].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r < R)
      *reinterpret_cast<float4*>(out + (size_t)r * COUT + tx * 4) = acc[i];
  }
}

template <int COUT>
__global__ void __launch_bounds__(THREADS)
gather_gemm_kernel(const float* __restrict__ feats,
                   const int* __restrict__ idx,
                   const uint8_t* __restrict__ found,
                   const float* __restrict__ W, float* __restrict__ out,
                   int N, int R, int K, int Cin) {
  const size_t b = blockIdx.y;
  const RulebookLookup lookup{idx + b * K * R, found + b * K * R, N};
  gather_gemm_tile<COUT>(feats + b * N * Cin, W, out + b * R * COUT, R, K,
                         Cin, lookup);
}

template <int COUT>
__global__ void __launch_bounds__(THREADS)
keymatch_gemm_kernel(const float* __restrict__ feats,
                     const int* __restrict__ in_keys,
                     const int* __restrict__ q_keys,
                     const uint8_t* __restrict__ sorted_flag,
                     const float* __restrict__ W, float* __restrict__ out,
                     int N, int R, int K, int Cin) {
  const size_t b = blockIdx.y;
  const KeyLookup lookup{in_keys + b * N, q_keys + b * K * R, N,
                         *sorted_flag != 0};
  gather_gemm_tile<COUT>(feats + b * N * Cin, W, out + b * R * COUT, R, K,
                         Cin, lookup);
}

template <class Kernel, class... Args>
int launch(Kernel kernel, int B, int R, int Cin, int Cout,
           cudaStream_t stream, Args... args) {
  const size_t smem = smem_bytes(Cin, Cout);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((R + TILE_R - 1) / TILE_R, B);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes a launch at (Cin, Cout) asks for; the wrapper holds
// it against the 227 KB a block may have.
extern "C" int sparse_gemm_smem_bytes(int Cin, int Cout) {
  return (int)smem_bytes(Cin, Cout);
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
  DISPATCH_COUT(gather_gemm_kernel, B, R, Cin, Cout, stream, feats, idx,
                found, W, out, N, R, K, Cin)
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
  DISPATCH_COUT(keymatch_gemm_kernel, B, R, Cin, Cout, stream, feats,
                in_keys, q_keys, sorted_flag, W, out, N, R, K, Cin)
}
