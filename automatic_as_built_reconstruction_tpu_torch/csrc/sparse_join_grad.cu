// The backward of the sparse-convolution joins (gather-GEMM and key-match
// GEMM), over a rulebook (idx, found) [B, K, R] of the join.
//
// Replaces the backward of the TPU kernels' custom_vjp in
//   automatic_as_built_reconstruction_tpu/ops/pallas/sparse_gather_gemm.py
//   _gather_gemm_bwd (:411) and _keymatch_bwd (:1237), which the key-match
// form reaches after ops/sparse_conv.py::_merge_lookup (:345) has turned
// its keys into (idx, found).  The JAX package leaves that body to XLA (a
// masked scatter-add and per-tap GEMMs); here it is three kernels:
//
//   dW[k]     = sum_{b,r} found[b,k,r] * feats[b, idx[b,k,r]]^T dout[b,r]
//   dfeats[b,j] = sum_{k,r: idx[b,k,r] = j} found[b,k,r] * dout[b,r] W[k]^T
//
// with idx clipped to [0, N) where found, as the reference clips it.
//
// dfeats.  A convolution's rulebook takes each input row at most once per
// tap (a submanifold output row r reads site r + offset_k, a strided one
// reads o * stride + k - pad), so the rulebook inverts:
// inv[b, k, idx[b,k,r]] = r where found.  rulebook_inverse_kernel builds
// that with one thread per entry and no collisions; then the forward
// gather-GEMM kernel of csrc/sparse_gather_gemm.cu runs on (dout, inv,
// inv_found, W[k]^T) and gives dfeats as a gather, on the tensor cores
// in 3xTF32, deterministic, with no atomics and no float scatter.  An
// entry that would take a slot another entry of its tap already holds
// (a rulebook that is not a convolution's) is counted into *collisions,
// which the wrapper exposes: such a rulebook's dfeats would be wrong.
// Bound of the inversion: bytes (idx and found read, inv and inv_found
// written, the memsets included).
//
// dW.  tap_grad_partial_kernel: block (p, k) takes the rows of part p of
// tap k in order, 128 at a time: four warps list the rows that hit
// (ballots, in row order), the block copies their gathered feature rows
// and dout rows into shared memory as float4s, and each thread adds the
// products of its 4 x 4 tiles of the Cin x Cout output (two float4 reads
// for 16 fp32 FFMAs) into a sum of the pass, which then goes into the
// tile's running sum: two levels, so the error does not grow with the
// length of a part.  Each block writes its [Cin, Cout] partial;
// tap_grad_sum_kernel adds the P partials of a tap in ascending order.
// No atomics: the same inputs give the same bits on every run, P depends
// on the shape alone.  Bound: operations, 2 * hits * Cin * Cout at the
// fp32 SIMT rate (67 TFLOP/s on an H100), or bytes (hits * Cin * 4 +
// B * R * Cout * 4 + idx and found) where the widths are narrow.  This
// is a simple SIMT form, not on the tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 128;            // rows a pass of the dW block takes
constexpr unsigned FULL = 0xffffffffu;

__global__ void rulebook_inverse_kernel(const int* __restrict__ idx,
                                        const uint8_t* __restrict__ found,
                                        int* __restrict__ inv,
                                        uint8_t* __restrict__ inv_found,
                                        int* __restrict__ collisions,
                                        long long entries, int K, int R,
                                        int N) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < entries; e += (long long)gridDim.x * blockDim.x) {
    if (!found[e]) continue;
    const long long bk = e / R;       // b * K + k
    const int r = (int)(e - bk * R);
    const int j = min(max(idx[e], 0), N - 1);
    const long long slot = bk * N + j;
    if (atomicCAS(inv + slot, -1, r) == -1)
      inv_found[slot] = 1;
    else
      atomicAdd(collisions, 1);
  }
}

// Row r of a [rows, C] float array as float4 q (columns 4q .. 4q + 3),
// zero past C
__device__ __forceinline__ float4 load_quad(const float* __restrict__ row,
                                           int q, int C, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(row + 4 * q);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = 4 * q + j < C ? row[4 * q + j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// block (p, k): partial[k, p] = sum over the hit rows g of part p of
// feats[row(g)]^T dout[g], rows g = b * R + r in [g0, g1).  Each thread
// owns TPT 4 x 4 tiles of the Cin x Cout output (tile q = t + 256 u:
// rows 4 (q / co4) .., columns 4 (q % co4) ..); a pass adds its rows'
// products into a fresh 4 x 4 sum, then that into the tile's running sum
// (two levels, so a long part loses no more than a short one).
template <int TPT>
__global__ void __launch_bounds__(THREADS)
tap_grad_partial_kernel(const float* __restrict__ feats,
                        const int* __restrict__ idx,
                        const uint8_t* __restrict__ found,
                        const float* __restrict__ dout,
                        float* __restrict__ partial, int B, int N, int R,
                        int K, int Cin, int Cout, int rows_per_part,
                        bool vec_f, bool vec_d) {
  extern __shared__ float4 smem4[];
  const int ci4 = (Cin + 3) / 4, co4 = (Cout + 3) / 4;
  float4* A = smem4;                        // [CHUNK][ci4]
  float4* D = A + CHUNK * ci4;              // [CHUNK][co4]
  __shared__ long long src[CHUNK];          // feature row b * N + j
  __shared__ long long dst[CHUNK];          // dout row b * R + r
  __shared__ unsigned masks[CHUNK / 32];
  const int k = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long total = (long long)B * R;
  const long long g0 = (long long)p * rows_per_part;
  const long long g1 =
      total < g0 + rows_per_part ? total : g0 + rows_per_part;
  const int tiles = ci4 * co4;
  float acc[TPT][16];
#pragma unroll
  for (int u = 0; u < TPT; ++u)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[u][e] = 0.f;

  for (long long c0 = g0; c0 < g1; c0 += CHUNK) {
    // list the rows of this pass that hit, in row order
    bool hit = false;
    long long s = 0;
    const long long g = c0 + threadIdx.x;
    if (warp < CHUNK / 32) {
      if (g < g1) {
        const long long b = g / R, r = g - b * R;
        const long long e = (b * K + k) * R + r;
        if (found[e]) {
          hit = true;
          s = b * N + min(max(idx[e], 0), N - 1);
        }
      }
      const unsigned m = __ballot_sync(FULL, hit);
      if (lane == 0) masks[warp] = m;
    }
    __syncthreads();
    int nh = 0, before = 0;
#pragma unroll
    for (int w = 0; w < CHUNK / 32; ++w) {
      const int c = __popc(masks[w]);
      before += w < warp ? c : 0;
      nh += c;
    }
    if (hit) {
      const int pos = before + __popc(masks[warp] & ((1u << lane) - 1));
      src[pos] = s;
      dst[pos] = g;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nh * ci4; e += THREADS) {
      const int h = e / ci4;
      A[e] = load_quad(feats + src[h] * Cin, e - h * ci4, Cin, vec_f);
    }
    for (int e = threadIdx.x; e < nh * co4; e += THREADS) {
      const int h = e / co4;
      D[e] = load_quad(dout + dst[h] * Cout, e - h * co4, Cout, vec_d);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < TPT; ++u) {
      const int q = threadIdx.x + THREADS * u;
      if (q < tiles) {
        const int ti = q / co4, tc = q - ti * co4;
        float t[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) t[e] = 0.f;
        for (int h = 0; h < nh; ++h) {
          const float4 a = A[h * ci4 + ti], d = D[h * co4 + tc];
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              t[i * 4 + c] = __fmaf_rn(av[i], dv[c], t[i * 4 + c]);
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[u][e] += t[e];
      }
    }
    __syncthreads();                  // A, D, src, dst, masks free again
  }
  float* out = partial + ((size_t)k * P + p) * Cin * Cout;
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    const int q = threadIdx.x + THREADS * u;
    if (q < tiles) {
      const int ti = q / co4, tc = q - ti * co4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = 4 * ti + i, col = 4 * tc + c;
          if (row < Cin && col < Cout)
            out[row * Cout + col] = acc[u][i * 4 + c];
        }
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

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

int grid_1d(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return (int)(blocks < 132LL * 32 ? blocks : 132LL * 32);
}

template <int TPT>
int launch_partial(const float* feats, const int* idx, const uint8_t* found,
                   const float* dout, float* partial, int B, int N, int R,
                   int K, int Cin, int Cout, int P, int rows_per_part,
                   cudaStream_t stream) {
  const size_t smem =
      (size_t)CHUNK * ((Cin + 3) / 4 + (Cout + 3) / 4) * sizeof(float4);
  // above 48 KB with the kernel's 2 KB of static shared memory: opt in
  if (smem + 4096 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tap_grad_partial_kernel<TPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec_f = Cin % 4 == 0 && aligned16(feats);
  const bool vec_d = Cout % 4 == 0 && aligned16(dout);
  tap_grad_partial_kernel<TPT><<<dim3(P, K), THREADS, smem, stream>>>(
      feats, idx, found, dout, partial, B, N, R, K, Cin, Cout,
      rows_per_part, vec_f, vec_d);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of partials a tap's rows are cut into for B * R rows and K
// taps (about four blocks an SM in all), and the rows of each part (a
// multiple of CHUNK).  The wrapper sizes the partial buffer [K, P, Cin,
// Cout] with it.
extern "C" int tap_grad_parts(int B, int R, int K) {
  const long long total = (long long)B * R;
  const long long chunks = (total + CHUNK - 1) / CHUNK;
  long long P = (4LL * 132 + K - 1) / K;
  if (P > chunks) P = chunks;
  return (int)(P < 1 ? 1 : P);
}

extern "C" int tap_grad_rows_per_part(int B, int R, int K) {
  const long long total = (long long)B * R;
  const int P = tap_grad_parts(B, R, K);
  const long long chunks = (total + CHUNK - 1) / CHUNK;
  return (int)(((chunks + P - 1) / P) * CHUNK);
}

// inv [B, K, N] int32 and inv_found [B, K, N] bytes from idx / found
// [B, K, R]: both are cleared here first (-1, 0); *collisions (one int,
// the caller zeroes it) counts the entries that found their slot taken.
extern "C" int rulebook_inverse_launch(const int* idx, const uint8_t* found,
                                       int* inv, uint8_t* inv_found,
                                       int* collisions, int B, int K, int R,
                                       int N, cudaStream_t stream) {
  const size_t slots = (size_t)B * K * N;
  cudaError_t err = cudaMemsetAsync(inv, 0xff, slots * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(inv_found, 0, slots, stream);
  if (err != cudaSuccess) return (int)err;
  const long long entries = (long long)B * K * R;
  if (entries == 0 || N == 0) return (int)cudaSuccess;
  rulebook_inverse_kernel<<<grid_1d(entries), THREADS, 0, stream>>>(
      idx, found, inv, inv_found, collisions, entries, K, R, N);
  return (int)cudaGetLastError();
}

// dW [K, Cin, Cout] from feats [B, N, Cin], idx / found [B, K, R] and
// dout [B, R, Cout], through partial [K, P, Cin, Cout] (P from
// tap_grad_parts).  Cin and Cout up to 128.
extern "C" int tap_grad_launch(const float* feats, const int* idx,
                               const uint8_t* found, const float* dout,
                               float* partial, float* dW, int B, int N,
                               int R, int K, int Cin, int Cout,
                               cudaStream_t stream) {
  const int CC = Cin * Cout;
  if (K == 0 || CC == 0) return (int)cudaSuccess;
  if (B == 0 || R == 0 || N == 0)
    return (int)cudaMemsetAsync(dW, 0, (size_t)K * CC * sizeof(float),
                                stream);
  const int P = tap_grad_parts(B, R, K);
  const int rpp = tap_grad_rows_per_part(B, R, K);
  const int tiles = ((Cin + 3) / 4) * ((Cout + 3) / 4);
  int err;
  if (tiles <= THREADS)
    err = launch_partial<1>(feats, idx, found, dout, partial, B, N, R, K,
                            Cin, Cout, P, rpp, stream);
  else if (tiles <= 4 * THREADS)
    err = launch_partial<4>(feats, idx, found, dout, partial, B, N, R, K,
                            Cin, Cout, P, rpp, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  const long long n = (long long)K * CC;
  tap_grad_sum_kernel<<<(int)((n + THREADS - 1) / THREADS), THREADS, 0,
                        stream>>>(partial, dW, K, P, CC);
  return (int)cudaGetLastError();
}
