// Pairwise rotated BEV IoU of (x, y, w, l, yaw) boxes, batched:
//   [R, N, 5] x [R, K, 5] -> [R, N, K] fp32.
//
// Replaces the TPU kernel
//   automatic_as_built_reconstruction_tpu/ops/pallas/rotated_iou_pallas.py
//   ::intersection_area_matrix_pallas (clip body _kernel, pallas_call
//   :137) and the IoU of ::rotate_iou_matrix_pallas (:158).
// Same math, step for step, for every pair that is clipped: corners as
// _corner_cols builds them (CCW, (-,-) (+,-) (+,+) (-,+)); Sutherland-
// Hodgman clip of box A by the 4 edges of box B (a vertex is inside when
// s = ex*(py-aye) - ey*(px-axe) >= 0; the crossing parameter t = s / denom
// only when |denom| > 1e-12; vertex, then crossing, slot by slot; at most
// 8 slots kept); shoelace area max(0.5 * sum, 0) summed in slot order;
// IoU = inter / max(denom, 1e-12) where denom > 0 with denom = area_a +
// area_b - inter (criterion -1), area_a (0) or area_b (1).
//
// Bound: bytes (the [R, N, K] IoUs written once) on NMS inputs; the fp32
// arithmetic the boxes need (ops/rotated_iou.py::clip_flops) is smaller,
// because most pairs are disjoint and their clip empties after an edge or
// two.  Design, against that:
// 1. A block of 256 threads owns a tile of 16 A rows x 128 B columns (of
//    the shapes measured, the fastest on the served inputs: smaller tiles
//    spread the overlapping pairs of an NMS input more evenly over the
//    blocks; rotated_iou_ablation.py).  A prologue computes each of its
//    144 boxes once into shared memory: the
//    corners, the area, the circumradius, the unit axes and half sizes,
//    and a margin that is NaN for a degenerate box (a value not finite, a
//    magnitude above 1e15, or w or l not above 2^-14 of its magnitude
//    |x| + |y| + r: zero, negative, or thin enough for its fp32 corners
//    to collapse, when its edges no longer bound it).
// 2. Every pair is tested for disjointness in two stages, each with the
//    margin 2^-14 * (|x| + |y| + r) + 1e-6 m of either box added: the
//    bounding circles on every pair (a bit a pair in a lane's word, a
//    shuffle scan over the warp and one shared atomic a warp append the
//    pairs it keeps to a first queue), then the separating axes of the 4
//    edge normals on the queued pairs, one a thread (a ballot appends
//    those it keeps to a second queue).  The margin is hundreds of times
//    the fp32 rounding of the clip (its crossings stay on A's edges within
//    a few ulps of the coordinates, its side values within a few ulps of
//    the box sizes), so the clip of every rejected pair empties and gives
//    0.0, which is what a rejected pair keeps, under every criterion.  A
//    NaN margin compares false: a pair with a degenerate box is never
//    rejected (a zero-area B keeps all of A, and IoU over area A is 1.0).
//    ops/rotated_iou.py::disjoint_pairs mirrors the test;
//    tests/test_torch_rotated_iou.py holds every pair it rejects to a
//    plain IoU of exactly 0.0.
// 3. The block clips the pairs of the second queue one a thread, so a
//    warp is not held by one overlapping pair among 31 disjoint ones.  The
//    clip holds its polygon in registers and in two shared-memory vertex
//    buffers a thread (slot-major, the thread index fastest: no bank
//    conflicts), takes an edge's side values together, stops when the
//    polygon empties, and computes only the crossings it has, one
//    division each.
// 4. Results collect in a shared [16, 128] tile that starts at 0.0 and
//    leave it coalesced along K, as 16-byte stores when K % 4 == 0 and the
//    output is 16-byte aligned, else as scalar stores; every output is
//    written once.
// Built without --use_fast_math (accurate cosf/sinf, IEEE division and
// sqrt) and with -fmad=false, so every product and sum rounds as in the
// plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 16;                  // A rows of a block
constexpr int kTileK = 128;                 // B columns of a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBoxes = kTileN + kTileK;     // A boxes first, then B
constexpr int kLaneCols = kTileK / 32;      // B columns a lane tests
static_assert(kTileN % kWarps == 0 && kTileN / kWarps * kLaneCols <= 32,
              "a lane's pairs are the bits of one word");
constexpr float kTolRel = 1.0f / 16384.0f;  // rejection margin, per box
constexpr float kTolMin = 1e-6f;
constexpr float kHuge = 1e15f;              // larger: never rejected

struct Boxes {                              // one entry per box of a tile
  float cx[4][kBoxes], cy[4][kBoxes];       // CCW corners
  float area[kBoxes];
  float x[kBoxes], y[kBoxes], c[kBoxes], s[kBoxes];
  float hw[kBoxes], hl[kBoxes], r[kBoxes], tol[kBoxes];
};

struct Smem {
  float out[kTileN][kTileK];
  union {                                   // the first, then the second
    unsigned short near[kTileN * kTileK];   // pairs the circles keep
    float poly[2][16][kThreads];            // [buffer][2 * slot + xy][thread]
  };
  Boxes box;
  unsigned short queue[kTileN * kTileK];    // pairs to clip
  int n_near, n_queue;                      // (row * kTileK + col each)
};
static_assert(sizeof(unsigned short) * kTileN * kTileK <=
                  sizeof(float) * 2 * 16 * kThreads,
              "the first queue fits in the vertex buffers");

__device__ __forceinline__ void box_corners(float x, float y, float w,
                                            float l, float c, float s,
                                            float* cx, float* cy) {
  const float lx[4] = {-0.5f * w, 0.5f * w, 0.5f * w, -0.5f * w};
  const float ly[4] = {-0.5f * l, -0.5f * l, 0.5f * l, 0.5f * l};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cx[i] = (lx[i] * c - ly[i] * s) + x;
    cy[i] = (lx[i] * s + ly[i] * c) + y;
  }
}

// The rejection margin of one box, kTolRel * mag + kTolMin with mag =
// |x| + |y| + r; NaN for a degenerate box: a value not finite, mag above
// kHuge, or w or l not above kTolRel * mag (zero, negative, or so thin
// that its fp32 corners can collapse and its edges clip nothing).
__device__ __forceinline__ float reject_tol(float x, float y, float w,
                                            float l, float yaw, float r) {
  const float mag = (fabsf(x) + fabsf(y)) + r;
  const bool ok = w > kTolRel * mag && l > kTolRel * mag && mag <= kHuge &&
                  isfinite(yaw);
  return ok ? kTolRel * mag + kTolMin : __int_as_float(0x7fc00000);
}

// Stage 1: the bounding circles (radii ar, br; centres dx, dy apart) are
// apart by more than the margin m.  A NaN margin compares false.
__device__ __forceinline__ bool circles_apart(float dx, float dy, float ar,
                                              float br, float m) {
  const float reach = (ar + br) + m;
  return dx * dx + dy * dy > reach * reach;
}

// Stage 2: one of the 4 edge normals separates the boxes by more than m.
// (c, s): a box's w axis; hw, hl: its half sizes.
__device__ __forceinline__ bool axes_apart(float dx, float dy, float ac,
                                           float as, float ahw, float ahl,
                                           float bc, float bs, float bhw,
                                           float bhl, float m) {
  const float cab = ac * bc + as * bs;                    // ua . ub
  const float sab = as * bc - ac * bs;                    // ua . vb
  const float acab = fabsf(cab), asab = fabsf(sab);
  return fabsf(dx * ac + dy * as) > ((ahw + acab * bhw) + asab * bhl) + m ||
         fabsf(dy * ac - dx * as) > ((ahl + asab * bhw) + acab * bhl) + m ||
         fabsf(dx * bc + dy * bs) > ((bhw + acab * ahw) + asab * ahl) + m ||
         fabsf(dy * bc - dx * bs) > ((bhl + asab * ahw) + acab * ahl) + m;
}

// Area of A clipped by B's 4 edges.  The polygon (at most 8 vertices) is
// held in registers for the side values and in this thread's shared
// vertex buffers for what is read back by index: buf0 / buf1, slot i's x
// at [2 * i * stride], its y at [(2 * i + 1) * stride].  Each edge
// computes the 8 slots' side values at once, marks the vertices inside
// (s >= 0) and those whose successor is on the other side; an edge that
// crosses nothing keeps the polygon (all inside) or empties it.  Otherwise
// the vertices inside and the crossings go to the slots the plain version
// gives them (a crossing right after its vertex), computed by the same
// expressions, one division a crossing.
__device__ __forceinline__ float clip_area(const float* ax, const float* ay,
                                           const float* bx, const float* by,
                                           float* buf0, float* buf1,
                                           int stride) {
  float px[8], py[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    px[i] = ax[i];
    py[i] = ay[i];
    px[i + 4] = 0.f;
    py[i + 4] = 0.f;
    buf0[2 * i * stride] = ax[i];
    buf0[(2 * i + 1) * stride] = ay[i];
  }
  float* in = buf0;
  float* out = buf1;
  int n = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float axe = bx[e], aye = by[e];
    const float ex = bx[(e + 1) % 4] - axe;
    const float ey = by[(e + 1) % 4] - aye;
    const unsigned held = (1u << n) - 1u;
    unsigned inside = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      inside |= (unsigned)(ex * (py[i] - aye) - ey * (px[i] - axe) >= 0.f)
                << i;
    inside &= held;
    const unsigned succ = (inside >> 1) | ((inside & 1u) << (n - 1));
    const unsigned cross = (inside ^ succ) & held;
    if (cross == 0u) {
      if (inside == 0u) return 0.f;   // every vertex outside
    } else {                          // else every vertex inside: kept
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned below = (1u << i) - 1u;
        const int slot = __popc(inside & below) + __popc(cross & below);
        if (((inside >> i) & 1u) && slot < 8) {
          out[2 * slot * stride] = px[i];
          out[(2 * slot + 1) * stride] = py[i];
        }
      }
      for (unsigned c = cross; c; c &= c - 1u) {
        const int i = __ffs(c) - 1;
        const int j = i + 1 < n ? i + 1 : 0;
        const int slot = __popc(inside & ((2u << i) - 1u)) +
                         __popc(cross & ((1u << i) - 1u));
        if (slot < 8) {
          const float cx = in[2 * i * stride], cy = in[(2 * i + 1) * stride];
          const float nx = in[2 * j * stride], ny = in[(2 * j + 1) * stride];
          const float sc = ex * (cy - aye) - ey * (cx - axe);
          const float sn = ex * (ny - aye) - ey * (nx - axe);
          const float denom = sc - sn;
          const float t = fabsf(denom) > 1e-12f ? sc / denom : 0.f;
          out[2 * slot * stride] = cx + t * (nx - cx);
          out[(2 * slot + 1) * stride] = cy + t * (ny - cy);
        }
      }
      const int run = __popc(inside) + __popc(cross);
      n = run < 8 ? run : 8;
      float* tmp = in;
      in = out;
      out = tmp;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        px[i] = in[2 * i * stride];
        py[i] = in[(2 * i + 1) * stride];
      }
    }
  }
  float area = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < n) {
      const float nx = i + 1 < n ? px[(i + 1) % 8] : px[0];
      const float ny = i + 1 < n ? py[(i + 1) % 8] : py[0];
      area = area + (px[i] * ny - nx * py[i]);
    }
  }
  const float half = 0.5f * area;
  return half < 0.f ? 0.f : half;
}

__global__ void __launch_bounds__(kThreads)
rotated_iou_kernel(const float* __restrict__ boxes,
                   const float* __restrict__ qboxes, float* __restrict__ out,
                   int N, int K, int criterion) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  Boxes& bt = sm.box;
  const int r = blockIdx.z;
  const int n0 = blockIdx.y * kTileN, k0 = blockIdx.x * kTileK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 1) per-box prologue; the tile of results starts at 0.0, what a
  //    rejected pair gets
  if (tid == 0) sm.n_near = sm.n_queue = 0;
  for (int v = tid; v < kTileN * kTileK / 4; v += kThreads)
    reinterpret_cast<float4*>(&sm.out[0][0])[v] = make_float4(0.f, 0.f, 0.f,
                                                              0.f);
  for (int t = tid; t < kBoxes; t += kThreads) {
    const bool is_a = t < kTileN;
    const int idx = is_a ? n0 + t : k0 + t - kTileN;
    if (idx < (is_a ? N : K)) {
      const float* b = is_a ? boxes + ((long long)r * N + idx) * 5
                            : qboxes + ((long long)r * K + idx) * 5;
      const float x = b[0], y = b[1], w = b[2], l = b[3], yaw = b[4];
      const float c = cosf(yaw), s = sinf(yaw);
      float cx[4], cy[4];
      box_corners(x, y, w, l, c, s, cx, cy);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bt.cx[i][t] = cx[i];
        bt.cy[i][t] = cy[i];
      }
      const float rad = 0.5f * sqrtf(w * w + l * l);
      bt.area[t] = w * l;
      bt.x[t] = x;
      bt.y[t] = y;
      bt.c[t] = c;
      bt.s[t] = s;
      bt.hw[t] = 0.5f * w;
      bt.hl[t] = 0.5f * l;
      bt.r[t] = rad;
      bt.tol[t] = reject_tol(x, y, w, l, yaw, rad);
    }
  }
  __syncthreads();

  // 2) stage 1 on every pair: lane owns columns lane + 32 j, warp owns
  //    rows warp + 8 i; bit kLaneCols * i + j of keep marks a pair the
  //    circles keep.  Its slot in the first queue: a scan over the warp,
  //    one shared atomic a warp.
  float bx[kLaneCols], by[kLaneCols], br[kLaneCols], btol[kLaneCols];
  bool bin[kLaneCols];
#pragma unroll
  for (int j = 0; j < kLaneCols; ++j) {
    const int b = kTileN + lane + 32 * j;
    bin[j] = k0 + lane + 32 * j < K;
    bx[j] = bt.x[b];
    by[j] = bt.y[b];
    br[j] = bt.r[b];
    btol[j] = bt.tol[b];
  }
  unsigned keep = 0u;
#pragma unroll
  for (int i = 0; i < kTileN / kWarps; ++i) {
    const int row = warp + kWarps * i;
    if (n0 + row >= N) break;        // the same on every lane
    const float ax = bt.x[row], ay = bt.y[row], ar = bt.r[row];
    const float atol = bt.tol[row];
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      if (bin[j] &&
          !circles_apart(bx[j] - ax, by[j] - ay, ar, br[j], atol + btol[j]))
        keep |= 1u << (kLaneCols * i + j);
    }
  }
  const int mine = __popc(keep);
  int upto = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, upto, o);
    if (lane >= o) upto += v;
  }
  int base = 0;
  if (lane == 31 && upto > 0) base = atomicAdd(&sm.n_near, upto);
  int slot = __shfl_sync(0xffffffffu, base, 31) + upto - mine;
  while (keep) {
    const int bit = __ffs(keep) - 1;
    keep &= keep - 1u;
    sm.near[slot++] = (unsigned short)(
        (warp + kWarps * (bit / kLaneCols)) * kTileK + lane +
        32 * (bit % kLaneCols));
  }
  __syncthreads();

  // 3) stage 2 on the pairs the circles keep, one a thread; the pairs it
  //    keeps go to the second queue (a ballot a warp)
  const int n_near = sm.n_near;
  for (int q0 = warp * 32; q0 < n_near; q0 += kThreads) {
    const int q = q0 + lane;
    bool clip = false;
    int pair = 0;
    if (q < n_near) {
      pair = sm.near[q];
      const int a = pair / kTileK, b = kTileN + pair % kTileK;
      clip = !axes_apart(bt.x[b] - bt.x[a], bt.y[b] - bt.y[a], bt.c[a],
                         bt.s[a], bt.hw[a], bt.hl[a], bt.c[b], bt.s[b],
                         bt.hw[b], bt.hl[b], bt.tol[a] + bt.tol[b]);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, clip);
    int at = 0;
    if (lane == 0 && mask) at = atomicAdd(&sm.n_queue, __popc(mask));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (clip)
      sm.queue[at + __popc(mask & ((1u << lane) - 1u))] =
          (unsigned short)pair;
  }
  __syncthreads();

  // 4) clip the queued pairs, one a thread
  const int n_queue = sm.n_queue;
  for (int q = tid; q < n_queue; q += kThreads) {
    const int row = sm.queue[q] / kTileK, col = sm.queue[q] % kTileK;
    const int a = row, b = kTileN + col;
    float ax[4], ay[4], bx4[4], by4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ax[i] = bt.cx[i][a];
      ay[i] = bt.cy[i][a];
      bx4[i] = bt.cx[i][b];
      by4[i] = bt.cy[i][b];
    }
    const float inter = clip_area(ax, ay, bx4, by4, &sm.poly[0][0][tid],
                                  &sm.poly[1][0][tid], kThreads);
    float denom;
    if (criterion == -1) {
      denom = (bt.area[a] + bt.area[b]) - inter;
    } else if (criterion == 0) {
      denom = bt.area[a];
    } else {
      denom = bt.area[b];
    }
    sm.out[row][col] = denom > 0.f ? inter / fmaxf(denom, 1e-12f) : 0.f;
  }
  __syncthreads();

  // 5) the tile out, coalesced along K
  float* dst = out + ((long long)r * N + n0) * K + k0;
  if (K % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    for (int v = tid; v < kTileN * kTileK / 4; v += kThreads) {
      const int row = v / (kTileK / 4), col = 4 * (v % (kTileK / 4));
      if (n0 + row < N && k0 + col < K)
        *reinterpret_cast<float4*>(dst + (long long)row * K + col) =
            *reinterpret_cast<const float4*>(&sm.out[row][col]);
    }
  } else {
    for (int v = tid; v < kTileN * kTileK; v += kThreads) {
      const int row = v / kTileK, col = v % kTileK;
      if (n0 + row < N && k0 + col < K)
        dst[(long long)row * K + col] = sm.out[row][col];
    }
  }
}

}  // namespace

extern "C" int rotated_iou_launch(const float* boxes, const float* qboxes,
                                  float* out, int R, int N, int K,
                                  int criterion, cudaStream_t stream) {
  if (R == 0 || N == 0 || K == 0) return (int)cudaSuccess;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      rotated_iou_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((K + kTileK - 1) / kTileK, (N + kTileN - 1) / kTileN, R);
  rotated_iou_kernel<<<grid, kThreads, smem, stream>>>(boxes, qboxes, out, N,
                                                       K, criterion);
  return (int)cudaGetLastError();
}
