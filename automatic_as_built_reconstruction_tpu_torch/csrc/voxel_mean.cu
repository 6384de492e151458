// Fused voxelize + mean: the capped per-voxel mean of a hard voxelization,
// with each slot's coords and count, straight from the unsorted points.
//
// Replaces the TPU kernel
//   automatic_as_built_reconstruction_tpu/ops/pallas/voxel_mean.py
//   ::fused_voxelize_mean (kernel body _kernel :46, pallas_call :164),
// which DMAs one contiguous window of the key-sorted point buffer per tile
// of slots and reduces it with T one-hot matmuls on the MXU, falling back
// to an XLA gather when slot starts are not monotone (first-appearance
// numbering) or a tile's span exceeds the window; XLA computes the cells,
// the sort and the slot table around it.  A GPU thread reads any row, so
// none of the window machinery is carried over, and the bookkeeping
// around the body becomes kernels too.
//
// Key-order slots (what serving runs): two kernels with one torch.sort
// between them.
//
//   point_keys_kernel, one thread a point:
//     cell   = int32(clamp(nan_to_0(floor((p - r0) / vs))))   (x, y, z)
//     valid  = 0 <= cell < grid  and  pos < num_valid[b]
//     packed = (valid ? (y * gx + x) * gz + z : INT32_MAX) << 32 | pos
//   Sorting packed along a row gives the stable key order (pos breaks the
//   ties) with invalid points last, and carries each point's index in its
//   low half: no index array.  The same launch fills every output slot
//   with the empty value (features 0, coords -1, counts 0) and zeroes the
//   scan's words (each tile's count and the row's ticket counter).
//
//   segment_mean_kernel, one thread a sorted position, a block a tile:
//     head   = valid and key differs from the previous position's
//     slot   = heads before it in the row (block ballot + the counts of
//              the tiles before, see below)
//     n      = min(run length, T)
//     features[b, slot] = (sum_{t < n} points[b, pos_{i+t}]) / n   (t order)
//     coords[b, slot]   = (z, y, x) decoded from the key
//     num_points[b, slot] = n;  num_voxels[b] = min(#heads, V)
//   for every head with slot < V.  The sums add the same points in the
//   same order with the same true fp32 division as the table kernel
//   below, so both give the same bits.
//
//   The scan crosses blocks in one pass: each tile publishes its head
//   count (count + 1, so that 0 means "not yet") as soon as its ballot is
//   done, then gathers its rows, then adds the counts of the tiles before
//   it, waiting on any not yet published.  A block takes its tile from its
//   row's ticket counter (an atomicAdd), not from its block index: CUDA
//   does not promise to start blocks in index order, but every tile of a
//   lower ticket belongs to a block that has started, so it publishes
//   whatever waits, and the grid may hold more blocks than fit the card at
//   once.
//
// First-appearance slots keep the table route: ops/voxelize.py's slot
// table (sort, start, count) and voxel_mean_kernel, which reads a slot's
// points through the int64 sort order.
//
//   n                 = min(count[b, v], T)
//   features[b, v, :] = (sum_{t < n} points[b, order[b, start[b, v] + t], :])
//                       / max(n, 1)                       (summed in t order)
//   coords[b, v, :]   = n > 0 ? cell[b, order[b, start[b, v]], (z, y, x)] : -1
//   num_points[b, v]  = n
//
// Bound: bytes, and the function needs few.  At the SECOND serving shape
// (B = 2, P = 18 000, V = 17 000, T = 5, C = 4) the key route must read
// each point's row, write and read the packed values, and write features,
// coords and counts: 2.2 MB, under a microsecond of HBM time.  An empty
// kernel takes about a microsecond, and each kernel here is a short chain
// of dependent reads (packed value -> point row -> the other tiles'
// counts), each a few hundred nanoseconds: latency, not bytes or the
// launch, sets their time.  The design keeps the chain short: every thread
// of a tile loads its position's key and point row at once (the rows go
// to shared memory with a halo of the next 32 positions, where a head adds
// its run's), a tile publishes its count before it waits for its rows, and
// the sums overlap the wait for the other tiles' counts.  The sort between the kernels is
// torch.sort (the JAX package sorts outside its Pallas body too).
// All arithmetic is IEEE fp32 (the build has -fmad=false, no fast math).
#include <cuda_runtime.h>
#include <stdint.h>

#define INVALID_KEY 0x7fffffffLL
#define SEGMENT_TILE 512        // threads of a segment_mean block = its tile
#define SEGMENT_HALO 32         // positions past its tile a block also holds
#define RUN_STEP 4              // positions of a run read together

// floor((p - r0) / vs) as _cell_coords computes it: NaN -> 0, clamped to
// the int32 range in fp32 (2147483520 is the largest fp32 below 2^31)
__device__ __forceinline__ int cell_of(float p, float r0, float vs) {
  float f = floorf((p - r0) / vs);
  if (f != f) f = 0.0f;
  f = fminf(fmaxf(f, -2147483648.0f), 2147483520.0f);
  return (int)f;
}

__global__ void point_keys_kernel(const float* __restrict__ points,
                                  const int* __restrict__ num_valid,
                                  long long* __restrict__ packed,
                                  long long P, int C, float vx, float vy,
                                  float vz, float x0, float y0, float z0,
                                  int gx, int gy, int gz,
                                  float* __restrict__ features,
                                  int* __restrict__ coords,
                                  int* __restrict__ num_points,
                                  int* __restrict__ num_voxels, int V,
                                  int* __restrict__ tile_state,
                                  int state_words, int fill, int vec4) {
  const int b = blockIdx.y;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (tid < P) {
    const long long row = (long long)b * P + tid;
    float px, py, pz;
    if (vec4) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(points) + row);
      px = r.x; py = r.y; pz = r.z;
    } else {
      const float* r = points + row * C;
      px = __ldg(r); py = __ldg(r + 1); pz = __ldg(r + 2);
    }
    const int cx = cell_of(px, x0, vx);
    const int cy = cell_of(py, y0, vy);
    const int cz = cell_of(pz, z0, vz);
    const bool ok = tid < (long long)__ldg(num_valid + b) && cx >= 0 &&
                    cx < gx && cy >= 0 && cy < gy && cz >= 0 && cz < gz;
    const long long key =
        ok ? ((long long)cy * gx + cx) * gz + cz : INVALID_KEY;
    packed[row] = (long long)(((unsigned long long)key << 32) |
                              (unsigned long long)tid);
  }
  if (!fill) return;
  // the outputs' empty value, written before the segment kernel runs
  float* f = features + (long long)b * V * C;
  if (vec4) {
    for (long long v = tid; v < V; v += stride)
      reinterpret_cast<float4*>(f)[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (long long i = tid; i < (long long)V * C; i += stride) f[i] = 0.0f;
  }
  for (long long v = tid; v < V; v += stride) {
    const long long s = (long long)b * V + v;
    coords[s * 3] = -1;
    coords[s * 3 + 1] = -1;
    coords[s * 3 + 2] = -1;
    num_points[s] = 0;
  }
  for (long long t = tid; t < state_words; t += stride)
    tile_state[(long long)b * state_words + t] = 0;
  if (tid == 0) num_voxels[b] = 0;
}

// tile_state: a row of n_tiles + 1 words for each scan, the tiles' counts
// and then the ticket counter, all zero at the launch.
__global__ void __launch_bounds__(SEGMENT_TILE)
segment_mean_kernel(const float* __restrict__ points,
                    const long long* __restrict__ packed,
                    float* __restrict__ features, int* __restrict__ coords,
                    int* __restrict__ num_points,
                    int* __restrict__ num_voxels, int* tile_state,
                    long long P, int C, int V, int T, int gx, int gz,
                    int n_tiles, int vec4) {
  constexpr int WARPS = SEGMENT_TILE / 32;
  __shared__ long long s_key[SEGMENT_TILE + SEGMENT_HALO];
  __shared__ float4 s_row[SEGMENT_TILE + SEGMENT_HALO];
  __shared__ int warp_heads[WARPS];
  __shared__ int warp_before[WARPS];
  __shared__ int s_tile;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  int* words = tile_state + (long long)b * (n_tiles + 1);
  // the tile: the row's next ticket, in the order the blocks start
  if (tid == 0) s_tile = atomicAdd(words + n_tiles, 1);
  __syncthreads();
  const int tile = s_tile;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = (long long)b * P;
  const long long i = (long long)tile * SEGMENT_TILE + tid;
  const long long* pk = packed + row;
  const float4* p4 = reinterpret_cast<const float4*>(points) + row;

  // this position's key, and (C == 4) its point's row, loaded at once by
  // every thread; the row is consumed only after the ballot below.  The
  // first warp also loads the halo: the positions just past the tile, where
  // a run that crosses its end goes on
  const bool rows = vec4;
  long long key = INVALID_KEY;
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < P) {
    const long long v = __ldg(pk + i);
    key = v >> 32;
    if (rows && key != INVALID_KEY) r = __ldg(p4 + (unsigned)v);
  }
  long long halo_key = INVALID_KEY;
  float4 halo_r = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long halo = (long long)(tile + 1) * SEGMENT_TILE + tid;
  if (tid < SEGMENT_HALO && halo < P) {
    const long long v = __ldg(pk + halo);
    halo_key = v >> 32;
    if (rows && halo_key != INVALID_KEY) halo_r = __ldg(p4 + (unsigned)v);
  }
  s_key[tid] = key;
  if (tid < SEGMENT_HALO) s_key[SEGMENT_TILE + tid] = halo_key;
  const long long before_key =
      tid > 0 || i == 0 ? INVALID_KEY : __ldg(pk + i - 1) >> 32;
  __syncthreads();
  const bool head = key != INVALID_KEY &&
                    (i == 0 || (tid > 0 ? s_key[tid - 1] : before_key) != key);
  const unsigned ballot = __ballot_sync(0xffffffffu, head);
  if (lane == 0) warp_heads[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1u));
  int tile_heads = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int h = warp_heads[w];
    before += w < warp ? h : 0;
    tile_heads += h;
  }
  volatile int* state = words;
  if (tid == 0) {
    state[tile] = tile_heads + 1;
    __threadfence();
  }
  // first read of an earlier tile's count, consumed after the sums: the
  // wait overlaps them
  int first = tid < tile ? state[tid] : 1;
  s_row[tid] = r;
  if (tid < SEGMENT_HALO) s_row[SEGMENT_TILE + tid] = halo_r;
  __syncthreads();

  // the head's run: up to T positions of its key, their rows added in t
  // order from shared memory (from device memory past the halo)
  // (RUN_STEP positions read together, then added one by one)
  int n = 0;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (head && before < V) {
    const int take = (int)min((long long)T, P - i);
    const int held = min(take, SEGMENT_TILE + SEGMENT_HALO - tid);
    bool open = true;
    for (int base = 0; open && base < held; base += RUN_STEP) {
      long long k[RUN_STEP];
      float4 x[RUN_STEP];
#pragma unroll
      for (int u = 0; u < RUN_STEP; ++u) {
        const int j = min(tid + base + u, SEGMENT_TILE + SEGMENT_HALO - 1);
        k[u] = s_key[j];
        x[u] = s_row[j];
      }
#pragma unroll
      for (int u = 0; u < RUN_STEP; ++u) {
        if (base + u >= held) break;    // the run may go on past the halo
        open = open && k[u] == key;
        if (open) {
          acc.x = acc.x + x[u].x;
          acc.y = acc.y + x[u].y;
          acc.z = acc.z + x[u].z;
          acc.w = acc.w + x[u].w;
          ++n;
        }
      }
    }
    for (; open && n < take; ++n) {     // past the halo
      const long long v = __ldg(pk + i + n);
      if ((v >> 32) != key) break;
      if (vec4) {
        const float4 x = __ldg(p4 + (unsigned)v);
        acc.x = acc.x + x.x;
        acc.y = acc.y + x.y;
        acc.z = acc.z + x.z;
        acc.w = acc.w + x.w;
      }
    }
  }

  // the counts of the tiles before this one (waiting on any not yet in)
  while (first == 0) first = state[tid];
  int prior = first - 1;
  for (int t = tid + SEGMENT_TILE; t < tile; t += SEGMENT_TILE) {
    int x = state[t];
    while (x == 0) x = state[t];
    prior += x - 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    prior += __shfl_xor_sync(0xffffffffu, prior, off);
  if (lane == 0) warp_before[warp] = prior;
  __syncthreads();
  int offset = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) offset += warp_before[w];
  const long long slot = (long long)offset + before;
  if (tile == n_tiles - 1 && tid == 0)
    num_voxels[b] = min(offset + tile_heads, V);
  if (!head || slot >= V) return;

  const long long s = (long long)b * V + slot;
  const float denom = (float)n;
  if (vec4) {
    reinterpret_cast<float4*>(features)[s] =
        make_float4(acc.x / denom, acc.y / denom, acc.z / denom,
                    acc.w / denom);
  } else {
    const float* pts = points + row * C;
    for (int ch = 0; ch < C; ++ch) {
      float sum = 0.0f;
      for (int t = 0; t < n; ++t)
        sum = sum + __ldg(pts + (long long)(unsigned)__ldg(pk + i + t) * C +
                          ch);
      features[s * C + ch] = sum / denom;
    }
  }
  const int z = (int)(key % gz);
  const long long xy = key / gz;
  coords[s * 3] = z;
  coords[s * 3 + 1] = (int)(xy / gx);
  coords[s * 3 + 2] = (int)(xy % gx);
  num_points[s] = n;
}

__global__ void voxel_mean_kernel(const float* __restrict__ points,
                                  const long long* __restrict__ order,
                                  const int* __restrict__ cell,
                                  const int* __restrict__ start,
                                  const int* __restrict__ count,
                                  float* __restrict__ features,
                                  int* __restrict__ coords,
                                  int* __restrict__ num_points,
                                  int P, int C, int V, int T,
                                  int table_stride) {
  const int b = blockIdx.y;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)V * C) return;
  const int v = (int)(i / C);
  const int ch = (int)(i - (long long)v * C);
  const long long slot = (long long)b * V + v;
  // start and count are rows of wider tables (a dump column follows V)
  const long long entry = (long long)b * table_stride + v;
  const int s = __ldg(start + entry);
  const int n = min(__ldg(count + entry), T);
  const long long* ord = order + (long long)b * P;
  const float* pts = points + (long long)b * P * C;
  float acc = 0.0f;
  for (int t = 0; t < n; ++t) {
    acc = acc + __ldg(pts + __ldg(ord + s + t) * C + ch);
  }
  features[slot * C + ch] = acc / (float)max(n, 1);
  if (ch == 0) {
    num_points[slot] = n;
    int z = -1, y = -1, x = -1;
    if (n > 0) {
      const int* c = cell + ((long long)b * P + __ldg(ord + s)) * 3;
      x = __ldg(c);
      y = __ldg(c + 1);
      z = __ldg(c + 2);
    }
    coords[slot * 3] = z;
    coords[slot * 3 + 1] = y;
    coords[slot * 3 + 2] = x;
  }
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// fill == 0: keys only (no output slots to fill, no scan words to zero).
extern "C" int point_keys_launch(const float* points, const int* num_valid,
                                 long long* packed, int B, long long P,
                                 int C, float vx, float vy, float vz,
                                 float x0, float y0, float z0, int gx,
                                 int gy, int gz, float* features,
                                 int* coords, int* num_points,
                                 int* num_voxels, int V, int* tile_state,
                                 int state_words, int fill,
                                 cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long work = P;
  if (fill) {
    work = work > V ? work : V;
    work = work > state_words ? work : state_words;
  }
  long long blocks = (work + threads - 1) / threads;
  if (blocks == 0) blocks = 1;
  if (blocks > 2147483647LL || B > 65535 || C < 3)
    return (int)cudaErrorInvalidValue;
  point_keys_kernel<<<dim3((unsigned)blocks, (unsigned)B), threads, 0,
                      stream>>>(points, num_valid, packed, P, C, vx, vy, vz,
                                x0, y0, z0, gx, gy, gz, features, coords,
                                num_points, num_voxels, V, tile_state,
                                state_words, fill,
                                C == 4 && aligned16(points) &&
                                    (!fill || aligned16(features)));
  return (int)cudaGetLastError();
}

extern "C" int segment_mean_launch(const float* points,
                                   const long long* packed, float* features,
                                   int* coords, int* num_points,
                                   int* num_voxels, int* tile_state,
                                   int n_tiles, int B, long long P, int C,
                                   int V, int T, int gx, int gz,
                                   cudaStream_t stream) {
  if (B == 0 || P == 0) return (int)cudaSuccess;
  // tile_state holds n_tiles + 1 words a row: the caller's tile must be ours
  if (n_tiles != (P + SEGMENT_TILE - 1) / SEGMENT_TILE || B > 65535 ||
      T < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_tiles, (unsigned)B);
  const int vec4 = C == 4 && aligned16(points) && aligned16(features);
  segment_mean_kernel<<<grid, SEGMENT_TILE, 0, stream>>>(
      points, packed, features, coords, num_points, num_voxels, tile_state,
      P, C, V, T, gx, gz, n_tiles, vec4);
  return (int)cudaGetLastError();
}

extern "C" int voxel_mean_launch(const float* points, const long long* order,
                                 const int* cell, const int* start,
                                 const int* count, float* features,
                                 int* coords, int* num_points, int B, int P,
                                 int C, int V, int T, int table_stride,
                                 cudaStream_t stream) {
  if (B == 0 || V == 0 || C == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = ((long long)V * C + threads - 1) / threads;
  if (blocks > 2147483647LL || B > 65535) return (int)cudaErrorInvalidValue;
  voxel_mean_kernel<<<dim3((unsigned)blocks, (unsigned)B), threads, 0,
                      stream>>>(points, order, cell, start, count, features,
                                coords, num_points, P, C, V, T,
                                table_stride);
  return (int)cudaGetLastError();
}
