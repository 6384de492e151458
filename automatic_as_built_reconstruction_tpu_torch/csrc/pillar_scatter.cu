// Pillar scatter: pillar feature rows -> dense BEV canvas rows, and its
// transpose, the gather of the canvas gradient back to the rows.
//
// Replaces the TPU kernel
//   automatic_as_built_reconstruction_tpu/ops/pallas/pillar_scatter.py
//   ::scatter_sorted_to_canvas (kernel body _kernel, pallas_call :103),
// which builds each 1024-cell canvas tile as a one-hot matmul on the MXU
// because the TPU has no row scatter (in float32 or bfloat16 rows: the
// one-hot product is accumulated in float32 and cast back to the rows'
// type, :55-57, an exact copy since each cell takes at most one row).
// Hopper needs no product: each cell of the canvas is a copy of its row's
// bytes or zero,
//
//   canvas[b, lin[b, v], :] = feats[b, v, :]   for 0 <= lin[b, v] < hw
//                           = 0                 in every other cell
//
// The kernels copy 16-byte chunks and never look at the values, so they
// serve float32 rows (C % 4 == 0: a 64-float row is 16 chunks) and
// bfloat16 rows (C % 8 == 0: a 64-value row is 8 chunks), bit for bit; the
// wrapper passes the chunks a row holds (cw).  Ids are unique per scan and
// may come in any order (the device voxelizer gives key order, the host
// one first-appearance order); duplicates are not an accepted input.  Rows
// whose id lies outside [0, hw) are dropped and never read.
//
// Bound: bytes.  Per call the forward must read the occupied rows
// (rows * C * e, e the element size) and every id (B*V*4) and write the
// whole canvas once (B*hw*C*e); there is no arithmetic.  Two routes, which
// the wrapper's plan picks by the canvas's size
// (ops/pillar_scatter.py::scatter_plan):
//
// pillar_scatter_kernel, the tiles, for the served canvases (13 MB and
// less): one launch into an uninitialised canvas, no fill kernel.  Each
// block owns a tile: the scan's SCATTER_GRANULE-cell granules are dealt
// to its tiles in turn, so that a dense part of a scan spreads over many
// blocks; a cluster of SCATTER_CLUSTER blocks owns as many tiles.
//   1. it sets up its map (a cell of the tile -> its row, -1 for none),
//      arrives at the cluster barrier (a release of the set-up only) and
//      loads the first round of its share of the scan's ids (16-byte
//      loads, SCATTER_ID_UNROLL in flight a thread; the cluster reads the
//      scan's ids once, each block a share);
//   2. while those are in flight it writes its whole tile as zeros, a
//      stream of stores that waits on nothing;
//   3. once every block of the cluster has set up its map, each id of its
//      share that falls in one of the cluster's tiles has its row's index
//      stored in the owning block's map, through the cluster's
//      distributed shared memory (ids are unique, so plain stores do: no
//      atomics); g / tiles by a multiply, no division an id;
//   4. after the cluster barrier (every map complete, every zero written
//      before it) the block lists its occupied cells in order (a block
//      scan of per-thread counts: no atomics);
//   5. and copies their rows over their zeros, SCATTER_UNROLL chunks in
//      flight a thread.
// The occupied cells' chunks are written twice, zero then row: a design
// that wrote every chunk once (the zeros after the maps, the rows' loads
// issued ahead of them) was slower, since the whole zero stream then
// waits on the ids and two barriers (pillar_scatter_ablation.py,
// write_once); at the served shape latency, not bytes, sets the time.
//
// pillar_rows_kernel, for larger canvases (the KITTI ones, 55-439 MB): the
// wrapper fills the canvas with zeros (torch.zeros) and this kernel copies
// the rows, a thread a 16-byte chunk; there the fill's many small blocks
// stream the zeros at the card's write rate, which the tiles' one block
// an SM does not reach.
//
// pillar_gather_kernel is the backward of the scatter (the JAX package
// has no Pallas backward here: in training it scatters through XLA,
// models/pointpillars.py:262-266, and XLA transposes that scatter into a
// row gather):
//
//   dfeats[b, v, :] = dcanvas[b, lin[b, v], :]   for 0 <= lin[b, v] < hw
//                   = 0                          otherwise
//
// Ids are unique per scan (the forward's precondition), so each canvas
// row feeds at most one pillar row and no gradient is summed: the
// bfloat16 backward is a copy too.  Bound: bytes.  It must read the
// canvas gradient at the valid rows' cells (rows * C * e), the ids
// (B*V*4), and write dfeats (B*V*C*e).  Design: a thread a 16-byte chunk
// of dfeats, adjacent threads on adjacent addresses (a row's chunks read
// one id, broadcast), a dropped row's chunks written as zeros without
// reading the canvas; every output chunk is written, so the wrapper
// allocates dfeats uninitialised.  Measured against a warp that owns 32
// rows (their ids in one load, GATHER_UNROLL chunks in flight a lane, the
// grid the card's resident blocks), this one-chunk grid keeps more loads
// in flight over the card and is faster at every shape
// (pillar_scatter_ablation.py, gather_warp_rows).
//
// All index math is 32-bit: the wrapper refuses a canvas or a row array
// of 2^31 chunks or more.  No division by a variable in the inner loops:
// the row width is a template argument for the widths of the pillar
// configs (4, 8 and 16 chunks), and the other widths take a 32-bit one.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define SCATTER_CLUSTER 2     // blocks (adjacent tiles of a scan) a cluster
#define SCATTER_GRANULE 16    // cells a granule: a scan's granules are dealt
                              // to its tiles in turn
#define SCATTER_THREADS 512
#define SCATTER_MIN_BLOCKS 2  // blocks an SM must hold (registers <= 64)
#define SCATTER_ID_UNROLL 8   // 16-byte id loads in flight a thread
#define SCATTER_UNROLL 4      // 16-byte row chunks in flight a thread
#define ROWS_THREADS 256
#define GATHER_THREADS 256

// the scan's cell of the i-th cell of tile t (of `tiles`)
__device__ __forceinline__ int cell_of(int i, int tiles, int t) {
  return ((i / SCATTER_GRANULE) * tiles + t) * SCATTER_GRANULE +
         i % SCATTER_GRANULE;
}

// the map entry of the row with this id, where its cell lies in a
// granule of one of the cluster's tiles (t0 the cluster's first): in the
// owning block's map, at the cell's place among that tile's cells.  g /
// tiles by a multiply with magic = ceil(2^32 / tiles), exact while
// granules * tiles < 2^32 (the wrapper's check): no division an id
__device__ __forceinline__ void map_row(const cg::cluster_group& cluster,
                                        int* row_of, int id, int row, int hw,
                                        int tiles, unsigned magic, int t0) {
  if ((unsigned)id >= (unsigned)hw) return;          // dropped
  const int g = id / SCATTER_GRANULE;
  const int q = (int)__umulhi((unsigned)g, magic);   // g / tiles: the
  const int owner = g - q * tiles - t0;               // tile's q-th
  if ((unsigned)owner < (unsigned)SCATTER_CLUSTER)
    cluster.map_shared_rank(row_of, owner)[q * SCATTER_GRANULE +
                                           id % SCATTER_GRANULE] = row;
}

template <int CW>
__global__ void __cluster_dims__(SCATTER_CLUSTER, 1, 1)
__launch_bounds__(SCATTER_THREADS, SCATTER_MIN_BLOCKS)
pillar_scatter_kernel(const uint4* __restrict__ feats,
                      const int* __restrict__ lin,
                      uint4* __restrict__ canvas, int V, int cw_arg, int hw,
                      int tile, int tiles) {
  extern __shared__ int row_of[];          // a cell of the tile -> its row
  cg::cluster_group cluster = cg::this_cluster();
  const int cw = CW > 0 ? CW : cw_arg;
  const int b = blockIdx.x / tiles;        // tiles: a multiple of the cluster
  const int t = blockIdx.x - b * tiles;    // this block's tile of scan b
  const int rank = (int)cluster.block_rank();
  // the tile: granules t, t + tiles, t + 2 tiles, ... of the scan's
  // SCATTER_GRANULE-cell granules (the last one may be short)
  const int granules = (hw + SCATTER_GRANULE - 1) / SCATTER_GRANULE;
  const int owned = t < granules ? (granules - 1 - t) / tiles + 1 : 0;
  const int short_by = granules * SCATTER_GRANULE - hw;   // the last one's
  const int cells =
      owned * SCATTER_GRANULE - ((granules - 1) % tiles == t ? short_by : 0);

  // 1. the map set up and this block's arrival at the cluster barrier (a
  // release: it orders the set-up, not what follows), then the first
  // round of this block's share of the scan's ids loaded
  for (int i = threadIdx.x; i < cells; i += SCATTER_THREADS) row_of[i] = -1;
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  const int t0 = t - rank;                 // the cluster's first tile
  const unsigned magic = (unsigned)((0x100000000ull + tiles - 1) / tiles);
  const int* ids = lin + b * V;
  const int quads =
      (reinterpret_cast<uintptr_t>(ids) & 15) == 0 ? V / 4 : 0;
  const int share = (quads + SCATTER_CLUSTER - 1) / SCATTER_CLUSTER;
  const int q_end = min(quads, (rank + 1) * share);
  const int4* ids4 = reinterpret_cast<const int4*>(ids);
  int q0 = rank * share + threadIdx.x;
  int4 id[SCATTER_ID_UNROLL];
#pragma unroll
  for (int u = 0; u < SCATTER_ID_UNROLL; ++u) {
    const int q = q0 + u * SCATTER_THREADS;
    id[u] = q < q_end ? __ldg(ids4 + q) : make_int4(-1, -1, -1, -1);
  }

  // 2. the whole tile written as zeros while the ids are in flight: a
  // stream of stores that waits on nothing
  uint4* out = canvas + b * hw * cw;
#pragma unroll 4
  for (int j = threadIdx.x; j < cells * cw; j += SCATTER_THREADS)
    out[cell_of(j / cw, tiles, t) * cw + j % cw] = make_uint4(0u, 0u, 0u, 0u);

  // 3. the ids -> the cluster's maps, once every map is set up
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  while (true) {
#pragma unroll
    for (int u = 0; u < SCATTER_ID_UNROLL; ++u) {
      const int v = 4 * (q0 + u * SCATTER_THREADS);
      map_row(cluster, row_of, id[u].x, v, hw, tiles, magic, t0);
      map_row(cluster, row_of, id[u].y, v + 1, hw, tiles, magic, t0);
      map_row(cluster, row_of, id[u].z, v + 2, hw, tiles, magic, t0);
      map_row(cluster, row_of, id[u].w, v + 3, hw, tiles, magic, t0);
    }
    q0 += SCATTER_THREADS * SCATTER_ID_UNROLL;
    if (q0 >= q_end) break;
#pragma unroll
    for (int u = 0; u < SCATTER_ID_UNROLL; ++u) {
      const int q = q0 + u * SCATTER_THREADS;
      id[u] = q < q_end ? __ldg(ids4 + q) : make_int4(-1, -1, -1, -1);
    }
  }
  // the ids after the last quad (all of them where the scan's ids are
  // not 16-byte aligned), one at a time, shared out the same way
  for (int v = 4 * quads + rank * SCATTER_THREADS + threadIdx.x; v < V;
       v += SCATTER_CLUSTER * SCATTER_THREADS)
    map_row(cluster, row_of, __ldg(ids + v), v, hw, tiles, magic, t0);
  cluster.sync();      // every map complete, every zero of the tile ordered

  // 4. the tile's occupied cells, listed in order: each thread counts its
  // run of cells, a block scan gives its offset, it writes them down
  __shared__ int warp_total[SCATTER_THREADS / 32];
  unsigned short* listed = reinterpret_cast<unsigned short*>(row_of + tile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (cells + SCATTER_THREADS - 1) / SCATTER_THREADS;
  const int c0 = min(cells, threadIdx.x * per), c1 = min(cells, c0 + per);
  int mine = 0;
  for (int c = c0; c < c1; ++c) mine += row_of[c] >= 0;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int sum = lane < SCATTER_THREADS / 32 ? warp_total[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, sum, d);
      if (lane >= d) sum += up;
    }
    if (lane < SCATTER_THREADS / 32) warp_total[lane] = sum;
  }
  __syncthreads();
  int at = incl - mine + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int c = c0; c < c1; ++c)
    if (row_of[c] >= 0) listed[at++] = (unsigned short)c;
  const int m = warp_total[SCATTER_THREADS / 32 - 1] * cw;  // rows' chunks
  __syncthreads();

  // 5. the listed cells' rows copied over their zeros, SCATTER_UNROLL
  // chunks in flight a thread
  const uint4* rows = feats + b * V * cw;
  for (int k0 = threadIdx.x; k0 < m; k0 += SCATTER_THREADS * SCATTER_UNROLL) {
    uint4 chunk[SCATTER_UNROLL];
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u) {
      const int k = k0 + u * SCATTER_THREADS;
      if (k < m) chunk[u] = __ldg(rows + row_of[listed[k / cw]] * cw + k % cw);
    }
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u) {
      const int k = k0 + u * SCATTER_THREADS;
      if (k < m) out[cell_of(listed[k / cw], tiles, t) * cw + k % cw] =
          chunk[u];
    }
  }
}

template <int CW>
static void scatter(const void* feats, const int* lin, void* canvas, int B,
                    int V, int cw, int hw, int tile, int tiles,
                    cudaStream_t stream) {
  pillar_scatter_kernel<CW>
      <<<B * tiles, SCATTER_THREADS,
         tile * (sizeof(int) + sizeof(unsigned short)), stream>>>(
          reinterpret_cast<const uint4*>(feats), lin,
          reinterpret_cast<uint4*>(canvas), V, cw, hw, tile, tiles);
}

// feats [B, V, cw chunks of 16 bytes], lin [B, V] -> canvas [B, hw, cw],
// every chunk written; B * tiles blocks, each the tile of `tile` cells
// (the wrapper's plan: tiles * tile >= hw, tiles a multiple of
// SCATTER_CLUSTER)
extern "C" int pillar_scatter_launch(const void* feats, const int* lin,
                                     void* canvas, int B, int V, int cw,
                                     int hw, int tile, int tiles,
                                     cudaStream_t stream) {
  if (B == 0 || hw == 0 || cw == 0) return (int)cudaSuccess;
  switch (cw) {
    case 4: scatter<4>(feats, lin, canvas, B, V, cw, hw, tile, tiles,
                       stream); break;
    case 8: scatter<8>(feats, lin, canvas, B, V, cw, hw, tile, tiles,
                       stream); break;
    case 16: scatter<16>(feats, lin, canvas, B, V, cw, hw, tile, tiles,
                         stream); break;
    default: scatter<0>(feats, lin, canvas, B, V, cw, hw, tile, tiles,
                        stream);
  }
  return (int)cudaGetLastError();
}

// the rows route: a thread a 16-byte chunk of a row, copied to its cell
// where the id is in [0, hw), onto a canvas the wrapper has zero-filled
template <int CW>
__global__ void __launch_bounds__(ROWS_THREADS)
pillar_rows_kernel(const uint4* __restrict__ feats,
                   const int* __restrict__ lin, uint4* __restrict__ canvas,
                   int rows, int V, int cw_arg, int hw) {
  const int cw = CW > 0 ? CW : cw_arg;
  const int t = blockIdx.x * ROWS_THREADS + threadIdx.x;     // a chunk
  if (t >= rows * cw) return;
  const int row = t / cw;
  const int cell = __ldg(lin + row);
  if ((unsigned)cell < (unsigned)hw)
    canvas[((row / V) * hw + cell) * cw + t % cw] = __ldg(feats + t);
}

template <int CW>
static void rows_copy(const void* feats, const int* lin, void* canvas,
                      int rows, int V, int cw, int hw, int blocks,
                      cudaStream_t stream) {
  pillar_rows_kernel<CW><<<blocks, ROWS_THREADS, 0, stream>>>(
      reinterpret_cast<const uint4*>(feats), lin,
      reinterpret_cast<uint4*>(canvas), rows, V, cw, hw);
}

// feats [B, V, cw chunks], lin [B, V] -> the occupied cells of a zeroed
// canvas [B, hw, cw]; `blocks` blocks of ROWS_THREADS, a thread a chunk
extern "C" int pillar_rows_launch(const void* feats, const int* lin,
                                  void* canvas, int B, int V, int cw, int hw,
                                  int blocks, cudaStream_t stream) {
  const int rows = B * V;
  if (rows == 0 || cw == 0) return (int)cudaSuccess;
  switch (cw) {
    case 4: rows_copy<4>(feats, lin, canvas, rows, V, cw, hw, blocks,
                         stream); break;
    case 8: rows_copy<8>(feats, lin, canvas, rows, V, cw, hw, blocks,
                         stream); break;
    case 16: rows_copy<16>(feats, lin, canvas, rows, V, cw, hw, blocks,
                           stream); break;
    default: rows_copy<0>(feats, lin, canvas, rows, V, cw, hw, blocks,
                          stream);
  }
  return (int)cudaGetLastError();
}

template <int CW>
__global__ void __launch_bounds__(GATHER_THREADS)
pillar_gather_kernel(const uint4* __restrict__ dcanvas,
                     const int* __restrict__ lin,
                     uint4* __restrict__ dfeats, int rows, int V,
                     int cw_arg, int hw) {
  const int cw = CW > 0 ? CW : cw_arg;
  const int t = blockIdx.x * GATHER_THREADS + threadIdx.x;   // a chunk
  if (t >= rows * cw) return;
  const int row = t / cw;
  const int cell = __ldg(lin + row);
  uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
  if ((unsigned)cell < (unsigned)hw)
    chunk = __ldg(dcanvas + ((row / V) * hw + cell) * cw + t % cw);
  dfeats[t] = chunk;
}

template <int CW>
static void gather(const void* dcanvas, const int* lin, void* dfeats,
                   int rows, int V, int cw, int hw, int blocks,
                   cudaStream_t stream) {
  pillar_gather_kernel<CW><<<blocks, GATHER_THREADS, 0, stream>>>(
      reinterpret_cast<const uint4*>(dcanvas), lin,
      reinterpret_cast<uint4*>(dfeats), rows, V, cw, hw);
}

// dcanvas [B, hw, cw chunks of 16 bytes], lin [B, V] -> dfeats [B, V, cw],
// every chunk written; `blocks` blocks of GATHER_THREADS, a thread a
// chunk (the wrapper's plan)
extern "C" int pillar_gather_launch(const void* dcanvas, const int* lin,
                                    void* dfeats, int B, int V, int cw,
                                    int hw, int blocks, cudaStream_t stream) {
  const int rows = B * V;
  if (rows == 0 || cw == 0) return (int)cudaSuccess;
  switch (cw) {
    case 4: gather<4>(dcanvas, lin, dfeats, rows, V, cw, hw, blocks,
                      stream); break;
    case 8: gather<8>(dcanvas, lin, dfeats, rows, V, cw, hw, blocks,
                      stream); break;
    case 16: gather<16>(dcanvas, lin, dfeats, rows, V, cw, hw, blocks,
                        stream); break;
    default: gather<0>(dcanvas, lin, dfeats, rows, V, cw, hw, blocks,
                       stream);
  }
  return (int)cudaGetLastError();
}
