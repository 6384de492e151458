"""Where K1's time goes (the pillar scatter and its gather backward), and
design alternatives, on one NVIDIA GPU.

    python3 pillar_scatter_ablation.py [--parent PATH]

1. builds ``csrc/pillar_scatter.cu`` as it is and variants of it that each
   replace one design choice with an alternative, or leave out one part
   of the work (text substitutions of the source, each of which must
   apply as often as it says, so that they follow it), and with
   ``--parent`` also PATH (an earlier ``pillar_scatter.cu``, e.g. ``git
   show <commit>:automatic_as_built_reconstruction_tpu_torch/csrc/
   pillar_scatter.cu``) and its variants (``PARENT_VARIANTS``); prints the
   registers of each kernel;
2. makes the four K1 shapes of the main paths: the first served pillar
   request of ``chip_smoke.py`` (``asbuilt_pillars.config``, trained
   checkpoint, B = 2, V = hw = 25 600, C = 64) and its first KITTI
   request (``pointpillars/car/xyres_16.config`` on the synthetic clone of
   seed 0, B = 8, V = 12 000, hw = 214 272, C = 64), each in float32 and
   in bfloat16 (the same ids, the features cast); the backward on a
   canvas gradient drawn from a seed at each;
3. checks every variant that is not a timing probe against the plain
   version bit for bit, the forward on a canvas filled with NaN before,
   and times each shape's
   functions in turns (``chip_smoke.take_turns``: CUDA events behind a
   GPU sleep, L2 flushed): the port's call, every variant's kernel, the
   kernel planned for other blocks an SM (``PER_SM``), the empty kernel
   on the plan's grid; with ``--parent`` the ``torch.zeros`` fill alone,
   the parent's kernel alone on a canvas zeroed before, the parent's call
   (fill and kernel), the empty kernel on the parent's grid and the
   parent's kernel with 32-bit index math; prints one JSON line;
4. then, at every shape, checks and times the design ``ALTERNATIVES``
   in turns with the kernel (the ``SORTED_ONLY`` one only where the ids
   ascend, and it must differ on shuffled ids); prints a second JSON
   line.

The variants are timing probes, built into a directory of their own, and
no part of the port calls them; those that leave out work compute wrong
results on purpose.  Needs one GPU; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke
from automatic_as_built_reconstruction_tpu_torch.data.building import (
    generate_building_scene, pad_batch)
from automatic_as_built_reconstruction_tpu_torch.models import pointpillars
from automatic_as_built_reconstruction_tpu_torch.ops import (
    _build, pillar_scatter)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    pod_inference_from_checkpoint)

SOURCE = _build.CSRC_DIR / "pillar_scatter.cu"
TURNS = 50
THREADS = 256                  # the parent's block
# the forward also timed with plans for these blocks an SM
PER_SM = (2, 3, 4, 8)

_ID_LOAD = ("id[u] = q < q_end ? __ldg(ids4 + q) : "
            "make_int4(-1, -1, -1, -1);")
_NO_IDS = [(_ID_LOAD, "id[u] = make_int4(-1, -1, -1, -1);", 2),
           ("threadIdx.x; v < V;\n", "threadIdx.x; v < 0;\n", 1)]
_ROW_LOAD = ("chunk[u] = __ldg(rows + row_of[listed[k / cw]] * cw + "
             "k % cw);")
_ZERO_LOOP = ("  for (int j = threadIdx.x; j < cells * cw; "
              "j += SCATTER_THREADS)\n")
_LIST = "  // 4. the tile's occupied cells, listed in order"
_GATHER_END = "// dcanvas [B, hw, cw chunks of 16 bytes], lin [B, V] -> dfeats"
_GATHER_LOAD = ("chunk = __ldg(dcanvas + ((row / V) * hw + cell) * cw + "
                "t % cw);")
# the write-once design: the zeros written only after the maps are
# complete (each empty cell's chunks, the listed cells' rows in rounds
# whose loads are issued before a segment of the zeros), so that every
# chunk is written once; measured slower than the parent at three of the
# four shapes, where the tile's zeros wait on the ids and the barriers
_WRITE_ONCE = r"""
// a 16-byte load that the compiler issues where it stands: the "memory"
// clobber keeps it ahead of the stores that follow, so that it is in
// flight while they are written (a plain load of __restrict__ data may be
// moved down to its first use)
__device__ __forceinline__ uint4 load_now_once(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

template <int CW>
__global__ void __cluster_dims__(SCATTER_CLUSTER, 1, 1)
__launch_bounds__(SCATTER_THREADS, SCATTER_MIN_BLOCKS)
pillar_scatter_write_once_kernel(const uint4* __restrict__ feats,
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
  // 1. this block's share of the scan's ids -> the cluster's maps: the
  // map set up, this block's arrival at the cluster barrier (a release: it
  // orders the set-up, not the loads after it), the first round of ids
  // loaded, then the wait for the other blocks, with the loads in flight
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
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  while (true) {                           // every map ready for writes
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
  cluster.sync();                          // every map complete

  // 2. the tile's occupied cells, listed in order: each thread counts its
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

  // 3-5. the zeros in as many segments as the rows take rounds of
  // SCATTER_UNROLL chunks a thread: each round's loads issued before its
  // segment of zeros is written (load_now_once), its chunks written after
  const uint4* rows = feats + b * V * cw;
  uint4* out = canvas + b * hw * cw;
  const int n = cells * cw;
  const int round = SCATTER_THREADS * SCATTER_UNROLL;
  const int segments = max(1, (m + round - 1) / round);
  for (int s = 0; s < segments; ++s) {
    uint4 chunk[SCATTER_UNROLL];
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u) {
      const int k = s * round + threadIdx.x + u * SCATTER_THREADS;
      if (k < m)
        chunk[u] = load_now_once(rows + row_of[listed[k / cw]] * cw + k % cw);
    }
    const int j_end = (int)((long long)n * (s + 1) / segments);
#pragma unroll 4
    for (int j = (int)((long long)n * s / segments) + threadIdx.x;
         j < j_end; j += SCATTER_THREADS) {
      const int i = j / cw;                           // the tile's cell
      if (row_of[i] < 0)
        out[cell_of(i, tiles, t) * cw + j % cw] = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u) {
      const int k = s * round + threadIdx.x + u * SCATTER_THREADS;
      if (k < m) out[cell_of(listed[k / cw], tiles, t) * cw + k % cw] =
          chunk[u];
    }
  }
}


extern "C" int pillar_scatter_write_once_launch(
    const void* feats, const int* lin, void* canvas, int B, int V, int cw,
    int hw, int tile, int tiles, cudaStream_t stream) {
  if (B == 0 || hw == 0 || cw == 0) return (int)cudaSuccess;
  const size_t smem = tile * (sizeof(int) + sizeof(unsigned short));
  if (cw == 16)
    pillar_scatter_write_once_kernel<16><<<B * tiles, SCATTER_THREADS, smem,
                                           stream>>>(
        reinterpret_cast<const uint4*>(feats), lin,
        reinterpret_cast<uint4*>(canvas), V, cw, hw, tile, tiles);
  else if (cw == 8)
    pillar_scatter_write_once_kernel<8><<<B * tiles, SCATTER_THREADS, smem,
                                          stream>>>(
        reinterpret_cast<const uint4*>(feats), lin,
        reinterpret_cast<uint4*>(canvas), V, cw, hw, tile, tiles);
  else
    pillar_scatter_write_once_kernel<0><<<B * tiles, SCATTER_THREADS, smem,
                                          stream>>>(
        reinterpret_cast<const uint4*>(feats), lin,
        reinterpret_cast<uint4*>(canvas), V, cw, hw, tile, tiles);
  return (int)cudaGetLastError();
}

"""
# alternative (b): ascending ids only, in a kernel of its own with
# contiguous tiles of ceil(hw / tiles) cells and no cluster.  Each block
# finds its tile's window of ids, [lo, hi), by two rounds of samples
# (every SCATTER_THREADS-th id, then the bracket's ids: two dependent
# loads, no serial search; V <= SCATTER_THREADS^2), reads only those ids
# into its map, as the TPU kernel's searchsorted windows do, then writes
# each chunk of its tile, its row's or zero
_WINDOWED = r"""
template <int CW>
__global__ void __launch_bounds__(SCATTER_THREADS, SCATTER_MIN_BLOCKS)
pillar_scatter_windowed_kernel(const uint4* __restrict__ feats,
                               const int* __restrict__ lin,
                               uint4* __restrict__ canvas, int V, int cw_arg,
                               int hw, int tile, int tiles) {
  extern __shared__ int row_of[];
  const int cw = CW > 0 ? CW : cw_arg;
  const int b = blockIdx.x / tiles;
  const int first = (blockIdx.x - b * tiles) * tile;
  const int cells = max(0, min(tile, hw - first));
  for (int i = threadIdx.x; i < cells; i += SCATTER_THREADS) row_of[i] = -1;
  const int* ids = lin + b * V;
  int lo, hi;
  {
    const int step = (V + SCATTER_THREADS - 1) / SCATTER_THREADS;
    const int k = threadIdx.x * step;
    const int id = k < V ? __ldg(ids + k) : 0x7fffffff;
    const int a = __syncthreads_count(id < first);
    const int c = __syncthreads_count(id < first + cells);
    const int a0 = max(a - 1, 0) * step, c0 = max(c - 1, 0) * step;
    const int ia = a0 + threadIdx.x, ic = c0 + threadIdx.x;
    lo = a0 + __syncthreads_count(threadIdx.x < step && ia < V &&
                                  __ldg(ids + ia) < first);
    hi = c0 + __syncthreads_count(threadIdx.x < step && ic < V &&
                                  __ldg(ids + ic) < first + cells);
  }
  for (int v = lo + threadIdx.x; v < hi; v += SCATTER_THREADS) {
    const unsigned at = (unsigned)__ldg(ids + v) - (unsigned)first;
    if (at < (unsigned)cells) row_of[at] = v;
  }
  __syncthreads();
  const uint4* rows = feats + b * V * cw;
  uint4* out = canvas + (b * hw + first) * cw;
  for (int j = threadIdx.x; j < cells * cw; j += SCATTER_THREADS) {
    const int row = row_of[j / cw];
    out[j] = row >= 0 ? __ldg(rows + row * cw + j % cw)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
}

extern "C" int pillar_scatter_windowed_launch(
    const void* feats, const int* lin, void* canvas, int B, int V, int cw,
    int hw, int tile, int tiles, cudaStream_t stream) {
  if (B == 0 || hw == 0 || cw == 0) return (int)cudaSuccess;
  const int contiguous = (hw + tiles - 1) / tiles;
  pillar_scatter_windowed_kernel<0>
      <<<B * tiles, SCATTER_THREADS, contiguous * sizeof(int), stream>>>(
          reinterpret_cast<const uint4*>(feats), lin,
          reinterpret_cast<uint4*>(canvas), V, cw, hw, contiguous, tiles);
  return (int)cudaGetLastError();
}

"""
# alternative (a): one cooperative launch that zero-fills the canvas,
# passes one grid barrier (a counter and a generation in device memory; it
# traps after COOP_SPIN_LIMIT polls instead of hanging), then copies only
# the occupied rows: the occupied chunks are written twice
_COOPERATIVE = r"""
#include <cuda/atomic>
#define COOP_SPIN_LIMIT (1 << 26)
__device__ unsigned int coop_arrived = 0;
__device__ unsigned int coop_generation = 0;

__device__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> arrived(
        coop_arrived), generation(coop_generation);
    const unsigned int gen = generation.load(cuda::memory_order_acquire);
    if (arrived.fetch_add(1u, cuda::memory_order_acq_rel) ==
        gridDim.x - 1) {
      arrived.store(0u, cuda::memory_order_relaxed);
      generation.store(gen + 1u, cuda::memory_order_release);
    } else {
      long long spins = 0;
      while (generation.load(cuda::memory_order_acquire) == gen)
        if (++spins > COOP_SPIN_LIMIT) __trap();
    }
  }
  __syncthreads();
}

template <int CW>
__global__ void __launch_bounds__(SCATTER_THREADS)
pillar_scatter_cooperative_kernel(const uint4* __restrict__ feats,
                                  const int* __restrict__ lin,
                                  uint4* __restrict__ canvas, int B, int V,
                                  int cw_arg, int hw) {
  const int cw = CW > 0 ? CW : cw_arg;
  const int stride = gridDim.x * SCATTER_THREADS;
  const int start = blockIdx.x * SCATTER_THREADS + threadIdx.x;
  for (int t = start; t < B * hw * cw; t += stride)
    canvas[t] = make_uint4(0u, 0u, 0u, 0u);
  grid_barrier();
  for (int t = start; t < B * V * cw; t += stride) {
    const int row = t / cw;
    const int cell = __ldg(lin + row);
    if ((unsigned)cell < (unsigned)hw)
      canvas[((row / V) * hw + cell) * cw + t % cw] = __ldg(feats + t);
  }
}

template <int CW>
static int cooperative(const void* feats, const int* lin, void* canvas,
                       int B, int V, int cw, int hw, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pillar_scatter_cooperative_kernel<CW>, SCATTER_THREADS, 0);
  void* args[] = {&feats, &lin, &canvas, &B, &V, &cw, &hw};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)pillar_scatter_cooperative_kernel<CW>, dim3(sms * per_sm),
      dim3(SCATTER_THREADS), args, 0, stream);
}

extern "C" int pillar_scatter_cooperative_launch(
    const void* feats, const int* lin, void* canvas, int B, int V, int cw,
    int hw, int tile, int tiles, cudaStream_t stream) {
  if (B == 0 || hw == 0 || cw == 0) return (int)cudaSuccess;
  return cw == 16 ? cooperative<16>(feats, lin, canvas, B, V, cw, hw, stream)
                  : cooperative<0>(feats, lin, canvas, B, V, cw, hw, stream);
}

"""
_GRANULE = "#define SCATTER_GRANULE 16"
_TOP = ("  extern __shared__ int row_of[];          // a cell of the tile "
        "-> its row\n")
_CLUSTER = "#define SCATTER_CLUSTER 2"
_THREADS = "#define SCATTER_THREADS 512"
_MIN_BLOCKS = "#define SCATTER_MIN_BLOCKS 2"
_ID_UNROLL = "#define SCATTER_ID_UNROLL 8"
_UNROLL = "#define SCATTER_UNROLL 4"
# the backward as first designed: a warp owns 32 rows (their ids in one
# load, the rows' chunks walked by the lanes, GATHER_UNROLL in flight a
# lane, a dropped row's zeros without a read), the grid the blocks the
# card holds at once, striding
_GATHER_KERNEL = """template <int CW>
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
"""
_WARP_ROWS_KERNEL = "#define GATHER_UNROLL 16\n" + """template <int CW>
__global__ void __launch_bounds__(GATHER_THREADS)
pillar_gather_kernel(const uint4* __restrict__ dcanvas,
                     const int* __restrict__ lin,
                     uint4* __restrict__ dfeats, int rows, int V,
                     int cw_arg, int hw) {
  const int cw = CW > 0 ? CW : cw_arg;
  const int lane = threadIdx.x & 31;
  const int groups = (rows + 31) / 32;
  const int warps = gridDim.x * (GATHER_THREADS / 32);
  for (int g = blockIdx.x * (GATHER_THREADS / 32) + threadIdx.x / 32;
       g < groups; g += warps) {
    // this lane's row: its first chunk in dcanvas, or -1 (dropped)
    const int r = g * 32 + lane;
    int src = -1;
    if (r < rows) {
      const int cell = __ldg(lin + r);
      if ((unsigned)cell < (unsigned)hw) src = ((r / V) * hw + cell) * cw;
    }
    const int n = min(32, rows - g * 32) * cw;   // the group's chunks
    uint4* out = dfeats + g * 32 * cw;
    for (int j0 = 0; j0 < n; j0 += 32 * GATHER_UNROLL) {
      uint4 chunk[GATHER_UNROLL];
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u) {
        const int j = j0 + u * 32 + lane;
        const int s = __shfl_sync(0xffffffffu, src, (j / cw) & 31);
        chunk[u] = make_uint4(0u, 0u, 0u, 0u);
        if (j < n && s >= 0) chunk[u] = __ldg(dcanvas + s + j % cw);
      }
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u) {
        const int j = j0 + u * 32 + lane;
        if (j < n) out[j] = chunk[u];
      }
    }
  }
}

"""
_GATHER_FN = ("  pillar_gather_kernel<CW><<<blocks, GATHER_THREADS, 0, "
              "stream>>>(")
_RESIDENT_GRID = """  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int need = ((rows + 31) / 32 + GATHER_THREADS / 32 - 1)
                   / (GATHER_THREADS / 32);
  pillar_gather_kernel<CW>
      <<<min(need, sms * (2048 / GATHER_THREADS)), GATHER_THREADS, 0,
         stream>>>("""
# rows copied inline: each thread copies the rows whose ids it reads (in
# its cluster's tiles) right away, half a row's chunks in flight; the
# maps hold a byte a cell; after the maps are complete, the zeros of the
# empty cells alone: every chunk written once
_INLINE = r"""
// rows copied by the thread that reads their id, while the maps are made;
// the map a byte a cell (occupied or not); then the zeros alone
#define INLINE_HALF 8                        // a row's chunks in flight
template <int CW>
__device__ __forceinline__ void take_row(const cg::cluster_group& cluster,
                                         unsigned char* occupied,
                                         const uint4* __restrict__ rows,
                                         uint4* __restrict__ out, int cw_arg,
                                         int id, int row, int hw, int tiles,
                                         unsigned magic, int t0) {
  if ((unsigned)id >= (unsigned)hw) return;
  const int cw = CW > 0 ? CW : cw_arg;
  const int g = id / SCATTER_GRANULE;
  const int q = (int)__umulhi((unsigned)g, magic);
  const int owner = g - q * tiles - t0;
  if ((unsigned)owner >= (unsigned)SCATTER_CLUSTER) return;
  cluster.map_shared_rank(occupied, owner)[q * SCATTER_GRANULE +
                                           id % SCATTER_GRANULE] = 1;
  const uint4* src = rows + row * cw;
  uint4* dst = out + id * cw;
  for (int c0 = 0; c0 < cw; c0 += INLINE_HALF) {
    uint4 chunk[INLINE_HALF];
#pragma unroll
    for (int c = 0; c < INLINE_HALF; ++c)
      if (c0 + c < cw) chunk[c] = __ldg(src + c0 + c);
#pragma unroll
    for (int c = 0; c < INLINE_HALF; ++c)
      if (c0 + c < cw) dst[c0 + c] = chunk[c];
  }
}

template <int CW>
__global__ void __cluster_dims__(SCATTER_CLUSTER, 1, 1)
__launch_bounds__(SCATTER_THREADS, SCATTER_MIN_BLOCKS)
pillar_scatter_inline_kernel(const uint4* __restrict__ feats,
                             const int* __restrict__ lin,
                             uint4* __restrict__ canvas, int V, int cw_arg,
                             int hw, int tile, int tiles) {
  extern __shared__ unsigned char occupied[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cw = CW > 0 ? CW : cw_arg;
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x - b * tiles;
  const int rank = (int)cluster.block_rank();
  const int granules = (hw + SCATTER_GRANULE - 1) / SCATTER_GRANULE;
  const int owned = t < granules ? (granules - 1 - t) / tiles + 1 : 0;
  const int short_by = granules * SCATTER_GRANULE - hw;
  const int cells =
      owned * SCATTER_GRANULE - ((granules - 1) % tiles == t ? short_by : 0);
  for (int i = threadIdx.x; i < cells; i += SCATTER_THREADS) occupied[i] = 0;
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  const int t0 = t - rank;
  const unsigned magic = (unsigned)((0x100000000ull + tiles - 1) / tiles);
  const int* ids = lin + b * V;
  const uint4* rows = feats + b * V * cw;
  uint4* out = canvas + b * hw * cw;
  const int quads =
      (reinterpret_cast<uintptr_t>(ids) & 15) == 0 ? V / 4 : 0;
  const int share = (quads + SCATTER_CLUSTER - 1) / SCATTER_CLUSTER;
  const int q_end = min(quads, (rank + 1) * share);
  const int4* ids4 = reinterpret_cast<const int4*>(ids);
  int q0 = rank * share + threadIdx.x;
  int4 id[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int q = q0 + u * SCATTER_THREADS;
    id[u] = q < q_end ? __ldg(ids4 + q) : make_int4(-1, -1, -1, -1);
  }
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  while (true) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int v = 4 * (q0 + u * SCATTER_THREADS);
      take_row<CW>(cluster, occupied, rows, out, cw, id[u].x, v, hw, tiles,
                   magic, t0);
      take_row<CW>(cluster, occupied, rows, out, cw, id[u].y, v + 1, hw,
                   tiles, magic, t0);
      take_row<CW>(cluster, occupied, rows, out, cw, id[u].z, v + 2, hw,
                   tiles, magic, t0);
      take_row<CW>(cluster, occupied, rows, out, cw, id[u].w, v + 3, hw,
                   tiles, magic, t0);
    }
    q0 += SCATTER_THREADS * 2;
    if (q0 >= q_end) break;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = q0 + u * SCATTER_THREADS;
      id[u] = q < q_end ? __ldg(ids4 + q) : make_int4(-1, -1, -1, -1);
    }
  }
  for (int v = 4 * quads + rank * SCATTER_THREADS + threadIdx.x; v < V;
       v += SCATTER_CLUSTER * SCATTER_THREADS)
    take_row<CW>(cluster, occupied, rows, out, cw, __ldg(ids + v), v, hw,
                 tiles, magic, t0);
  cluster.sync();
#pragma unroll 4
  for (int j = threadIdx.x; j < cells * cw; j += SCATTER_THREADS) {
    const int i = j / cw;
    if (!occupied[i])
      out[cell_of(i, tiles, t) * cw + j % cw] = make_uint4(0u, 0u, 0u, 0u);
  }
}

extern "C" int pillar_scatter_inline_launch(
    const void* feats, const int* lin, void* canvas, int B, int V, int cw,
    int hw, int tile, int tiles, cudaStream_t stream) {
  if (B == 0 || hw == 0 || cw == 0) return (int)cudaSuccess;
  const dim3 grid(B * tiles);
  if (cw == 16)
    pillar_scatter_inline_kernel<16><<<grid, SCATTER_THREADS, tile, stream>>>(
        reinterpret_cast<const uint4*>(feats), lin,
        reinterpret_cast<uint4*>(canvas), V, cw, hw, tile, tiles);
  else if (cw == 8)
    pillar_scatter_inline_kernel<8><<<grid, SCATTER_THREADS, tile, stream>>>(
        reinterpret_cast<const uint4*>(feats), lin,
        reinterpret_cast<uint4*>(canvas), V, cw, hw, tile, tiles);
  else
    pillar_scatter_inline_kernel<0><<<grid, SCATTER_THREADS, tile, stream>>>(
        reinterpret_cast<const uint4*>(feats), lin,
        reinterpret_cast<uint4*>(canvas), V, cw, hw, tile, tiles);
  return (int)cudaGetLastError();
}

"""
# the kernel with each block's phases stamped by the global timer (thread
# 0, after each barrier): start, maps ready, maps complete, list done, end
_HEAD = ("template <int CW>\n"
         "__global__ void __cluster_dims__(SCATTER_CLUSTER, 1, 1)\n")
_STAMPS = r"""__device__ unsigned long long k1_stamps[4096][6];
__device__ __forceinline__ void stamp(int at) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    k1_stamps[blockIdx.x][at] = t;
    k1_stamps[blockIdx.x][5] = sm;
  }
}
extern "C" int k1_stamps_copy(void* dst, cudaStream_t stream) {
  return (int)cudaMemcpyFromSymbolAsync(dst, k1_stamps, sizeof(k1_stamps),
                                        0, cudaMemcpyDeviceToDevice, stream);
}

"""
_ZEROS_DONE = ('  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");'
               '\n')
_MAPS_DONE = ("  cluster.sync();      // every map complete, every zero of "
              "the tile ordered\n")
_LIST_DONE = ("  const int m = warp_total[SCATTER_THREADS / 32 - 1] * cw;  "
              "// rows' chunks\n  __syncthreads();\n")
_KERNEL_END = "          chunk[u];\n    }\n  }\n}\n"
TIMELINE = [(_HEAD, _STAMPS + _HEAD, 1), (_TOP, _TOP + "  stamp(0);\n", 1),
            (_ZEROS_DONE, "  stamp(1);\n" + _ZEROS_DONE, 1),
            (_MAPS_DONE, _MAPS_DONE + "  stamp(2);\n", 1),
            (_LIST_DONE, _LIST_DONE + "  stamp(3);\n", 1),
            (_KERNEL_END, "          chunk[u];\n    }\n  }\n"
                          "  __syncthreads();\n  stamp(4);\n}\n", 1)]
PHASES = ("start to the zeros written", "ids to maps complete", "list",
          "rows")
# name -> (what the variant changes, [(old, new, occurrences), ...])
VARIANTS = {
    "kernel": ("nothing", []),
    "cluster_1": ("no cluster: every block reads all its scan's ids", [
        (_CLUSTER, "#define SCATTER_CLUSTER 1", 1)]),
    "cluster_4": ("clusters of 4 blocks", [
        (_CLUSTER, "#define SCATTER_CLUSTER 4", 1)]),
    "cluster_8": ("clusters of 8 blocks", [
        (_CLUSTER, "#define SCATTER_CLUSTER 8", 1)]),
    "threads_256": ("256 threads a forward block, 4 an SM", [
        (_THREADS, "#define SCATTER_THREADS 256", 1),
        (_MIN_BLOCKS, "#define SCATTER_MIN_BLOCKS 4", 1)]),
    "threads_1024": ("1024 threads a forward block, 1 an SM", [
        (_THREADS, "#define SCATTER_THREADS 1024", 1),
        (_MIN_BLOCKS, "#define SCATTER_MIN_BLOCKS 1", 1)]),
    "id_unroll_4": ("4 id loads in flight a thread", [
        (_ID_UNROLL, "#define SCATTER_ID_UNROLL 4", 1)]),
    "id_unroll_16": ("16 id loads in flight a thread", [
        (_ID_UNROLL, "#define SCATTER_ID_UNROLL 16", 1)]),
    "unroll_8": ("8 row chunks in flight a thread", [
        (_UNROLL, "#define SCATTER_UNROLL 8", 1)]),
    "unroll_16": ("16 row chunks in flight a thread", [
        (_UNROLL, "#define SCATTER_UNROLL 16", 1)]),
    "granule_64": ("granules of 64 cells", [
        (_GRANULE, "#define SCATTER_GRANULE 64", 1)]),
    "granule_256": ("granules of 256 cells", [
        (_GRANULE, "#define SCATTER_GRANULE 256", 1)]),
    "write_once": ("every chunk written once: the zeros after the maps, "
                   "each empty cell's, the rows' loads ahead of them", [
        (_GATHER_END, _WRITE_ONCE + _GATHER_END, 1)]),
    "inline_rows": ("each row copied by the thread that reads its id, "
                    "while the maps are made; no list; then the zeros", [
        (_GATHER_END, _INLINE + _GATHER_END, 1)]),
    "joined_barrier": ("the first cluster barrier whole, after the zeros "
                       "(its release waits for their stores)", [
        ('  asm volatile("barrier.cluster.arrive.release;" ::: "memory");\n',
         "", 1),
        (_ZEROS_DONE, "  cluster.sync();\n", 1)]),
    "gather_warp_rows": ("the backward as first designed: a warp owns 32 "
                         "rows, the card's resident blocks stride", [
        (_GATHER_KERNEL, _WARP_ROWS_KERNEL, 1),
        (_GATHER_FN, _RESIDENT_GRID, 1)]),
    "windowed": ("(b) contiguous tiles that read only their window of "
                 "ascending ids, no cluster", [
        (_GATHER_END, _WINDOWED + _GATHER_END, 1)]),
    "cooperative": ("(a) zero-fills, one grid barrier, copies the occupied "
                    "rows", [(_GATHER_END, _COOPERATIVE + _GATHER_END, 1)]),
    # timing probes that leave out one part of the work (wrong results)
    "floor": ("returns at once (the cluster launch's floor)", [
        (_TOP, _TOP + "  if (tile > 0) return;\n", 1)]),
    "map_only": ("builds the maps and writes nothing", [
        (_LIST, "  if (tile > 0) return;\n" + _LIST, 1)]),
    "no_ids": ("reads no ids: a canvas of zeros", [
        *_NO_IDS]),
    "no_rows": ("reads no rows: the chunk's index in their place", [
        (_ROW_LOAD, "chunk[u] = make_uint4(k, 0u, 0u, 0u);", 1)]),
    "no_zeros": ("writes no zeros", [
        (_ZERO_LOOP, _ZERO_LOOP.replace("j < cells * cw;", "j < 0;"), 1)]),
    "timeline": ("the kernel, each block's phases stamped", TIMELINE),
    "gather_no_loads": ("the backward reads no canvas", [
        (_GATHER_LOAD, "chunk = make_uint4(cell, 0u, 0u, 0u);", 1)]),
}
# the variants whose clusters are larger than the source's: their tiles a
# scan rounded up to a multiple of it
CLUSTER_OF = {"cluster_4": 4, "cluster_8": 8}
# the variants with other granules: their maps sized for them
GRANULE_OF = {"granule_64": 64, "granule_256": 256}
# the launch function of a variant whose kernel is its own
SYMBOL_OF = {"cooperative": "pillar_scatter_cooperative_launch",
             "windowed": "pillar_scatter_windowed_launch",
             "inline_rows": "pillar_scatter_inline_launch",
             "write_once": "pillar_scatter_write_once_launch"}
PROBES = ("floor", "map_only", "no_ids", "no_rows", "no_zeros",
          "gather_no_loads")
SORTED_ONLY = ("windowed",)
# variants that change only the backward, timed there; every other one
# (and the kernel) in the forward
BACKWARD = ("gather_warp_rows", "gather_no_loads")
# the design alternatives, checked and timed after every other variant at
# every shape (a fault there cannot lose the rest)
ALTERNATIVES = ("windowed", "cooperative")

# the parent's kernels with 32-bit index math: (old, new, occurrences)
_PARENT_32 = [
    ("const long long total = rows * cw;",
     "const int total = (int)(rows * cw);", 2),
    ("for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;\n"
     "       t < total; t += (long long)gridDim.x * blockDim.x) {",
     "for (int t = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "       t < total; t += gridDim.x * blockDim.x) {", 2),
    ("const long long row = t / cw;", "const int row = t / cw;", 2),
    ("const long long b = row / V;", "const int b = row / V;", 2)]
# name -> (what the variant changes, [(old, new, occurrences), ...])
PARENT_VARIANTS = {
    "parent": ("the kernels this source replaced", []),
    "parent_32bit": ("the same with 32-bit index math", _PARENT_32),
}


def substitute(text: str, subs, name: str) -> str:
    """``text`` with each (old, new, n) applied; raises where ``old``
    does not occur exactly n times."""
    for old, new, n in subs:
        if text.count(old) != n:
            raise RuntimeError(f"variant {name}: {old!r} occurs "
                               f"{text.count(old)} times, not {n}")
        text = text.replace(old, new)
    return text


def variant_sources() -> dict:
    """{name: CUDA source} of every variant of ``SOURCE``."""
    text = SOURCE.read_text()
    return {name: substitute(text, subs, name)
            for name, (_, subs) in VARIANTS.items()}


def parent_sources(parent: Path) -> dict:
    """{name: CUDA source} of every parent variant."""
    text = parent.read_text()
    return {name: substitute(text, subs, name)
            for name, (_, subs) in PARENT_VARIANTS.items()}


def build(sources: dict, out_dir: Path) -> dict:
    """{name: ctypes library}: one nvcc each, all started together."""
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode and name in ALTERNATIVES + ("inline_rows",):
            chip_smoke.log(f"nvcc {name} failed, the variant is left out:"
                           f"\n{log}")
            continue
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        regs = [x.split(":", 1)[-1].strip() for x in log.splitlines()
                if "registers" in x]
        chip_smoke.log(f"ptxas {name}: {regs}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def parent_fn(lib, symbol: str):
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def parent_launch(lib, symbol: str, src, lin, out, hw: int) -> None:
    """The parent's launch function on ``src`` / ``lin`` into ``out``."""
    B, V = lin.shape
    cw = src.shape[-1] * src.element_size() // 16
    _build.check(parent_fn(lib, symbol)(
        src.data_ptr(), lin.data_ptr(), out.data_ptr(), B, V, cw, hw,
        torch.cuda.current_stream().cuda_stream), symbol)


def parent_grid(B: int, V: int, C: int, e: int) -> tuple:
    """(blocks, threads) of the parent's kernels: a thread a chunk."""
    return -(-B * V * (C * e // 16) // THREADS), THREADS


def record_scatter(pod, request) -> tuple:
    """(feats, lin, hw) of the K1 call of one request through ``pod``."""
    calls = []
    with torch.no_grad(), chip_smoke.recording(
            pointpillars, "scatter_sorted_to_canvas", calls):
        pod(*request)
    torch.cuda.synchronize()
    (feats, lin, hw), _ = calls[0]
    return feats, lin, hw


def shapes(card: str, tmp: Path) -> dict:
    """{shape: (feats, lin, hw)} of the four K1 shapes, and the KITTI
    request's first two scans (training's B = 2) in both types."""
    pod = pod_inference_from_checkpoint(
        chip_smoke.CONFIG, chip_smoke.CHECKPOINT, device="cuda",
        max_voxels=chip_smoke.MAX_VOXELS,
        max_points_per_voxel=chip_smoke.MAX_POINTS)
    asbuilt = record_scatter(pod, pad_batch(
        [generate_building_scene(s) for s in chip_smoke.REQUESTS[0]]))
    root = tmp / "kitti"
    chip_smoke.write_clone(root, False, "pillar_scatter_ablation", card)
    kitti = record_scatter(chip_smoke.kitti_pod("cuda"),
                           chip_smoke.kitti_requests(
                               root, 1, chip_smoke.PP_SERVE_B)[0])
    result = {}
    two = tuple(x[:2].contiguous() for x in kitti[:2]) + (kitti[2],)
    for what, (feats, lin, hw) in (("as-built", asbuilt),
                                   ("KITTI", kitti),
                                   ("KITTI B=2", two)):
        result[f"{what} float32"] = (feats.float().contiguous(), lin, hw)
        result[f"{what} bf16"] = (feats.bfloat16().contiguous(), lin, hw)
    return result


def parent_forward_fns(libs, empty, feats, lin, hw) -> dict:
    """{what: fn} of the parent's forward split at one shape; checks the
    parent's wrapper against the plain version first."""
    B, V, C = feats.shape
    ref = pillar_scatter.scatter_sorted_to_canvas_plain(feats, lin, hw)
    fns = {"zeros fill": lambda: torch.zeros((B, hw, C), dtype=feats.dtype,
                                             device=feats.device)}
    for name in PARENT_VARIANTS:
        canvas = torch.zeros((B, hw, C), dtype=feats.dtype,
                             device=feats.device)
        parent_launch(libs[name], "pillar_scatter_launch", feats, lin,
                      canvas, hw)
        torch.cuda.synchronize()
        if not torch.equal(canvas, ref):
            raise AssertionError(f"{name} forward != plain")

        def kernel_alone(lib=libs[name], canvas=canvas):
            parent_launch(lib, "pillar_scatter_launch", feats, lin, canvas,
                          hw)

        fns[f"{name} kernel"] = kernel_alone
    lib = libs["parent"]

    def wrapper():
        canvas = torch.zeros((B, hw, C), dtype=feats.dtype,
                             device=feats.device)
        parent_launch(lib, "pillar_scatter_launch", feats, lin, canvas, hw)

    fns["parent call (zeros + kernel)"] = wrapper
    blocks, threads = parent_grid(B, V, C, feats.element_size())
    fns[f"empty kernel, parent grid {blocks} x {threads}"] = (
        lambda: empty(blocks, threads))
    return fns


def parent_backward_fns(libs, empty, dcanvas, lin) -> dict:
    """{what: fn} of the parent's backward split at one shape."""
    B, hw, C = dcanvas.shape
    V = lin.shape[1]
    ref = pillar_scatter.pillar_gather_plain(dcanvas, lin)
    fns = {}
    for name in PARENT_VARIANTS:
        out = torch.empty((B, V, C), dtype=dcanvas.dtype,
                          device=dcanvas.device)
        parent_launch(libs[name], "pillar_gather_launch", dcanvas, lin, out,
                      hw)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"{name} backward != plain")
        fns[f"{name} gather"] = (
            lambda lib=libs[name], out=out: parent_launch(
                lib, "pillar_gather_launch", dcanvas, lin, out, hw))
    blocks, threads = parent_grid(B, V, C, dcanvas.element_size())
    fns[f"empty kernel, parent grid {blocks} x {threads}"] = (
        lambda: empty(blocks, threads))
    return fns


def typed(lib, symbol: str, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def scatter_launch(lib, feats, lin, canvas, hw: int, plan,
                   symbol: str = "pillar_scatter_launch") -> None:
    """A variant's forward launch on ``feats`` / ``lin`` into ``canvas``
    with the tiles of ``plan``."""
    B, V, C = feats.shape
    _build.check(typed(lib, symbol, pillar_scatter._SCATTER_ARGTYPES)(
        feats.data_ptr(), lin.data_ptr(), canvas.data_ptr(), B, V,
        C * feats.element_size() // 16, hw, plan.tile, plan.tiles,
        torch.cuda.current_stream().cuda_stream), symbol)


def gather_launch(lib, dcanvas, lin, out, blocks: int) -> None:
    B, hw, C = dcanvas.shape
    _build.check(typed(lib, "pillar_gather_launch",
                       pillar_scatter._GATHER_ARGTYPES)(
        dcanvas.data_ptr(), lin.data_ptr(), out.data_ptr(), B, lin.shape[1],
        C * dcanvas.element_size() // 16, hw, blocks,
        torch.cuda.current_stream().cuda_stream), "pillar_gather_launch")


def rows_launch(lib, feats, lin, canvas, hw: int) -> None:
    """The rows kernel of ``lib`` onto ``canvas`` (zeroed by the caller)."""
    B, V, C = feats.shape
    cw = C * feats.element_size() // 16
    _build.check(typed(lib, "pillar_rows_launch",
                       pillar_scatter._GATHER_ARGTYPES)(
        feats.data_ptr(), lin.data_ptr(), canvas.data_ptr(), B, V, cw, hw,
        -(-B * V * cw // pillar_scatter.ROWS_THREADS),
        torch.cuda.current_stream().cuda_stream), "pillar_rows_launch")


def nan_filled(shape, dtype) -> torch.Tensor:
    return torch.full(shape, float("nan"), dtype=dtype, device="cuda")


def forward_fns(libs, empty, feats, lin, hw: int, sms: int) -> dict:
    """{what: fn} of this source's forward at one shape: the port's call
    (the plan's route), the rows route (a zero fill, the rows kernel), the
    tiles at every shape (the kernel and every forward variant, the kernel
    planned for PER_SM blocks an SM, the empty kernel on the tiles' grid);
    each checked first, the tiles on a canvas of NaN."""
    B, V, C = feats.shape
    ref = pillar_scatter.scatter_sorted_to_canvas_plain(feats, lin, hw)
    plan = pillar_scatter.tile_plan(B, hw, sms)
    got = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
    canvas = torch.zeros((B, hw, C), dtype=feats.dtype, device="cuda")
    rows_launch(libs["kernel"], feats, lin, canvas, hw)
    torch.cuda.synchronize()
    if not (torch.equal(got, ref) and torch.equal(canvas, ref)):
        raise AssertionError("the port's forward or the rows route != plain")

    def rows_route():
        rows_launch(libs["kernel"], feats, lin, torch.zeros(
            (B, hw, C), dtype=feats.dtype, device="cuda"), hw)

    fns = {"port call": lambda: pillar_scatter.scatter_sorted_to_canvas(
        feats, lin, hw), "rows route (zeros + rows kernel)": rows_route}

    def variant_plan(name):
        k = CLUSTER_OF.get(name, pillar_scatter.SCATTER_CLUSTER)
        tiles = -(-plan.tiles // k) * k
        g = GRANULE_OF.get(name, pillar_scatter.SCATTER_GRANULE)
        return pillar_scatter.ScatterPlan(
            "tiles", -(-(-(-hw // g)) // tiles) * g, tiles, B * tiles)

    runs = [(name, libs[name], variant_plan(name)) for name in VARIANTS
            if name not in BACKWARD + ALTERNATIVES and name in libs]
    for per_sm in PER_SM:
        p = pillar_scatter.tile_plan(B, hw, sms, per_sm)
        if p != plan:
            runs.append((f"kernel, {p.tiles} tiles of {p.tile} ({per_sm} "
                         f"an SM)", libs["kernel"], p))
    for per_sm in (1, 2):
        p = pillar_scatter.tile_plan(B, hw, sms, per_sm, cluster=1)
        runs.append((f"cluster_1, {p.tiles} tiles of {p.tile} ({per_sm} an "
                     f"SM)", libs["cluster_1"], p))
    fns.update(variant_fns(runs, feats, lin, hw, ref))
    fns[f"empty kernel, tiles grid {plan.blocks} x "
        f"{pillar_scatter.SCATTER_THREADS}"] = (
        lambda: empty(plan.blocks, pillar_scatter.SCATTER_THREADS))
    return fns


def alternative_fns(libs, feats, lin, hw: int, sms: int) -> dict:
    """{what: fn} of the kernel and the design ALTERNATIVES at one shape,
    each checked first on a canvas of NaN (a SORTED_ONLY one only where
    the ids ascend, and it must differ on shuffled ids)."""
    ref = pillar_scatter.scatter_sorted_to_canvas_plain(feats, lin, hw)
    plan = pillar_scatter.tile_plan(feats.shape[0], hw, sms)
    ascending = bool((lin[:, 1:] >= lin[:, :-1]).all())
    runs = [(name, libs[name], plan) for name in ("kernel",) + ALTERNATIVES
            if (ascending or name not in SORTED_ONLY) and name in libs]
    return variant_fns(runs, feats, lin, hw, ref)


def variant_fns(runs, feats, lin, hw: int, ref) -> dict:
    """{name: fn} of forward launches (name, library, plan), each checked
    against ``ref`` on a canvas of NaN first unless it is a probe."""
    B, V, C = feats.shape
    fns = {}
    for name, lib, p in runs:
        chip_smoke.log(f"  checking {name}")
        symbol = SYMBOL_OF.get(name.split(",")[0], "pillar_scatter_launch")
        canvas = nan_filled((B, hw, C), feats.dtype)
        scatter_launch(lib, feats, lin, canvas, hw, p, symbol)
        torch.cuda.synchronize()
        if name not in PROBES and not torch.equal(canvas, ref):
            raise AssertionError(f"{name} forward != plain")
        if name in SORTED_ONLY:
            perm = torch.randperm(V, device="cuda", generator=torch.Generator(
                "cuda").manual_seed(0))
            shuffled = nan_filled((B, hw, C), feats.dtype)
            scatter_launch(lib, feats[:, perm].contiguous(),
                           lin[:, perm].contiguous(), shuffled, hw, p, symbol)
            torch.cuda.synchronize()
            if torch.equal(shuffled, ref):
                raise AssertionError(f"{name} gave the canvas on shuffled "
                                     f"ids")

        def call(lib=lib, canvas=canvas, p=p, symbol=symbol):
            scatter_launch(lib, feats, lin, canvas, hw, p, symbol)

        fns[name] = call
    return fns


def backward_fns(libs, empty, dcanvas, lin) -> dict:
    """{what: fn} of this source's backward at one shape: the port's call,
    the kernel and the backward variants (each checked first on an output
    of NaN), the empty kernel on the plan's grid."""
    B, hw, C = dcanvas.shape
    V = lin.shape[1]
    ref = pillar_scatter.pillar_gather_plain(dcanvas, lin)
    blocks = pillar_scatter.gather_plan(B, V, C * dcanvas.element_size()
                                        // 16)
    fns = {"port call": lambda: pillar_scatter.pillar_gather(dcanvas, lin)}
    for name in ("kernel",) + BACKWARD:
        out = nan_filled((B, V, C), dcanvas.dtype)
        gather_launch(libs[name], dcanvas, lin, out, blocks)
        torch.cuda.synchronize()
        if name not in PROBES and not torch.equal(out, ref):
            raise AssertionError(f"{name} backward != plain")
        fns[name] = (lambda lib=libs[name], out=out: gather_launch(
            lib, dcanvas, lin, out, blocks))
    fns[f"empty kernel, plan grid {blocks} x "
        f"{pillar_scatter.GATHER_THREADS}"] = (
        lambda: empty(blocks, pillar_scatter.GATHER_THREADS))
    return fns


def empty_launcher(lib: Path):
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(blocks: int, threads: int) -> None:
        _build.check(fn(blocks, threads,
                        torch.cuda.current_stream().cuda_stream),
                     "empty_launch")
    return launch


def timeline(lib, feats, lin, hw: int, plan, card: str, what: str) -> dict:
    """One call of the ``timeline`` variant after an L2 flush: each
    phase's time a block (the global timer, us; median and largest over
    the blocks), and the first block's start to the last block's end."""
    B, V, C = feats.shape
    canvas = torch.empty((B, hw, C), dtype=feats.dtype, device="cuda")
    stamps = torch.zeros((4096, 6), dtype=torch.int64, device="cuda")
    copy = typed(lib, "k1_stamps_copy", (ctypes.c_void_p, ctypes.c_void_p))
    chip_smoke.l2_flush(torch.empty(chip_smoke.L2_FLUSH_BYTES,
                                    dtype=torch.uint8, device="cuda"))
    scatter_launch(lib, feats, lin, canvas, hw, plan)
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(copy(stamps.data_ptr(), stream), "k1_stamps_copy")
    torch.cuda.synchronize()
    t = stamps[:plan.blocks, :5].double() / 1e3
    steps = t[:, 1:] - t[:, :-1]
    result = {phase: [float(steps[:, i].median()), float(steps[:, i].max())]
              for i, phase in enumerate(PHASES)}
    result["first start to last end"] = float(t[:, 4].max() - t[:, 0].min())
    result["last start after first"] = float(t[:, 0].max() - t[:, 0].min())
    # the zeros by the blocks an SM ran (the global timer: us)
    sm = stamps[:plan.blocks, 5]
    sharing = (sm[:, None] == sm[None, :]).sum(1)
    result["zeros by blocks an SM"] = {
        int(n): [float(steps[sharing == n, 0].median()),
                 float(steps[sharing == n, 0].max())]
        for n in sharing.unique()}
    chip_smoke.log(f"{what} [{card}]: phases of a block, us (median, "
                   f"largest): {json.dumps(result)}")
    return result


def timed(what: str, fns: dict, card: str) -> dict:
    turns = chip_smoke.take_turns(fns, TURNS)
    for key, t in turns.items():
        chip_smoke.log(f"{what} [{card}]: {key}: {chip_smoke.fmt_range(t)}")
    return turns


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("pillar_scatter_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    card = chip_smoke.toolchain()
    proc, lib = chip_smoke.start_empty_kernel_build()
    _build.build_all()
    empty = empty_launcher(chip_smoke.finish_empty_kernel_build(proc, lib))
    sms = pillar_scatter.sm_count(torch.device("cuda"))
    times, phases = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sources = variant_sources()
        if args.parent:
            sources.update(parent_sources(args.parent))
        (tmp / "lib").mkdir()
        libs = build(sources, tmp / "lib")
        inputs = shapes(card, tmp)
        gen = torch.Generator("cuda").manual_seed(2)
        for what, (feats, lin, hw) in inputs.items():
            B, V, C = feats.shape
            cw = C * feats.element_size() // 16
            ok = (lin >= 0) & (lin < hw)
            plan = pillar_scatter.tile_plan(B, hw, sms)
            chip_smoke.log(f"{what}: B={B} V={V} C={C} hw={hw} "
                           f"{feats.dtype}, {int(ok.sum())} occupied rows, "
                           f"ids ascending: "
                           f"{bool((lin[:, 1:] >= lin[:, :-1]).all())}; "
                           f"the port's plan "
                           f"{pillar_scatter.scatter_plan(B, V, hw, cw, sms)}"
                           f", the tiles' {plan}, gather blocks "
                           f"{pillar_scatter.gather_plan(B, V, cw)}")
            phases[what] = timeline(libs["timeline"], feats, lin, hw, plan,
                                    card, f"{what} timeline")
            fns = forward_fns(libs, empty, feats, lin, hw, sms)
            if args.parent:
                fns.update(parent_forward_fns(libs, empty, feats, lin, hw))
            times[f"{what} forward"] = timed(f"{what} forward", fns, card)
            dcanvas = torch.randn((B, hw, C), device="cuda",
                                  generator=gen).to(feats.dtype)
            bfns = backward_fns(libs, empty, dcanvas, lin)
            if args.parent:
                bfns.update(parent_backward_fns(libs, empty, dcanvas, lin))
            times[f"{what} backward"] = timed(f"{what} backward", bfns, card)
        print(json.dumps({"card": card, "in_turns_ms": times,
                          "phases_us": phases}), flush=True)
        alternatives = {}
        for what, (feats, lin, hw) in inputs.items():
            alternatives[what] = timed(
                f"{what} alternatives",
                alternative_fns(libs, feats, lin, hw, sms), card)
    print(json.dumps({"card": card, "alternatives_in_turns_ms":
                      alternatives}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
