"""Where the time of the sparse-GEMM kernel goes, on one NVIDIA GPU.

    python3 sparse_gemm_ablation.py
    python3 sparse_gemm_ablation.py --bf16 [--parent PATH]

Without ``--bf16``, the float32 tile:

1. builds ``csrc/sparse_gather_gemm.cu`` as it is, variants of it that
   each leave out one part of the work or replace one design choice with
   the alternative it was measured against (text substitutions of the
   source, each of which must apply exactly once, so that they follow
   it), and a probe of the card's ``mma.sync`` m16n8k8 TF32 issue rate;
   prints the registers ptxas gives each variant's 64 -> 64 key-match
   kernel;
2. serves one SECOND request (``car.fhd.serving.config``, seeded weights,
   as ``chip_smoke.py`` does) to record the arguments of its key-match
   joins;
3. times every variant on every join (device time, torch.profiler, L2
   flushed before each call) and prints one JSON line.

With ``--bf16``, the bfloat16 tile (K4 and K3s in bf16):

1. builds the source as it is and its ``BF16_VARIANTS`` (leave-out probes
   and design alternatives, by text substitution as above); with
   ``--parent``, also PATH (the parent commit's
   ``csrc/sparse_gather_gemm.cu``, e.g. ``git show <commit>:<path> >
   scratch_checkout/parent.cu``) and its ``PARENT_BF16_VARIANTS``, so that
   the tile this one replaced is split and timed in the same call;
2. serves one bfloat16 ``car.fhd.serving`` request (the config with
   ``enable_mixed_precision``, seeded weights) and one ``car.fhd.mixed``
   request to record the arguments of their key-match and gather joins;
3. checks that the unmodified build, the design alternatives of
   ``BF16_SAME_BITS`` (among them two persistent grids) and the parent's
   give the port's results (the parent within 1e-4 of max |out|: its sums
   run in another order; the others bit for bit), then times every
   variant on every join in turns (``chip_smoke.take_turns``: CUDA events
   behind a GPU sleep, L2 flushed);
4. times the host's side of one launch of each tile (``launch_host_us``);
   with ``--parent``, times the float32 tiles against the parent's and
   holds them to the parent's bits on every join of a float32 car.fhd
   training step at B = 6 (``float32_step_equal``); prints one JSON line.

The leave-out probes compute wrong results on purpose: like every
variant, they are built into a directory of their own, and no part of
the port calls them.
Needs one GPU; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke
from automatic_as_built_reconstruction_tpu_torch.data.building import (
    pad_batch)
from automatic_as_built_reconstruction_tpu_torch.data.kitti_like import (
    make_scene)
from automatic_as_built_reconstruction_tpu_torch.models import middle
from automatic_as_built_reconstruction_tpu_torch.ops import (
    _build, sparse_gather_gemm)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    pod_inference_from_checkpoint)

SOURCE = _build.CSRC_DIR / "sparse_gather_gemm.cu"
# name -> (what the variant changes, [(old, new), ...]).  The first group
# leaves out one part of the work; the second replaces one design choice
# with the alternative that was measured against it.
VARIANTS = {
    "kernel": ("nothing", []),
    "lookups_only": ("leaves out every tap after the lookups", [
        ("  const int n = taps[K];", "  const int n = 0 * taps[K];")]),
    "no_multiply": ("leaves out the products (lookups and copies stay)", [
        ("    if (__any_sync(FULL, src[k * TILE_R + warp * 16 + (lane & 15)] "
         ">= 0))", "    if (false)")]),
    "no_copies": ("leaves out the copies after the first tap (products of "
                  "stale stages)", [
        ("    if (t + 1 < n) {                  // the next tap",
         "    if (false) {                  // the next tap")]),
    "no_split": ("leaves out the 3xTF32 split (TF32 products of unrounded "
                 "bits)", [
        ("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  small = __float_as_uint(x - __uint_as_float(big));",
         "  big = __float_as_uint(x);\n  small = 0u;")]),
    "one_mma": ("leaves out two of the three mmas of a k-step", [
        ("      mma(d, as, b0b, b1b);\n      mma(d, ab, b0s, b1s);\n", "")]),
    "cvt_split": ("rounds the split with cvt.rna.tf32.f32 (emulated on "
                  "sm_90)", [
        ("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  small = __float_as_uint(x - __uint_as_float(big));",
         '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));\n'
         "  const float rest = x - __uint_as_float(big);\n"
         '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));')]),
    "no_min_blocks": ("drops the minimum of 2 blocks from __launch_bounds__ "
                      "(ptxas keeps fewer registers)", [
        ("__launch_bounds__(THREADS, MIN_BLOCKS)\ngather_gemm_kernel",
         "__launch_bounds__(THREADS)\ngather_gemm_kernel"),
        ("__launch_bounds__(THREADS, MIN_BLOCKS)\nkeymatch_gemm_kernel",
         "__launch_bounds__(THREADS)\nkeymatch_gemm_kernel")]),
    "one_tap_lookups": ("looks up one tap at a time in a warp", [
        ("constexpr int TB = 4; ", "constexpr int TB = 1; ")]),
    "tile_128_rows": ("128-row tiles of 8 warps, one block an SM (half the "
                      "weight traffic)", [
        ("constexpr int TILE_R = 64; ", "constexpr int TILE_R = 128;"),
        ("constexpr int MIN_BLOCKS = 2; ", "constexpr int MIN_BLOCKS = 1; ")]),
    "weights_via_l1": ("copies W[k] with cp.async.ca (through L1)", [
        ("      cp_async16(Ws + c * LDW + 4 * q, Wk + 4 * i, true);",
         '      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"\n'
         "                   :: \"r\"((unsigned)__cvta_generic_to_shared(\n"
         "                          Ws + c * LDW + 4 * q)),\n"
         "                      \"l\"(Wk + 4 * i) : \"memory\");")]),
}
# A persistent form of the bf16 tile, for BF16_VARIANTS: the grid holds as
# many blocks a scan as fit the card at once, each walking the scan's
# tiles blockIdx.x, + gridDim.x, ...  Threads 0-255 are the two consumer
# warpgroups (the copies and products of sparse_gemm_tile_bf16); threads
# 256-383 a lookup warpgroup, which finds the sources of the block's next
# tile into the other of two buffers while the consumers work on this one
# (found[b]: buffer b's sources are in; free[b]: the consumers are done
# with them).  The copies run stages - 1 taps ahead of the products across
# tiles, but never into a tile past the next one.  Debug waits (a trap
# after 2^24 tries) instead of a hang if the rings deadlock.
PERSISTENT_TILE = r"""
constexpr int PT_CONSUMERS = 128 * BF_CONSUMERS;

template <int COUT, class Lookup>
__device__ void persistent_tile_bf16(const bf16_bits* __restrict__ feats,
                                     float* __restrict__ out, int R, int K,
                                     int Cin, int a_chunk,
                                     const CUtensorMap& w_map,
                                     const Lookup& lookup) {
  constexpr int NP = COUT / 2;
  extern __shared__ uint8_t smem_bf16[];
  const LayoutBf16 L(Cin, COUT);
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_bf16);
  uint8_t* smem = smem_bf16 + ((BF_ALIGN - raw % BF_ALIGN) % BF_ALIGN);
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t bars = base + (uint32_t)L.ring_bytes();   // full, empty
  const uint32_t found_bar = bars + 16 * BF_STAGES, free_bar = found_bar + 16;
  // two buffers of src [K][BF_ROWS], flags [K], list [K + 1]
  int* const bufs = reinterpret_cast<int*>(smem + L.ring_bytes()
                                           + 16 * BF_STAGES + 32);
  const int per_buf = K * BF_ROWS + 2 * K + 1;
  const int tiles = (R + BF_ROWS - 1) / BF_ROWS;
  const int warp = threadIdx.x >> 5;
  const int stage_bytes = L.a_bytes + L.w_bytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < BF_STAGES; ++s) {
      mbar_init(bars + 8 * s, PT_CONSUMERS + 1);              // full
      mbar_init(bars + 8 * (BF_STAGES + s), PT_CONSUMERS);    // empty
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(found_bar + 8 * b, 128);
      mbar_init(free_bar + 8 * b, PT_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const uint32_t a_mask = swizzle_mask(L.a_row), w_mask = swizzle_mask(L.b_row);
  const int pad = L.kp - Cin;
  for (int i = threadIdx.x; i < BF_STAGES * BF_ROWS * pad; i += blockDim.x) {
    const int s = i / (BF_ROWS * pad), e = i - s * BF_ROWS * pad;
    const int r = e / pad, col = Cin + (e - r * pad);
    *reinterpret_cast<bf16_bits*>(
        smem + s * stage_bytes + swizzled(L.a_offset(r, col), a_mask)) = 0;
  }
  for (int i = threadIdx.x; i < BF_STAGES * pad * COUT; i += blockDim.x) {
    const int s = i / (pad * COUT), e = i - s * pad * COUT;
    const int c = Cin + e / COUT, n = e % COUT;
    *reinterpret_cast<bf16_bits*>(smem + s * stage_bytes + L.a_bytes
                                  + swizzled(L.w_offset(c, n), w_mask)) = 0;
  }
  if (pad) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x >= PT_CONSUMERS) {        // the lookup warpgroup
    for (int i = 0, tile = blockIdx.x; tile < tiles; ++i, tile += gridDim.x) {
      const int b = i & 1;
      if (i >= 2) mbar_wait(free_bar + 8 * b, ((i >> 1) - 1) & 1);
      int* src = bufs + b * per_buf;
      find_sources<BF_ROWS, 4>(lookup, src, src + K * BF_ROWS,
                               tile * BF_ROWS, R, K);
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (warp == PT_CONSUMERS / 32)
        list_taps_bf16(src + K * BF_ROWS, src + K * BF_ROWS + K, K);
      mbar_arrive(found_bar + 8 * b);
    }
    return;
  }

  const int g = threadIdx.x >> 7;
  const int ahead = BF_STAGES - 1;
  const int ksteps = (Cin + 15) / 16;
  // the copy cursor: the ci-th of the block's tiles (ctile), its next tap
  // cu, its taps listed (-1 until its sources are in); uc taps copied
  int ci = 0, ctile = blockIdx.x, cu = 0, clisted = -1, uc = 0;
  // the next tap's copies, if it lies in the block's tiles up to the
  // last-th; false if none is left there
  auto copy_next = [&](int last) -> bool {
    for (;;) {
      if (ctile >= tiles || ci > last) return false;
      if (clisted < 0) {
        mbar_wait(found_bar + 8 * (ci & 1), (ci >> 1) & 1);
        clisted = bufs[(ci & 1) * per_buf + K * BF_ROWS + 2 * K];
      }
      if (cu < clisted) break;
      ++ci;
      ctile += gridDim.x;
      cu = 0;
      clisted = -1;
    }
    const int* src = bufs + (ci & 1) * per_buf;
    const int e = src[K * BF_ROWS + K + cu], k = e & 0xffff;
    const int s = uc % BF_STAGES;
    const uint32_t full = bars + 8 * s, a_s = base + s * stage_bytes;
    if (uc >= BF_STAGES)
      mbar_wait(bars + 8 * (BF_STAGES + s), (uc / BF_STAGES - 1) & 1);
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full, Cin * COUT * 2);
      for (int nb = 0; nb < COUT; nb += 64)
        tma_load_2d(a_s + L.a_bytes + (nb / 64) * L.kp * 128, &w_map, nb,
                    k * Cin, full);
    }
    copy_rows_bf16(a_s, feats, src + k * BF_ROWS, e >> 16, Cin, L, a_chunk);
    cp_async_arrive(full);
    ++cu;
    ++uc;
    return true;
  };

  float acc[NP], p[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) acc[i] = p[i] = 0.f;
  int up = 0;                               // taps multiplied
  for (int i = 0, tile = blockIdx.x; tile < tiles; ++i, tile += gridDim.x) {
    mbar_wait(found_bar + 8 * (i & 1), (i >> 1) & 1);
    const int* list = bufs + (i & 1) * per_buf + K * BF_ROWS + K;
    const int listed = list[K];
    while (uc < up + ahead && copy_next(i + 1)) {
    }
    for (int t = 0; t < listed; ++t, ++up) {
      const int s = up % BF_STAGES;
      mbar_wait(bars + 8 * s, (up / BF_STAGES) & 1);
      __syncwarp();
      if (list[t] >> (16 + g) & 1)
        multiply_tap_bf16<COUT>(p, base + s * stage_bytes,
                                base + s * stage_bytes + L.a_bytes, L,
                                ksteps);
      wgmma_commit();
      wgmma_wait<0>();
      pin<NP>(p);
      mbar_arrive(bars + 8 * (BF_STAGES + s));
      while (uc < up + 1 + ahead && copy_next(i + 1)) {
      }
      if (list[t] >> (16 + g) & 1) {
#pragma unroll
        for (int j = 0; j < NP; ++j) acc[j] += p[j];
      }
    }
    mbar_arrive(free_bar + 8 * (i & 1));
    const int lane = threadIdx.x & 31;
    const int r = tile * BF_ROWS + g * 64 + (warp & 3) * 16 + (lane >> 2);
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < COUT / 8; ++nt) {
      if (r < R)
        *reinterpret_cast<float2*>(out + (size_t)r * COUT + nt * 8 + c) =
            make_float2(acc[4 * nt], acc[4 * nt + 1]);
      if (r + 8 < R)
        *reinterpret_cast<float2*>(out + (size_t)(r + 8) * COUT + nt * 8
                                   + c) =
            make_float2(acc[4 * nt + 2], acc[4 * nt + 3]);
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) acc[j] = 0.f;
  }
}

"""
_GATHER_KERNEL = ("template <int COUT>\n__global__ void __launch_bounds__("
                  "BF_THREADS, BF_MIN_BLOCKS(COUT))\ngather_gemm_bf16_kernel")
PERSISTENT = [
    # a third warpgroup; the lookups' warps counted from 0 within it
    ("constexpr int BF_THREADS = 128 * BF_CONSUMERS;",
     "constexpr int BF_THREADS = 128 * (BF_CONSUMERS + 1);"),
    ("  for (int k0 = threadIdx.x >> 5; k0 < K; k0 += NWARPS * TB) {",
     "  for (int k0 = (threadIdx.x >> 5) % NWARPS; k0 < K; "
     "k0 += NWARPS * TB) {"),
    # two source buffers and their two barriers each
    ("    return BF_ALIGN + ring_bytes() + 2 * BF_STAGES * 8\n"
     "           + ((size_t)K * BF_ROWS + 2 * K + 1) * 4;",
     "    return BF_ALIGN + ring_bytes() + 2 * BF_STAGES * 8 + 32\n"
     "           + 2 * ((size_t)K * BF_ROWS + 2 * K + 1) * 4;"),
    ("__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {",
     "#define SPARSE_GEMM_WAIT_LIMIT (1LL << 24)\n"
     "__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {"),
    # as many blocks a scan as fit the card at once
    ("  const dim3 grid((R + BF_ROWS - 1) / BF_ROWS, B);",
     "  int device = 0, sms = 0, per_sm = 0;\n"
     "  cudaGetDevice(&device);\n"
     "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);\n"
     "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,\n"
     "                                                BF_THREADS, smem);\n"
     "  const int tiles = (R + BF_ROWS - 1) / BF_ROWS;\n"
     "  const int blocks = sms * per_sm / B;\n"
     "  const dim3 grid(blocks < 1 ? 1 : blocks < tiles ? blocks : tiles, B);"),
    ("  const RulebookLookup lookup{idx + bz * K * R, found + bz * K * R, N};\n"
     "  sparse_gemm_tile_bf16<COUT>(",
     "  const RulebookLookup lookup{idx + bz * K * R, found + bz * K * R, N};\n"
     "  persistent_tile_bf16<COUT>("),
    ("                         *sorted_flag != 0};\n"
     "  sparse_gemm_tile_bf16<COUT>(",
     "                         *sorted_flag != 0};\n"
     "  persistent_tile_bf16<COUT>("),
    (_GATHER_KERNEL, PERSISTENT_TILE + _GATHER_KERNEL),
]
# The bf16 tile's variants, applied to SOURCE.  The first group leaves
# out one part of the work; the second replaces one design choice.
BF16_VARIANTS = {
    "bf16_kernel": ("nothing", []),
    "bf16_lookups_only": ("leaves out every tap after the lookups", [
        ("  const int listed = list[K];", "  const int listed = 0 * list[K];")]),
    "bf16_no_multiply": ("leaves out the products (lookups, copies and the "
                         "ring stay)", [
        ("    if (list[t] >> (16 + g) & 1)\n      multiply_tap_bf16<COUT>(",
         "    if (false)\n      multiply_tap_bf16<COUT>(")]),
    "bf16_no_copies": ("leaves out the copies after the ring's first "
                       "fill (products of stale stages)", [
        ("      mbar_arrive_expect_tx(full, Cin * COUT * 2);\n"
         "      for (int nb = 0; nb < COUT; nb += 64)",
         "      mbar_arrive_expect_tx(full, u < ahead ? Cin * COUT * 2 : 0);\n"
         "      for (int nb = 0; nb < (u < ahead ? COUT : 0); nb += 64)"),
        ("    copy_rows_bf16(a_s, feats,",
         "    if (u < ahead) copy_rows_bf16(a_s, feats,")]),
    "bf16_no_weight_copies": ("leaves out W[k]'s copies after the ring's "
                              "first fill (the rows stay)", [
        ("      mbar_arrive_expect_tx(full, Cin * COUT * 2);\n"
         "      for (int nb = 0; nb < COUT; nb += 64)",
         "      mbar_arrive_expect_tx(full, u < ahead ? Cin * COUT * 2 : 0);\n"
         "      for (int nb = 0; nb < (u < ahead ? COUT : 0); nb += 64)")]),
    "bf16_no_row_copies": ("leaves out the rows' copies after the ring's "
                           "first fill (W[k] stays)", [
        ("    copy_rows_bf16(a_s, feats,",
         "    if (u < ahead) copy_rows_bf16(a_s, feats,")]),
    "bf16_no_zero_fill": ("leaves out the zero-filling copies of rows "
                          "with no source (wrong sums: a timing probe)", [
        ("    cp_async_to(a_s + swizzled(L.a_offset(r, e * q), a_mask),\n"
         "                feats + (size_t)(j < 0 ? 0 : j) * Cin + e * q, "
         "a_chunk,\n                j >= 0);",
         "    if (j >= 0)\n"
         "      cp_async_to(a_s + swizzled(L.a_offset(r, e * q), a_mask),\n"
         "                  feats + (size_t)j * Cin + e * q, a_chunk, true);")]),
    "bf16_tile_64_rows": ("64-row tiles: one consumer warpgroup a block, "
                          "W[k] copied for 64 rows", [
        ("constexpr int BF_CONSUMERS = 2; ", "constexpr int BF_CONSUMERS = 1; ")]),
    "bf16_stages_2": ("a ring of 2 stages (copies one tap ahead)", [
        ("constexpr int BF_STAGES = 3; ", "constexpr int BF_STAGES = 2; ")]),
    "bf16_stages_4": ("a ring of 4 stages (copies 3 taps ahead)", [
        ("constexpr int BF_STAGES = 3; ", "constexpr int BF_STAGES = 4; ")]),
    "bf16_persistent": ("a persistent grid, one block an SM: a lookup "
                        "warpgroup finds tile i + 1's sources while two "
                        "consumer warpgroups copy and multiply tile i; a "
                        "ring of 4 stages", PERSISTENT + [
        ("#define BF_MIN_BLOCKS(COUT) ((COUT) >= 128 ? 1 : 2)",
         "#define BF_MIN_BLOCKS(COUT) 1"),
        ("constexpr int BF_STAGES = 3; ", "constexpr int BF_STAGES = 4; ")]),
    "bf16_persistent_2_blocks": ("the same, two blocks an SM (ptxas keeps "
                                 "80 registers a thread); a ring of 3 "
                                 "stages", PERSISTENT),
    "bf16_ring_only": ("leaves out the copies after the ring's first fill "
                       "and the products: the ring's barriers alone", [
        ("      mbar_arrive_expect_tx(full, Cin * COUT * 2);\n"
         "      for (int nb = 0; nb < COUT; nb += 64)",
         "      mbar_arrive_expect_tx(full, u < ahead ? Cin * COUT * 2 : 0);\n"
         "      for (int nb = 0; nb < (u < ahead ? COUT : 0); nb += 64)"),
        ("    copy_rows_bf16(a_s, feats,",
         "    if (u < ahead) copy_rows_bf16(a_s, feats,"),
        ("    if (list[t] >> (16 + g) & 1)\n      multiply_tap_bf16<COUT>(",
         "    if (false)\n      multiply_tap_bf16<COUT>(")]),
}
# The design alternatives above that compute the shipped tile's function
# in its order of sums: they must give its bits before they are timed.
BF16_SAME_BITS = ("bf16_tile_64_rows", "bf16_stages_2", "bf16_stages_4",
                  "bf16_persistent", "bf16_persistent_2_blocks")
# The parent's bf16 tile (mma.sync, a 2-stage cp.async ring, 64-row
# tiles), applied to the source given by --parent.
PARENT_BF16_VARIANTS = {
    "parent_bf16": ("the tile this one replaced", []),
    "parent_bf16_lookups_only": ("its lookups alone", [
        ("  const int listed = taps[K];", "  const int listed = 0 * taps[K];")]),
    "parent_bf16_no_multiply": ("without its products", [
        ("    if (warp_has_rows)\n", "    if (false)\n")]),
    "parent_bf16_no_copies": ("without its copies after the first tap", [
        ("    if (t + 1 < listed) {             // tap t + 1 into the other "
         "stage", "    if (false) {             // tap t + 1 into the other "
         "stage")]),
}
PROBE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
// CHAINS independent m16n8k8 TF32 mmas per iteration in every warp
constexpr int CHAINS = 8;
extern "C" __global__ void hmma_probe(float* out, long long* cycles,
                                      int iters) {
  uint32_t a[4], b0 = __float_as_uint(1e-3f), b1 = __float_as_uint(2e-3f);
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  float d[CHAINS][4] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                   "{%0, %1, %2, %3};\n"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]),
                     "+f"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                     "r"(b1));
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
// blocks_per_sm blocks of warps_per_block warps on every SM (shared memory
// keeps more from sharing an SM)
extern "C" int hmma_probe_launch(float* out, long long* cycles, int sms,
                                 int blocks_per_sm, int warps_per_block,
                                 int iters) {
  const int smem = 200 * 1024 / blocks_per_sm;
  cudaFuncSetAttribute(hmma_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  hmma_probe<<<sms * blocks_per_sm, warps_per_block * 32, smem>>>(out, cycles,
                                                                  iters);
  return (int)cudaGetLastError();
}
'''


def variant_sources(variants: dict = VARIANTS, text: str = None) -> dict:
    """{name: CUDA source} of every variant of ``variants`` (default: the
    float32 tile's) applied to ``text`` (default: ``SOURCE``); raises
    where a substitution does not occur exactly once."""
    text = SOURCE.read_text() if text is None else text
    sources = {}
    for name, (_, subs) in variants.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} occurs "
                                   f"{src.count(old)} times in the source")
            src = src.replace(old, new)
        sources[name] = src
    return sources


def build(out_dir: Path, sources: dict = None,
          report: str = "keymatch_gemm_kernelILi64") -> dict:
    """{name: ctypes library}: every variant (default: the float32 tile's
    and the probe), one nvcc each, all started together; ptxas' registers
    of the kernel named by ``report`` are logged."""
    if sources is None:
        sources = variant_sources()
        sources["probe"] = PROBE
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
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and report in line:
                props = [x.strip() for x in lines[i + 1:i + 4]
                         if "registers" in x or "spill" in x]
                chip_smoke.log(f"ptxas {name}: {report}: {'; '.join(props)}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def probe_rate(lib) -> dict:
    """mma.sync TF32 issue rate per SM at 8 and at 32 warps an SM: m16n8k8
    instructions per SM clock and the TFLOP/s they give at the card's
    clock (events)."""
    fn = lib.hmma_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, chains, result = 4096, 8, {}
    for blocks, warps in ((2, 4), (4, 8)):
        out = torch.empty(sms * blocks * warps * 32, device="cuda")
        cycles = torch.empty(sms * blocks, dtype=torch.int64, device="cuda")
        for _ in range(2):          # the second run is timed
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(out.data_ptr(), cycles.data_ptr(), sms, blocks, warps,
                     iters)
            end.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"hmma_probe_launch: cudaError {err}")
        per_sm = blocks * warps * iters * chains
        result[f"{blocks * warps}_warps_per_sm"] = {
            "hmma_per_sm_clock": per_sm / float(cycles.double().mean()),
            "tflops": sms * per_sm * 2 * 16 * 8 * 8
            / (start.elapsed_time(end) * 1e-3) / 1e12}
    return result


def launch(lib, feats, in_keys, q_keys, w):
    fn = lib.keymatch_gemm_launch
    fn.argtypes = list(sparse_gather_gemm._KEYMATCH_ARGTYPES)
    fn.restype = ctypes.c_int
    B, N, Cin = feats.shape
    K, _, Cout = w.shape
    R = q_keys.shape[-1]
    ascending = (in_keys[..., 1:] >= in_keys[..., :-1]).all()
    out = torch.empty((B, R, Cout), device="cuda")
    err = fn(feats.data_ptr(), in_keys.data_ptr(), q_keys.data_ptr(),
             ascending.data_ptr(), w.data_ptr(), out.data_ptr(), B, N, R, K,
             Cin, Cout, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"keymatch_gemm_launch: cudaError {err}")
    return out


def launch_bf16(lib, keymatch: bool, feats, table, query, w):
    """The bf16 tile of ``lib`` on one recorded join: key-match (feats,
    in_keys, q_keys, w) or gather (feats, idx, found, w)."""
    B, N, Cin = feats.shape
    K, _, Cout = w.shape
    R = query.shape[-1] if keymatch else table.shape[-1]
    out = torch.empty((B, R, Cout), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if keymatch:
        fn = lib.keymatch_gemm_bf16_launch
        fn.argtypes = list(sparse_gather_gemm._KEYMATCH_ARGTYPES)
        ascending = (table[..., 1:] >= table[..., :-1]).all()
        args = (feats.data_ptr(), table.data_ptr(), query.data_ptr(),
                ascending.data_ptr())
    else:
        fn = lib.gather_gemm_bf16_launch
        fn.argtypes = list(sparse_gather_gemm._GATHER_ARGTYPES)
        args = (feats.data_ptr(), table.data_ptr(), query.data_ptr())
    fn.restype = ctypes.c_int
    err = fn(*args, w.data_ptr(), out.data_ptr(), B, N, R, K, Cin, Cout,
             stream)
    if err:
        raise RuntimeError(f"bf16 launch: cudaError {err}")
    return out


def bf16_joins(tmp: Path) -> dict:
    """{"keymatch": joins of a bf16 car.fhd.serving request, "gather":
    joins of a car.fhd.mixed request}, each join (feats, keys or idx,
    query keys or found, weights), contiguous."""
    joins = {}
    for form, config, name in (
            ("keymatch", chip_smoke.with_mixed_precision(
                chip_smoke.SECOND_CONFIG, tmp), "keymatch_gemm"),
            ("gather", chip_smoke.MIXED_CONFIG, "gather_gemm")):
        pod = pod_inference_from_checkpoint(
            config, None, device="cuda", seed=chip_smoke.SECOND_SEED,
            max_voxels=chip_smoke.SECOND_MAX_VOXELS,
            max_points_per_voxel=chip_smoke.SECOND_MAX_POINTS)
        calls = []
        with chip_smoke.recording(middle, name, calls):
            pod(*pad_batch([make_scene(s)
                            for s in chip_smoke.SECOND_REQUESTS[0]]))
        torch.cuda.synchronize()
        joins[form] = [tuple(t.contiguous() for t in c[0][:4])
                       for c in calls]
        if not all(j[0].dtype == torch.bfloat16 for j in joins[form]):
            raise AssertionError(f"{form}: not the bf16 joins")
    return joins


def main_bf16(parent: Path, card: str) -> int:
    """The bf16 study (module docstring)."""
    sources = variant_sources(BF16_VARIANTS)
    if parent is not None:
        sources.update(variant_sources(PARENT_BF16_VARIANTS,
                                       parent.read_text()))
    turns = 10
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), sources, "keymatch_gemm_bf16_kernelILi64")
        joins = bf16_joins(Path(tmp))
        result = {"card": card, "turns": turns, "variants": {
            n: (BF16_VARIANTS.get(n) or PARENT_BF16_VARIANTS[n])[0]
            for n in libs}}
        for form, calls in joins.items():
            keymatch = form == "keymatch"
            port = (sparse_gather_gemm.keymatch_gemm if keymatch
                    else sparse_gather_gemm.gather_gemm)
            for name in ("bf16_kernel", "parent_bf16") + BF16_SAME_BITS:
                if name not in libs:
                    continue
                for j in calls:
                    got = launch_bf16(libs[name], keymatch, *j)
                    want = port(*j)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    tol = (1e-4 * float(want.abs().max())
                           if name == "parent_bf16" else 0.0)
                    if not err <= tol:
                        raise AssertionError(
                            f"{name} {form}: {err} from the port's kernel "
                            f"at {chip_smoke.join_shape((j, {}))}")
                chip_smoke.log(f"bf16 {form} {name}: the port's results on "
                               f"all {len(calls)} joins")
            times = {n: [] for n in libs}
            for j in calls:
                t = chip_smoke.take_turns(
                    {n: (lambda lib=lib, j=j: launch_bf16(lib, keymatch, *j))
                     for n, lib in libs.items()}, turns)
                for n in libs:
                    times[n].append(t[n][0])
            summed = {n: sum(v) for n, v in times.items()}
            largest = max(range(len(calls)), key=lambda i: (
                calls[i][0].shape[0] * calls[i][0].shape[1]
                * calls[i][3].numel()))
            for n in libs:
                chip_smoke.log(
                    f"bf16 {form} {n} [{card}]: {summed[n]:.5f} ms summed "
                    f"over {len(calls)} joins; largest join "
                    f"{times[n][largest]:.5f} ms; "
                    f"{[round(x, 5) for x in times[n]]}")
            result[form] = {
                "joins": [chip_smoke.join_shape((j, {})) for j in calls],
                "largest": largest, "device_ms": times,
                "summed_ms": summed}
        result["host_us"] = launch_host_us(libs["bf16_kernel"],
                                           joins["keymatch"], card)
        if "parent_bf16" in libs:
            result["float32"] = float32_in_turns(
                libs["bf16_kernel"], libs["parent_bf16"], joins["keymatch"],
                card)
            result["float32_step_joins"] = float32_step_equal(
                libs["bf16_kernel"], libs["parent_bf16"], Path(tmp), card)
    print(json.dumps(result))
    return 0


def host_us(fn, calls: int = 200) -> float:
    """The host's time for one call of ``fn`` in microseconds (the calls
    are queued, not waited for), median of 5 runs of ``calls``."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def launch_host_us(lib, calls, card: str) -> dict:
    """The host's time of one launch through the library's C entry (by
    ctypes) at the smallest key-match join: the bf16 tile's (shared
    memory attributes and W's tensor map made at each launch) and the
    float32 tile's (its shared memory attribute) -> {form: us}."""
    feats, in_keys, q_keys, w = min(
        calls, key=lambda j: j[0].shape[0] * j[0].shape[1] * j[3].numel())
    f32, w32 = feats.float(), w.float()
    result = {
        "bf16": host_us(lambda: launch_bf16(lib, True, feats, in_keys,
                                            q_keys, w)),
        "float32": host_us(lambda: f32_keymatch(lib, f32, in_keys, q_keys,
                                                w32))}
    chip_smoke.log(f"host time of one launch by ctypes at "
                   f"{chip_smoke.join_shape(((feats, in_keys, q_keys, w), {}))}"
                   f" [{card}]: bf16 tile {result['bf16']:.2f} us, float32 "
                   f"tile {result['float32']:.2f} us")
    return result


def f32_keymatch(lib, feats, in_keys, q_keys, w):
    """The float32 key-match tile of ``lib`` on one join."""
    B, N, Cin = feats.shape
    K, _, Cout = w.shape
    R = q_keys.shape[-1]
    ascending = (in_keys[..., 1:] >= in_keys[..., :-1]).all()
    fn = lib.keymatch_gemm_launch
    fn.argtypes = list(sparse_gather_gemm._KEYMATCH_ARGTYPES)
    fn.restype = ctypes.c_int
    out = torch.empty((B, R, Cout), device="cuda")
    _build.check(fn(feats.data_ptr(), in_keys.data_ptr(), q_keys.data_ptr(),
                    ascending.data_ptr(), w.data_ptr(), out.data_ptr(), B, N,
                    R, K, Cin, Cout,
                    torch.cuda.current_stream().cuda_stream),
                 "keymatch_gemm_launch")
    return out


def f32_gather(lib, feats, idx, found, w):
    """The float32 rulebook tile of ``lib`` on one join."""
    B, N, Cin = feats.shape
    K, _, Cout = w.shape
    R = idx.shape[-1]
    fn = lib.gather_gemm_launch
    fn.argtypes = list(sparse_gather_gemm._GATHER_ARGTYPES)
    fn.restype = ctypes.c_int
    out = torch.empty((B, R, Cout), device="cuda")
    _build.check(fn(feats.data_ptr(), idx.data_ptr(), found.data_ptr(),
                    w.data_ptr(), out.data_ptr(), B, N, R, K, Cin, Cout,
                    torch.cuda.current_stream().cuda_stream),
                 "gather_gemm_launch")
    return out


def float32_in_turns(this, parent, calls, card: str) -> dict:
    """The float32 tiles of this build and of the parent's, in turns, at
    the largest key-match join of the served request in float32 (K4g) and
    on its rulebook (K3s, the gather join): this tile shares its lookups
    with the bf16 tile.  -> {form: {"this": [...], "parent": [...]}}."""
    feats, in_keys, q_keys, w = max(
        calls, key=lambda j: j[0].shape[0] * j[0].shape[1] * j[3].numel())
    feats, w = feats.float(), w.float()
    idx, found = sparse_gather_gemm.keymatch_rulebook(in_keys, q_keys)
    forms = {"keymatch": lambda lib: f32_keymatch(lib, feats, in_keys,
                                                  q_keys, w),
             "gather": lambda lib: f32_gather(lib, feats, idx, found, w)}
    result = {}
    for form, fn in forms.items():
        if not torch.equal(fn(this), fn(parent)):
            raise AssertionError(f"float32 {form}: this build and the "
                                 f"parent's differ")
        t = chip_smoke.take_turns({"this": lambda: fn(this),
                                   "parent": lambda: fn(parent)}, 20)
        chip_smoke.log(f"float32 {form} tile at {tuple(feats.shape)} x "
                       f"{tuple(w.shape)} [{card}], in turns: this "
                       f"{t['this']}, parent {t['parent']}")
        result[form] = t
    return result


def float32_step_equal(this, parent, tmp: Path, card: str) -> dict:
    """The float32 tiles of this build and of the parent's on every join
    of a float32 car.fhd training step at B = 6 (as ``second_step_ab.py``
    builds it: a synthetic KITTI clone, one step of ``train()``, the
    step on the first six examples of the stream), key-match and on its
    rulebook: they must give the same bits.  -> {"joins": [...], "equal":
    True}."""
    from automatic_as_built_reconstruction_tpu_torch.data import batching
    from automatic_as_built_reconstruction_tpu_torch.train import (
        train as train_mod)

    root = tmp / "car"
    chip_smoke.write_clone(root, False, "sparse_gemm_ablation", card)
    config = chip_smoke.kitti_config(chip_smoke.SECOND_TRAIN_CONFIG, tmp,
                                     root)
    calls = []
    with torch.enable_grad():
        state = train_mod.train(config, tmp / "car.fhd", max_steps=1,
                                display_step=1, device="cuda")
        prep_ds, loader = train_mod.Bundle(config).input_reader(
            training=True, seed=1)
        stream = loader._index_stream()
        example = train_mod.to_device(batching.merge_batch(
            [prep_ds.example(*next(stream)) for _ in range(6)]), "cuda")
        step_fn = train_mod.make_train_step(train_mod.Bundle(config))
        with chip_smoke.recording(middle, "keymatch_gemm", calls):
            step_fn(state, example)
    torch.cuda.synchronize()
    joins = [tuple(t.detach().contiguous() for t in c[0][:4]) for c in calls]
    if not joins or not all(j[0].dtype == torch.float32 for j in joins):
        raise AssertionError("float32 step: not the float32 joins")
    for j in joins:
        idx, found = sparse_gather_gemm.keymatch_rulebook(j[1], j[2])
        if not (torch.equal(f32_keymatch(this, *j), f32_keymatch(parent, *j))
                and torch.equal(f32_gather(this, j[0], idx, found, j[3]),
                                f32_gather(parent, j[0], idx, found, j[3]))):
            raise AssertionError(f"float32 step join "
                                 f"{chip_smoke.join_shape((j, {}))}: this "
                                 f"build and the parent's differ")
    shapes = [chip_smoke.join_shape((j, {})) for j in joins]
    chip_smoke.log(f"float32 tiles [{card}]: this build and the parent's "
                   f"give the same bits on all {len(joins)} joins of a "
                   f"car.fhd training step (B = 6), key-match and rulebook")
    return {"joins": shapes, "equal": True}


def main() -> int:
    if not torch.cuda.is_available():
        print("sparse_gemm_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--parent", type=Path)
    args = parser.parse_args()
    torch.set_grad_enabled(False)
    card = chip_smoke.toolchain()
    if args.bf16:
        return main_bf16(args.parent, card)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        rate = probe_rate(libs["probe"])
        chip_smoke.log(f"mma.sync TF32 probe [{card}]: {json.dumps(rate)}")
        pod = pod_inference_from_checkpoint(
            chip_smoke.SECOND_CONFIG, None, device="cuda",
            seed=chip_smoke.SECOND_SEED,
            max_voxels=chip_smoke.SECOND_MAX_VOXELS,
            max_points_per_voxel=chip_smoke.SECOND_MAX_POINTS)
        calls = []
        with chip_smoke.recording(middle, "keymatch_gemm", calls):
            pod(*pad_batch([make_scene(s)
                            for s in chip_smoke.SECOND_REQUESTS[0]]))
        torch.cuda.synchronize()
        joins = [tuple(t.contiguous() for t in c[0][:4]) for c in calls]
        ref = launch(libs["kernel"], *joins[-1])
        if not torch.equal(ref, sparse_gather_gemm.keymatch_gemm(
                *joins[-1])):
            raise AssertionError("the unmodified build differs from the "
                                 "port's kernel")
        times = {}
        for name, lib in libs.items():
            if name == "probe":
                continue
            # device time; CUDA events (median) where the profiler saw no
            # kernel
            ms = [chip_smoke.device_ms(lambda: launch(lib, *j))[0]
                  or chip_smoke.cuda_ms(lambda: launch(lib, *j))[0]
                  for j in joins]
            times[name] = ms
            chip_smoke.log(f"{name} ({VARIANTS[name][0]}) [{card}]: "
                           f"{sum(ms):.5f} ms summed over {len(ms)} joins; "
                           f"{[round(x, 5) for x in ms]}")
    print(json.dumps({"card": card, "joins": [
        chip_smoke.join_shape(c) for c in calls], "device_ms": times,
        "mma_sync_tf32_probe": rate}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
