"""Where the time of the sparse-GEMM kernel goes, on one NVIDIA GPU.

    python3 sparse_gemm_ablation.py

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

The variants compute wrong results on purpose: they are timing probes,
built into a directory of their own, and no part of the port calls them.
Needs one GPU; exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
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


def variant_sources() -> dict:
    """{name: CUDA source} of every variant; raises where a substitution
    does not occur exactly once in ``SOURCE``."""
    text = SOURCE.read_text()
    sources = {}
    for name, (_, subs) in VARIANTS.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} occurs "
                                   f"{src.count(old)} times in the source")
            src = src.replace(old, new)
        sources[name] = src
    return sources


def build(out_dir: Path) -> dict:
    """{name: ctypes library}: every variant and the probe, one nvcc each,
    all started together."""
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
            if "Compiling entry" in line and "keymatch_gemm_kernelILi64" in line:
                regs = next(x for x in lines[i:] if "registers" in x)
                chip_smoke.log(f"ptxas {name}: keymatch_gemm_kernel<64>: "
                               f"{regs.split(':', 1)[1].strip()}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("sparse_gemm_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    card = chip_smoke.toolchain()
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
