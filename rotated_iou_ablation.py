"""Where the time of the rotated-IoU kernel (K2) goes, on one NVIDIA GPU.

    python3 rotated_iou_ablation.py

1. builds ``csrc/rotated_iou.cu`` as it is and variants of it that each
   leave out one part of the work or replace one design choice with the
   alternative it was measured against (text substitutions of the source,
   each of which must apply exactly once, so that they follow it); prints
   the registers, stack and local-memory instructions of each;
2. serves one request of the as-built pillar detector and one of SECOND
   (``chip_smoke.py``'s configs, checkpoint, seeded state and first
   requests) to record the boxes their NMS gives the kernel;
3. times every variant on those inputs and on ``chip_smoke.py``'s
   degenerate and near-touching sets (R = 6, N = K = 1000; device time,
   torch.profiler, L2 flushed before each call) and prints one JSON line.

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
    generate_building_scene, pad_batch)
from automatic_as_built_reconstruction_tpu_torch.data.kitti_like import (
    make_scene)
from automatic_as_built_reconstruction_tpu_torch.ops import (
    _build, nms, rotated_iou)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    pod_inference_from_checkpoint)

SOURCE = _build.CSRC_DIR / "rotated_iou.cu"
# the first line of each stage's test, and a line before it that makes the
# stage reject nothing (a NaN margin falls through to the test, which then
# rejects nothing either)
_CIRCLES = "  const float reach = (ar + br) + m;\n"
_AXES = "  const float cab = ac * bc + as * bs;"
_NEVER = "  if (m == m) return false;\n"
# name -> (what the variant changes, [(old, new), ...]).  The first group
# leaves out one part of the work; the second replaces one design choice
# with the alternative that was measured against it.
VARIANTS = {
    "kernel": ("nothing", []),
    "stores_only": ("leaves out the tests and the clip (prologue, zeros, "
                    "stores)", [
        ("    if (n0 + row >= N) break;", "    if (true) break;")]),
    "no_clip": ("leaves out the clip of the queued pairs", [
        ("    const float inter = clip_area(",
         "    const float inter = 0.f * ax[0] + 0.f * bx4[0] + 0.f * (")]),
    "no_reject": ("rejects no pair: every pair is clipped", [
        (_CIRCLES, _NEVER + _CIRCLES), (_AXES, _NEVER + _AXES)]),
    "circles_only": ("leaves out the separating axes", [
        (_AXES, _NEVER + _AXES)]),
    "axes_only": ("leaves out the bounding circles: every pair goes to the "
                  "second stage", [(_CIRCLES, _NEVER + _CIRCLES)]),
    "scalar_stores": ("stores the tile one float a thread", [
        ("  if (K % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0)",
         "  if (false)")]),
    "tile_32x128": ("32 A rows a block", [
        ("constexpr int kTileN = 16;", "constexpr int kTileN = 32;")]),
    "tile_64x128": ("64 A rows a block", [
        ("constexpr int kTileN = 16;", "constexpr int kTileN = 64;")]),
    "tile_16x64": ("64 B columns a block", [
        ("constexpr int kTileK = 128;", "constexpr int kTileK = 64;")]),
    "tile_32x64": ("32 A rows x 64 B columns a block", [
        ("constexpr int kTileN = 16;", "constexpr int kTileN = 32;"),
        ("constexpr int kTileK = 128;", "constexpr int kTileK = 64;")]),
    "tile_8x128": ("8 A rows a block", [
        ("constexpr int kTileN = 16;", "constexpr int kTileN = 8;")]),
    "threads_128": ("128 threads a block", [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]),
    "threads_512": ("512 threads a block (2 blocks an SM by shared memory)", [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")]),
}
# the design alternatives: the kernel's results, bit for bit
SAME_RESULT = ("scalar_stores", "tile_32x128", "tile_64x128", "tile_16x64",
               "tile_32x64", "tile_8x128", "threads_128", "threads_512")


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
    """{name: ctypes library}: every variant, one nvcc each, all started
    together."""
    procs = {}
    for name, src in variant_sources().items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        ptxas = [x.split(":", 1)[-1].strip() for x in log.splitlines()
                 if "registers" in x or "stack frame" in x]
        sass = chip_smoke.run([str(cuobjdump), "-sass", str(so)])
        local = {op: sum(f" {op}" in x for x in sass.splitlines())
                 for op in ("LDL", "STL")}
        chip_smoke.log(f"ptxas {name}: {'; '.join(ptxas)}; SASS local "
                       f"memory instructions {local}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def launch(lib, a, q):
    fn = lib.rotated_iou_launch
    fn.argtypes = list(rotated_iou._ARGTYPES)
    fn.restype = ctypes.c_int
    R, N, K = a.shape[0], a.shape[1], q.shape[1]
    out = torch.empty((R, N, K), device="cuda")
    err = fn(a.data_ptr(), q.data_ptr(), out.data_ptr(), R, N, K, -1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rotated_iou_launch: cudaError {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("rotated_iou_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    card = chip_smoke.toolchain()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        pod = pod_inference_from_checkpoint(
            chip_smoke.CONFIG, chip_smoke.CHECKPOINT, device="cuda",
            max_voxels=chip_smoke.MAX_VOXELS,
            max_points_per_voxel=chip_smoke.MAX_POINTS)
        second = pod_inference_from_checkpoint(
            chip_smoke.SECOND_CONFIG, None, device="cuda",
            seed=chip_smoke.SECOND_SEED,
            max_voxels=chip_smoke.SECOND_MAX_VOXELS,
            max_points_per_voxel=chip_smoke.SECOND_MAX_POINTS)
        calls = []
        with chip_smoke.recording(nms, "rotate_iou_matrix", calls):
            pod(*pad_batch([generate_building_scene(s)
                            for s in chip_smoke.REQUESTS[0]]))
            second(*pad_batch([make_scene(s)
                               for s in chip_smoke.SECOND_REQUESTS[0]]))
        torch.cuda.synchronize()
        inputs = {"pillar serving": calls[0][0],
                  "second key-match": calls[1][0]}
        for what, cases in (("degenerate set", chip_smoke.iou_cases),
                            ("near-touching set",
                             chip_smoke.near_touching_cases)):
            b = torch.as_tensor(cases(6, 1000), device="cuda")
            inputs[what] = (b, b)
        for what, (a, q) in inputs.items():
            ref = rotated_iou.rotate_iou_matrix(a, q)
            for name in ("kernel",) + SAME_RESULT:
                if not torch.equal(launch(libs[name], a, q), ref):
                    raise AssertionError(f"{what}: variant {name} differs "
                                         f"from the port's kernel")
        times = {}
        for name, lib in libs.items():
            times[name] = {
                what: chip_smoke.device_ms(lambda: launch(lib, a, q))[0]
                for what, (a, q) in inputs.items()}
            chip_smoke.log(f"{name} ({VARIANTS[name][0]}) [{card}]: device "
                           f"ms {json.dumps(times[name])}")
    print(json.dumps({"card": card, "inputs": {
        what: [list(a.shape), list(q.shape)]
        for what, (a, q) in inputs.items()}, "device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
