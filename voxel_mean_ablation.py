"""Design alternatives of the fused voxelize+mean's key route (K5), on one
NVIDIA GPU.

    python3 voxel_mean_ablation.py

1. builds ``csrc/voxel_mean.cu`` as it is and variants of it that each
   replace one design choice of the segment-and-mean kernel with the
   alternative it was measured against, or leave out one part of its work
   (text substitutions of the source, each of which must apply exactly
   once, so that they follow it); prints the registers, stack and shared
   memory of each;
2. makes the two served shapes: the first SECOND request of
   ``chip_smoke.py`` (B = 2 scans of 18 000 points, V = 17 000, T = 5) and
   its first pillar request as a pillar-sized scan (B = 2, up to 89 297
   points, V = 25 600, T = 24), each with its config's geometry;
3. runs every variant's key kernel and segment kernel as the port's
   ``fused_voxelize_mean`` runs them (the key kernel fills the outputs
   and zeroes the scan words, then the segment kernel on the sorted
   keys), checks the design alternatives' outputs against the port's
   function bit for bit, and times each kernel (device time,
   torch.profiler, L2 flushed before each call); prints one JSON line.

The variants are timing probes, built into a directory of their own, and
no part of the port calls them; those that leave out work compute wrong
results on purpose.
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
from automatic_as_built_reconstruction_tpu_torch.ops import _build, voxel_mean
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    build_from_config)

SOURCE = _build.CSRC_DIR / "voxel_mean.cu"
_TILE = "#define SEGMENT_TILE 512"
_BOUNDS = "__launch_bounds__(SEGMENT_TILE)"
_STEP = "#define RUN_STEP 4"
_ROWS = "const bool rows = vec4;"
_FIRST = "int first = tid < tile ? state[tid] : 1;"
# the two-launch scan: launch 0 publishes each tile's count and stops,
# launch 1 finds them all there; each block's tile is its block index
_TWO_PASS = [
    ("int n_tiles, int vec4) {", "int n_tiles, int vec4, int mode) {"),
    ("if (tid == 0) s_tile = atomicAdd(words + n_tiles, 1);",
     "if (tid == 0) s_tile = blockIdx.x;"),
    (_ROWS, "const bool rows = vec4 && mode == 1;"),
    (_FIRST, "if (mode == 0) return;\n  " + _FIRST),
    ("P, C, V, T, gx, gz, n_tiles, vec4);",
     "P, C, V, T, gx, gz, n_tiles, vec4, 0);\n"
     "  segment_mean_kernel<<<grid, SEGMENT_TILE, 0, stream>>>(\n"
     "      points, packed, features, coords, num_points, num_voxels, "
     "tile_state,\n      P, C, V, T, gx, gz, n_tiles, vec4, 1);")]
# name -> (what the variant changes, tile, [(old, new), ...])
VARIANTS = {
    "kernel": ("nothing", 512, []),
    "two_pass": ("counts each tile's cells in a launch of its own first",
                 512, _TWO_PASS),
    "no_halo": ("holds no positions past its tile: a run that crosses the "
                "tile's end reads the rest from device memory, one at a "
                "time", 512,
                [("#define SEGMENT_HALO 32", "#define SEGMENT_HALO 0")]),
    "tile_256": ("256 positions a block", 256,
                 [(_TILE, "#define SEGMENT_TILE 256")]),
    "tile_1024": ("1024 positions a block", 1024,
                  [(_TILE, "#define SEGMENT_TILE 1024")]),
    "run_step_1": ("reads a run one position at a time", 512,
                   [(_STEP, "#define RUN_STEP 1")]),
    "run_step_8": ("reads a run eight positions at a time", 512,
                   [(_STEP, "#define RUN_STEP 8")]),
    "min_blocks_2": ("registers capped so that 2 blocks fit an SM", 512,
                     [(_BOUNDS, "__launch_bounds__(SEGMENT_TILE, 2)")]),
    "min_blocks_3": ("registers capped so that 3 blocks fit an SM", 512,
                     [(_BOUNDS, "__launch_bounds__(SEGMENT_TILE, 3)")]),
    "min_blocks_4": ("registers capped so that 4 blocks fit an SM", 512,
                     [(_BOUNDS, "__launch_bounds__(SEGMENT_TILE, 4)")]),
    # timing probes that leave out one part of the work (wrong results)
    "no_rows": ("loads no point rows (sums zeros)", 512, [
        (_ROWS, "const bool rows = false;")]),
    "no_sums": ("adds only a head's own row, not its run's", 512, [
        ("const int take = (int)min((long long)T, P - i);",
         "const int take = 1;")]),
    "no_wait": ("reads no other tile's count (slots from this tile's "
                "heads only)", 512, [
        (_FIRST, "int first = 1;"),
        ("t < tile; t += SEGMENT_TILE)", "t < 0; t += SEGMENT_TILE)")]),
}
# the probes above compute other results; every other variant the port's
PROBES = ("no_rows", "no_sums", "no_wait")


def variant_sources() -> dict:
    """{name: CUDA source} of every variant; raises where a substitution
    does not occur exactly once in ``SOURCE``."""
    text = SOURCE.read_text()
    sources = {}
    for name, (*_, subs) in VARIANTS.items():
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
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        lines = log.splitlines()
        at = next(k for k, x in enumerate(lines)
                  if "Compiling entry" in x and "segment_mean" in x)
        ptxas = [x.split(":", 1)[-1].strip() for x in lines[at + 1:at + 4]
                 if "stack frame" in x or "registers" in x]
        chip_smoke.log(f"ptxas {name} segment_mean_kernel: "
                       f"{'; '.join(ptxas)}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def key_route(lib, tile: int, pts, nv, srt, kw):
    """The variant's key kernel (filling the outputs, zeroing the scan
    words) and segment kernel on the sorted keys ``srt``, as
    ``fused_voxelize_mean`` calls them.  -> FusedVoxelMeanResult."""
    keys = lib.point_keys_launch
    keys.argtypes = list(voxel_mean._KEYS_ARGTYPES)
    seg = lib.segment_mean_launch
    seg.argtypes = list(voxel_mean._SEGMENT_ARGTYPES)
    keys.restype = seg.restype = ctypes.c_int
    B, P, C = pts.shape
    V, T = kw["max_voxels"], kw["max_points"]
    gx, gy, gz = (int(g) for g in kw["grid_size"])
    geometry = [float(v) for v in (*kw["voxel_size"], *kw["pc_range"][:3])]
    out = voxel_mean._empty_outputs(B, V, C, pts.device)
    n_tiles = -(-P // tile)
    state = torch.empty((B, n_tiles + 1), dtype=torch.int32,
                        device=pts.device)
    packed = torch.empty((B, P), dtype=torch.int64, device=pts.device)
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(keys(pts.data_ptr(), nv.data_ptr(), packed.data_ptr(), B, P,
                      C, *geometry, gx, gy, gz,
                      *(t.data_ptr() for t in out), V, state.data_ptr(),
                      n_tiles + 1, 1, stream), "point_keys_launch")
    _build.check(seg(pts.data_ptr(), srt.data_ptr(),
                     *(t.data_ptr() for t in out), state.data_ptr(), n_tiles,
                     B, P, C, V, T, gx, gz, stream),
                 "segment_mean_launch")
    return out


def shapes() -> dict:
    """{what: (points, num_valid, kwargs)} of the two served shapes."""
    result = {}
    for what, config, scans, caps in (
            ("served SECOND request", chip_smoke.SECOND_CONFIG,
             [make_scene(s) for s in chip_smoke.SECOND_REQUESTS[0]],
             (chip_smoke.SECOND_MAX_VOXELS, chip_smoke.SECOND_MAX_POINTS)),
            ("pillar-sized scan", chip_smoke.CONFIG,
             [generate_building_scene(s) for s in chip_smoke.REQUESTS[0]],
             (chip_smoke.MAX_VOXELS, chip_smoke.MAX_POINTS))):
        _, cfg, _ = build_from_config(config)
        pts, nv = pad_batch(scans)
        result[what] = (torch.as_tensor(pts, device="cuda"),
                        torch.as_tensor(nv, device="cuda"),
                        dict(voxel_size=cfg.voxel_size,
                             pc_range=cfg.pc_range, grid_size=cfg.grid_size,
                             max_voxels=caps[0], max_points=caps[1]))
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("voxel_mean_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    card = chip_smoke.toolchain()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        inputs = shapes()
        for what, (pts, nv, kw) in inputs.items():
            geo = {k: kw[k] for k in ("voxel_size", "pc_range", "grid_size")}
            ref = voxel_mean.fused_voxelize_mean(pts, nv,
                                                 first_appearance=False, **kw)
            srt = torch.sort(voxel_mean.point_keys(pts, nv, **geo),
                             dim=1).values
            for name, (change, tile, _) in VARIANTS.items():
                lib = libs[name]
                got = key_route(lib, tile, pts, nv, srt, kw)
                torch.cuda.synchronize()
                if name not in PROBES and not all(
                        torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{what}: variant {name} differs "
                                         f"from the port's function")
                _, per, _ = chip_smoke.device_profile(
                    lambda: key_route(lib, tile, pts, nv, srt, kw))
                ms = {kernel: sum(v for k, v in per.items()
                                  if k.startswith(kernel))
                      for kernel in ("point_keys_kernel",
                                     "segment_mean_kernel")}
                times.setdefault(name, {})[what] = ms
                chip_smoke.log(f"{name} ({change}) [{card}]: {what} "
                               f"B={pts.shape[0]} P={pts.shape[1]} "
                               f"V={kw['max_voxels']} T={kw['max_points']}: "
                               f"device ms {json.dumps(ms)}")
    print(json.dumps({"card": card, "inputs": {
        what: list(pts.shape) for what, (pts, _, _) in inputs.items()},
        "device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
