"""The device step of the SECOND training configs whose middle joins on the
sparse-join kernels, or with ``--pillars`` the pillar path's request and
step, for comparing two checkouts on one GPU in one call.

    python3 second_step_ab.py [--tree DIR] [--pillars]

``--tree`` (default: this checkout) names the checkout whose package and
``chip_smoke.py`` are imported, so that the same measurement runs on a
parent commit unpacked beside this one; run the two in turns (parent,
this, this, parent) and compare within the call.  For each of car.fhd
(float32), car.fhd with ``enable_mixed_precision``, car.fhd.mixed and
all.fhd (key-match or host rulebooks, B = 6): a synthetic KITTI clone
(``chip_smoke.write_clone``, seed 0), one step of ``train()`` for the
state, then the step on the first six examples of the training stream
(seed 1) timed with CUDA events (``chip_smoke.cuda_ms``: L2 flushed,
synchronised, median of ITERS calls), with the plan's own site caps.
``--pillars`` instead takes ``asbuilt_pillars.config`` in float32 and in
bfloat16 (``enable_mixed_precision``): the device time of chip_smoke's
first served request (the trained checkpoint; torch.profiler, the sum of
its kernels, ``chip_smoke.device_ms``) and of a training step from the
trainer's seed-0 state on its first batch (seed 1; CUDA events as above,
and the profiler's sum), each with K1's share (``pillar_*`` kernels).
Prints one JSON line.  Needs one GPU; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ITERS = 10      # timed steps a config


def pillar_cells(cs, card: str, tree: str) -> dict:
    """{cell: {"request_device_ms", "request_k1_ms", "step_ms",
    "step_device_ms", "step_k1_ms"}} of the pillar path, float32 and
    bfloat16."""
    import torch

    from automatic_as_built_reconstruction_tpu_torch.data.building import (
        generate_building_scene, pad_batch)
    from automatic_as_built_reconstruction_tpu_torch.parallel import (
        pod_inference_from_checkpoint)
    from automatic_as_built_reconstruction_tpu_torch.train import (
        train as train_mod)

    def k1(per_kernel: dict) -> float:
        return sum(v for k, v in per_kernel.items() if "pillar_" in k)

    cells = {}
    request = pad_batch([generate_building_scene(s)
                         for s in cs.REQUESTS[0]])
    with tempfile.TemporaryDirectory() as tmp:
        for name, config in (("pillars", cs.CONFIG),
                             ("bf16 pillars", cs.with_mixed_precision(
                                 cs.CONFIG, Path(tmp)))):
            pod = pod_inference_from_checkpoint(
                config, cs.CHECKPOINT, device="cuda",
                max_voxels=cs.MAX_VOXELS,
                max_points_per_voxel=cs.MAX_POINTS)
            with torch.no_grad():
                req_ms, req_per = cs.device_ms(lambda: pod(*request))
            bundle = train_mod.Bundle(config)
            state = train_mod.init_state(bundle, rng_seed=0, total_steps=100,
                                         device="cuda")
            _, loader = bundle.input_reader(training=True, seed=1)
            example = train_mod.to_device(next(iter(loader)), "cuda")
            step_fn = train_mod.make_train_step(bundle)
            with torch.enable_grad():
                ev = cs.cuda_ms(lambda: step_fn(state, example), iters=ITERS,
                                warmup=2)
                step_ms, step_per = cs.device_ms(
                    lambda: step_fn(state, example))
            cells[name] = {"request_device_ms": req_ms,
                           "request_k1_ms": k1(req_per), "step_ms": ev,
                           "step_device_ms": step_ms,
                           "step_k1_ms": k1(step_per)}
            cs.log(f"second_step_ab [{card}] {tree}: {name}: "
                   f"{json.dumps(cells[name])}")
            del pod, state, example, step_fn
            torch.cuda.empty_cache()
    return cells


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", type=Path,
                        default=Path(__file__).resolve().parent)
    parser.add_argument("--pillars", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("second_step_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from automatic_as_built_reconstruction_tpu_torch.data import batching
    from automatic_as_built_reconstruction_tpu_torch.ops import _build
    from automatic_as_built_reconstruction_tpu_torch.train import (
        train as train_mod)

    card = cs.toolchain()
    _build.build_all()
    if args.pillars:
        torch.set_grad_enabled(False)
        print(json.dumps({"tree": str(args.tree), "card": card,
                          "pillars": pillar_cells(cs, card,
                                                  args.tree.name)}))
        return 0
    steps = {}
    with torch.enable_grad(), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        roots = {False: tmp / "car", True: tmp / "multiclass"}
        for multiclass, root in roots.items():
            cs.write_clone(root, multiclass, "second_step_ab", card)
        car = cs.kitti_config(cs.SECOND_TRAIN_CONFIG, tmp, roots[False])
        bf16_dir = tmp / "bf16"             # its copy is named as
        bf16_dir.mkdir()                    # car.fhd.mixed's
        configs = {
            "car.fhd": car,
            "bf16 car.fhd": cs.with_mixed_precision(car, bf16_dir),
            "car.fhd.mixed": cs.kitti_config(cs.MIXED_CONFIG, tmp,
                                             roots[False]),
            "all.fhd": cs.kitti_config(cs.ALL_FHD_CONFIG, tmp, roots[True])}
        for name, config in configs.items():
            # the plan's own site caps, as chip_smoke.py's phases hold
            # them on this clone (CapacitySaturationError fails the run)
            state = train_mod.train(config, tmp / name.replace(" ", "_"),
                                    max_steps=1, display_step=1,
                                    device="cuda")
            prep_ds, loader = train_mod.Bundle(config).input_reader(
                training=True, seed=1)
            stream = loader._index_stream()
            example = train_mod.to_device(batching.merge_batch(
                [prep_ds.example(*next(stream)) for _ in range(6)]), "cuda")
            step_fn = train_mod.make_train_step(train_mod.Bundle(config))
            steps[name] = cs.cuda_ms(lambda: step_fn(state, example),
                                     iters=ITERS, warmup=2)
            cs.log(f"second_step_ab [{card}] {args.tree.name}: {name} "
                   f"device step {cs.fmt_range(steps[name])}")
            del state, example, step_fn
            torch.cuda.empty_cache()
    print(json.dumps({"tree": str(args.tree), "card": card,
                      "device_step_ms": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
