"""Whether two float32 ``train()`` runs on the card give the same
parameters, and which setting makes them do so, at what cost.

    python3 train_determinism.py [--json PATH]

For ``asbuilt_pillars.config`` (STEPS steps of ``train()`` from seed 0,
each run into a fresh model directory; its loader gives the same batches
run after run) and for one step of ``car.fhd.config`` at B = 6 on a
synthetic KITTI clone (``chip_smoke.write_clone``; the trainer's seed-0
state and the first batch of the training stream, seed 1, fetched once:
the gt-database sampler's batches depend on the loader's worker order),
each run in each of these settings:

1. ``default``: twice with cuDNN's own choice of algorithms, as the
   port trained before its training step asked for the deterministic
   ones; the floating elements of the two final ``state_dict``s that
   differ, the largest difference, and the losses;
2. ``strict``: once under ``torch.use_deterministic_algorithms(True)``
   (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before torch starts): the
   first op with no deterministic form raises, and its message names it;
3. ``warn``: twice under ``use_deterministic_algorithms(True,
   warn_only=True)``: every op that warns, and the two runs' distance;
4. ``cudnn``: twice with ``torch.backends.cudnn.deterministic = True``
   (``benchmark`` off; what the training step now asks for through
   ``device.fp32_math(deterministic=True)``): the two runs' distance.

Then the device ms of one training step of each config on that batch and
of the pillar path's first served request (``chip_smoke.CHECKPOINT``),
CUDA events (``chip_smoke.cuda_ms``: L2 flushed, median of ITERS calls),
in turns over TURNS rounds after WARMUP calls of each: ``default``,
``cudnn``, ``warn`` (the order reversed every round); a setting's cost
is the median over the rounds of its time over ``default``'s of the same
round, less 1.  Last, the device busy ms of the same three calls
(torch.profiler, ``chip_smoke.device_ms``: the card's own time without
the host's launch gaps, which the events of a host-bound pillar step
include) in ``default`` and ``cudnn``, in turns over BUSY_TURNS rounds.

Prints one JSON line (and writes it to ``--json``).  Needs one GPU;
exits non-zero without one.
"""
from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse                                      # noqa: E402
import contextlib                                    # noqa: E402
import json                                          # noqa: E402
import sys                                           # noqa: E402
import tempfile                                      # noqa: E402
import warnings                                      # noqa: E402
from pathlib import Path                             # noqa: E402

STEPS = 3           # train() steps of the pillar runs
ITERS = 8           # timed calls a turn
TURNS = 8           # rounds of the three settings
WARMUP = 10         # calls of each setting before the first round
BUSY_TURNS = 4      # rounds of the profiled device busy time
BUSY_ITERS = 10     # profiled calls a window (three windows a reading)


@contextlib.contextmanager
def setting(name: str):
    """``default`` (cuDNN's own choice of algorithms in the training step
    too: ``train.fp32_math`` stripped of ``deterministic``, as the port
    trained before it asked for them), ``cudnn`` (cuDNN's deterministic
    algorithms everywhere, serving included), ``strict`` / ``warn``
    (``use_deterministic_algorithms`` on top of ``default``)."""
    import torch

    from automatic_as_built_reconstruction_tpu_torch import device
    from automatic_as_built_reconstruction_tpu_torch.train import (
        train as train_mod)

    cudnn = torch.backends.cudnn
    old = (cudnn.deterministic, cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           train_mod.fp32_math)
    if name == "cudnn":
        cudnn.deterministic, cudnn.benchmark = True, False
    else:
        train_mod.fp32_math = lambda deterministic=False: device.fp32_math()
    if name in ("strict", "warn"):
        torch.use_deterministic_algorithms(True, warn_only=name == "warn")
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = old[0], old[1]
        torch.use_deterministic_algorithms(old[2], warn_only=old[3])
        train_mod.fp32_math = old[4]


def distance(a: dict, b: dict) -> dict:
    """Floating elements of two state dicts that differ, and the largest
    difference."""
    import torch

    n = total = 0
    worst = 0.0
    for k, w in a.items():
        if w.is_floating_point():
            d = (b[k] - w).abs()
            n += int((d > 0).sum())
            total += w.numel()
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
        elif not torch.equal(b[k], w):
            n += 1
    return {"differ": n, "of": total, "max_abs": worst}


def one_run(cs, train_mod, config, tmp: Path, name: str, steps: int):
    """-> (state_dict on the CPU, losses, warnings)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = train_mod.train(config, tmp / name, max_steps=steps,
                                display_step=1, device="cuda", resume=False)
    sd = {k: v.detach().cpu().clone()
          for k, v in state.model.state_dict().items()}
    return sd, cs.train_losses(tmp / name), sorted(
        {str(w.message).split("\n")[0] for w in caught
         if "deterministic" in str(w.message)})


def compare(run, what: str, card: str, cs) -> dict:
    """``run(name) -> (state_dict, losses, warnings)`` in each setting."""
    out = {}
    for mode in ("default", "cudnn", "warn"):
        with setting(mode):
            a, la, wa = run(f"{mode}_a")
            b, lb, wb = run(f"{mode}_b")
        out[mode] = {"distance": distance(a, b), "losses": [la, lb],
                     "warnings": sorted(set(wa) | set(wb))}
        cs.log(f"train_determinism [{card}] {what} {mode}: "
               f"{json.dumps(out[mode])}")
    try:
        with setting("strict"):
            run("strict")
        out["strict"] = {"raised": None}
    except RuntimeError as e:
        out["strict"] = {"raised": str(e).split("\n")[0]}
    cs.log(f"train_determinism [{card}] {what} strict: "
           f"{json.dumps(out['strict'])}")
    return out


def first_example(train_mod, bundle):
    """The first batch of the training stream (seed 1), on the card."""
    _, loader = bundle.input_reader(training=True, seed=1)
    batches = iter(loader)
    example = train_mod.to_device(next(batches), "cuda")
    batches.close()
    return example


def one_step(train_mod, config, example):
    """-> a run of one step from the trainer's seed-0 state on
    ``example``."""
    def run(name):
        import torch

        bundle = train_mod.Bundle(config)
        state = train_mod.init_state(bundle, rng_seed=0, total_steps=1000,
                                     device="cuda")
        step_fn = train_mod.make_train_step(bundle)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            metrics = step_fn(state, example)
            torch.cuda.synchronize()
        sd = {k: v.detach().cpu().clone()
              for k, v in state.model.state_dict().items()}
        return sd, [float(metrics["loss"])], sorted(
            {str(w.message).split("\n")[0] for w in caught
             if "deterministic" in str(w.message)})
    return run


def in_turns(cs, fns: dict, card: str, what: str) -> dict:
    """Device ms of ``fns[setting]()`` in each setting, in turns."""
    import torch

    order = ["default", "cudnn", "warn"]
    times = {m: [] for m in order}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for mode in order:
            with setting(mode):
                for _ in range(WARMUP):
                    fns[mode]()
        torch.cuda.synchronize()
        for turn in range(TURNS):
            for mode in (order if turn % 2 == 0 else order[::-1]):
                with setting(mode):
                    times[mode].append(cs.cuda_ms(fns[mode], iters=ITERS,
                                                  warmup=1)[0])
    out = {}
    for m, t in times.items():
        ratios = sorted(a / b for a, b in zip(t, times["default"]))
        out[m] = {"median_ms": float(sorted(t)[len(t) // 2]),
                  "turns_ms": t,
                  "cost": ratios[len(ratios) // 2] - 1.0}
    cs.log(f"train_determinism [{card}] {what} ms in turns: "
           f"{json.dumps(out)}")
    return out


def busy_in_turns(cs, fn, card: str, what: str) -> dict:
    """Device busy ms of ``fn()`` (torch.profiler: the sum of the
    kernels, memsets and copies a call launches, L2 flushed before each;
    ``chip_smoke.device_ms``) in the ``default`` and ``cudnn`` settings,
    in turns over BUSY_TURNS rounds."""
    order = ["default", "cudnn"]
    times = {m: [] for m in order}
    for turn in range(BUSY_TURNS):
        for mode in (order if turn % 2 == 0 else order[::-1]):
            with setting(mode):
                times[mode].append(cs.device_ms(fn, iters=BUSY_ITERS)[0])
    ratios = sorted(a / b for a, b in zip(times["cudnn"], times["default"]))
    out = {"busy_ms": times, "cost": ratios[len(ratios) // 2] - 1.0}
    cs.log(f"train_determinism [{card}] {what} device busy ms in turns: "
           f"{json.dumps(out)}")
    return out


def step_times(cs, train_mod, config, example, card: str,
               what: str) -> tuple:
    """Device ms of a training step in each setting, in turns.  -> (the
    times, the step as a function of no arguments)."""
    import torch

    bundle = train_mod.Bundle(config)
    state = train_mod.init_state(bundle, rng_seed=0, total_steps=100000,
                                 device="cuda")
    step_fn = train_mod.make_train_step(bundle)

    def step():
        with torch.enable_grad():
            return step_fn(state, example)

    return in_turns(cs, {m: step for m in ("default", "cudnn", "warn")},
                    card, f"{what} step"), step


def request_times(cs, card: str) -> tuple:
    """Device ms of the pillar path's first served request in each
    setting, in turns.  -> (the times, the request as a function of no
    arguments)."""
    import torch

    from automatic_as_built_reconstruction_tpu_torch.data.building import (
        generate_building_scene, pad_batch)
    from automatic_as_built_reconstruction_tpu_torch.parallel import (
        pod_inference_from_checkpoint)

    pod = pod_inference_from_checkpoint(
        cs.CONFIG, cs.CHECKPOINT, device="cuda", max_voxels=cs.MAX_VOXELS,
        max_points_per_voxel=cs.MAX_POINTS)
    request = pad_batch([generate_building_scene(s)
                         for s in cs.REQUESTS[0]])
    def serve():
        with torch.no_grad():
            return pod(*request)

    return in_turns(cs, {m: serve for m in ("default", "cudnn", "warn")},
                    card, "asbuilt_pillars request"), serve


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    if not torch.cuda.is_available():
        print("train_determinism: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from automatic_as_built_reconstruction_tpu_torch.train import (
        train as train_mod)

    card = cs.toolchain()
    cs.build_kernels()          # and the L2 flush the profiler times take
    result = {"card": card,
              "cublas_workspace_config": os.environ["CUBLAS_WORKSPACE_CONFIG"]}
    with torch.enable_grad(), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pillar_dir = tmp / "pillars"
        result["pillars"] = compare(
            lambda name: one_run(cs, train_mod, cs.CONFIG, pillar_dir, name,
                                 STEPS), "asbuilt_pillars", card, cs)
        busy = {}
        result["pillars"]["step"], busy["asbuilt_pillars step"] = step_times(
            cs, train_mod, cs.CONFIG,
            first_example(train_mod, train_mod.Bundle(cs.CONFIG)), card,
            "asbuilt_pillars")
        (result["pillars"]["request"],
         busy["asbuilt_pillars request"]) = request_times(cs, card)
        root = tmp / "car"
        cs.write_clone(root, False, "train_determinism", card)
        car = cs.kitti_config(cs.SECOND_TRAIN_CONFIG, tmp, root)
        example = first_example(train_mod, train_mod.Bundle(car))
        result["car.fhd"] = compare(one_step(train_mod, car, example),
                                    "car.fhd", card, cs)
        result["car.fhd"]["step"], busy["car.fhd step"] = step_times(
            cs, train_mod, car, example, card, "car.fhd")
        # the profiler last: a profiled call can leave later event times
        # wrong (chip_smoke.py keeps its profiles at the end too)
        result["busy"] = {what: busy_in_turns(cs, fn, card, what)
                          for what, fn in busy.items()}
    line = json.dumps(result)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
