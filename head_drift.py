"""Where the SECOND heads of a trained checkpoint part between the GPU and
the CPU: layer by layer, each float32 side against a float64 forward.

    python3 head_drift.py [--runs N] [--json PATH]

For each of N runs: a synthetic KITTI clone (``chip_smoke.write_clone``),
``train()`` on car.fhd.config for chip_smoke's 40 steps on the GPU (the
checkpoint differs from run to run: the loader's workers, the sampler),
then validation frames 0 and 1 through that checkpoint three times: float32
on the GPU (the kernels), float32 on the CPU (the plain versions), and
float64 on the GPU (the plain key-match join).  Every leaf module's output
is kept; for each one the script prints the largest difference of each
float32 side from float64, and of the two sides from each other, as shares
of the float64 output's max |x|, and for each BatchNorm its largest gain
|gamma| / sqrt(var + eps).  The heads are also given as shares of
chip_smoke's HEAD_TOL at their worst element.  Then each side's heads, and
those of a control (float32 on the GPU with TF32 on), are decoded by
``predict`` at chip_smoke's two score thresholds, and the script prints
how far the detections lie from the float64 forward's
(``chip_smoke.detection_distance``: counts, the largest box difference,
the share of the value a match needs beyond BOX_ATOL, the largest score
difference), and the GPU's from the CPU's.  ``--json`` writes the whole
table to PATH.  Needs one GPU; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch


def leaf_outputs(model, ex) -> tuple:
    """-> ({module name: [output as float64 on the CPU, one per call]},
    heads) of one no-grad forward under fp32_math."""
    from automatic_as_built_reconstruction_tpu_torch.device import fp32_math

    seen, hooks = {}, []
    for name, mod in model.named_modules():
        if next(mod.children(), None) is not None:
            continue

        def hook(_m, _args, out, name=name):
            if torch.is_tensor(out) and out.is_floating_point():
                seen.setdefault(name, []).append(out.detach().double().cpu())
        hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.no_grad(), fp32_math():
            preds = model.eval()(ex["voxels"], ex["num_points"],
                                 ex["coordinates"])
    finally:
        for h in hooks:
            h.remove()
    return seen, {k: v.double().cpu() for k, v in preds.items()}


def share(a, b, scale) -> float:
    return float((a - b).abs().max()) / scale if scale > 0 else 0.0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--json", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("head_drift: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from automatic_as_built_reconstruction_tpu_torch.data import batching
    from automatic_as_built_reconstruction_tpu_torch.models import middle
    from automatic_as_built_reconstruction_tpu_torch.ops import _build
    from automatic_as_built_reconstruction_tpu_torch.train import (
        checkpoint as ckpt_mod, train as train_mod)

    card = cs.toolchain()
    _build.build_all()
    runs = []
    for run in range(args.runs):
        with torch.enable_grad(), tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            root = tmp / "kitti"
            cs.write_clone(root, False, "head_drift", card)
            config = cs.kitti_config(cs.SECOND_TRAIN_CONFIG, tmp, root)
            model_dir = tmp / "second"
            train_mod.train(config, model_dir,
                            max_steps=cs.SECOND_TRAIN_STEPS,
                            display_step=cs.SECOND_DISPLAY, device="cuda")
            eb = train_mod.Bundle(config)
            vds, _ = eb.input_reader(training=False)
            val = batching.merge_batch([vds.example(i, i) for i in range(2)])
            out = {}
            for side, dev, dtype in (("cpu", "cpu", torch.float32),
                                     ("cuda", "cuda", torch.float32),
                                     ("f64", "cuda", torch.float64)):
                model = copy.deepcopy(eb.model).to(dev)
                ckpt_mod.CheckpointManager(model_dir).restore_model(model)
                model.to(dtype)
                ex = train_mod.to_device(val, dev)
                ex = {k: v.to(dtype) if v.is_floating_point() else v
                      for k, v in ex.items()}
                if dtype == torch.float64:
                    with cs.substituted(middle, "keymatch_gemm",
                                        cs.plain_keymatch):
                        out[side] = leaf_outputs(model, ex)
                else:
                    out[side] = leaf_outputs(model, ex)
                if side == "cpu":
                    bn_gain = {}
                    for name, mod in model.named_modules():
                        var = getattr(mod, "running_var", None)
                        if var is not None:
                            g = (mod.weight.abs() if mod.weight is not None
                                 else torch.ones_like(var))
                            bn_gain[name] = float(
                                (g / (var + mod.eps).sqrt()).max())
                del model
            # the control, and every side's detections
            model = copy.deepcopy(eb.model).to("cuda")
            ckpt_mod.CheckpointManager(model_dir).restore_model(model)
            ex = train_mod.to_device(val, "cuda")
            with torch.no_grad(), cs.tf32_on():
                control = {k: v.double().cpu() for k, v in model.eval()(
                    ex["voxels"], ex["num_points"],
                    ex["coordinates"]).items()}
            del model
            cfg = eb.model_cfg
            heads_by = {"cuda": out["cuda"][1], "f64": out["f64"][1],
                        "cpu": out["cpu"][1], "tf32_control": control}
            dets = {}
            for thr in cs.score_thresholds(out["f64"][1], ex["anchors"],
                                           cfg):
                d = {side: cs.decode(
                    {k: v.float() if side == "cpu" else v
                     for k, v in h.items()}, ex["anchors"], cfg, thr,
                    "cpu" if side == "cpu" else "cuda")
                    for side, h in heads_by.items()}
                dets[thr] = {
                    "boxes": int(d["f64"]["valid"].sum()),
                    "box_max_abs": float(np.abs(d["f64"]["box3d_lidar"][
                        d["f64"]["valid"]]).max(initial=0.0)),
                    **{f"{a}_vs_{b}": cs.detection_distance(
                        d[a], d[b], cfg.num_class)
                       for a, b in (("cuda", "f64"), ("cpu", "f64"),
                                    ("cuda", "cpu"),
                                    ("tf32_control", "f64"))}}
            torch.cuda.empty_cache()
        layers = []
        for name, calls in out["f64"][0].items():
            for i, truth in enumerate(calls):
                g32 = out["cuda"][0][name][i]
                c32 = out["cpu"][0][name][i]
                scale = float(truth.abs().max())
                layers.append({
                    "layer": name if len(calls) == 1 else f"{name}#{i}",
                    "shape": list(truth.shape), "max_abs": scale,
                    "cuda_vs_f64": share(g32, truth, scale),
                    "cpu_vs_f64": share(c32, truth, scale),
                    "cuda_vs_cpu": share(g32, c32, scale),
                    "bn_gain": bn_gain.get(name)})
        heads = {}
        for k, truth in out["f64"][1].items():
            g32, c32 = out["cuda"][1][k], out["cpu"][1][k]
            tol = cs.HEAD_TOL["atol"] + cs.HEAD_TOL["rtol"] * c32.abs()
            heads[k] = {
                "max_abs": float(truth.abs().max()),
                "cuda_vs_cpu_tol_share": float(((g32 - c32).abs()
                                                / tol).max()),
                "cuda_vs_f64_tol_share": float(((g32 - truth).abs()
                                                / tol).max()),
                "cpu_vs_f64_tol_share": float(((c32 - truth).abs()
                                               / tol).max()),
                "cuda_vs_f64_max": float((g32 - truth).abs().max()),
                "cpu_vs_f64_max": float((c32 - truth).abs().max())}
        for row in layers:
            cs.log(f"head_drift [{card}] run {run}: {row['layer']:40s} "
                   f"{str(row['shape']):22s} max|x| {row['max_abs']:.4g} "
                   f"cuda-f64 {row['cuda_vs_f64']:.3g} cpu-f64 "
                   f"{row['cpu_vs_f64']:.3g} cuda-cpu "
                   f"{row['cuda_vs_cpu']:.3g}"
                   + (f" bn gain {row['bn_gain']:.4g}"
                      if row["bn_gain"] is not None else ""))
        cs.log(f"head_drift [{card}] run {run}: heads {json.dumps(heads)}")
        cs.log(f"head_drift [{card}] run {run}: detections by score "
               f"threshold {json.dumps(dets)}")
        runs.append({"layers": layers, "heads": heads, "detections": dets})
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "runs": runs}))
    print(json.dumps({"card": card, "heads": [r["heads"] for r in runs],
                      "detections": [r["detections"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
