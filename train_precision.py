"""Precision of the pillar training step's float32 arithmetic, on one
NVIDIA GPU and the host CPU.

    python3 train_precision.py

On one training batch of ``asbuilt_pillars.config`` at full width (the
training reader, seed 3) and the seeded weights ``train()`` starts from:

1. the PFN's BatchNorm input (1 228 800 rows of 64 channels, most of
   them padding) normalised with batch statistics by PyTorch's fused
   kernel (``torch.native_batch_norm``) and by the port's training
   BatchNorm (``models/pointpillars.py::_FlaxBatchNorm``, two-pass
   statistics), on the card and on the CPU, each against a float64
   reference: the largest error of the output, and of the fused
   kernel's batch variance;
2. the gradients of one training step in float32 on the card and on the
   CPU and in float64 on both (the plain scatter: the kernel is
   float32): each float32 gradient's largest error against the float64
   step as a share of the tensor's max |g| (the five worst tensors), and
   the float64 steps' largest relative difference.

Prints one JSON line.  Needs one GPU; exits non-zero without one.
"""
from __future__ import annotations

import json
import sys

import torch

import chip_smoke
from automatic_as_built_reconstruction_tpu_torch.train import train


def batchnorm_errors(x: torch.Tensor) -> dict:
    """Largest output and variance errors of the fused kernel and of the
    port's BatchNorm, on the card and the CPU, against float64."""
    x64 = x.double().cpu()
    var64, mean64 = torch.var_mean(x64, 0, correction=0)
    ref = (x64 - mean64) / torch.sqrt(var64 + 1e-3)
    out = {}
    for dev in ("cuda", "cpu"):
        xd = x.to(dev)
        fused, _, invstd = torch.native_batch_norm(xd, None, None, None, None,
                                                   True, 0.0, 1e-3)
        bn = chip_smoke.pointpillars.FlaxBatchNorm1d(
            x.shape[1], eps=1e-3, momentum=0.01).to(dev).train()
        with torch.no_grad():
            port = bn(xd)
        var = invstd.double().cpu() ** -2 - 1e-3
        out[dev] = {
            "fused_out_err": float((fused.double().cpu() - ref).abs().max()),
            "fused_var_rel_err": float(((var - var64) / var64).abs().max()),
            "port_out_err": float((port.double().cpu() - ref).abs().max())}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("train_precision: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_grad_enabled(True)
    bundle = train.Bundle(chip_smoke.CONFIG)
    _, loader = bundle.input_reader(training=True, seed=3)
    batch = next(iter(loader))
    state = train.init_state(bundle, rng_seed=0, device="cuda")
    example = train.to_device(batch, "cuda")
    seen = {}
    norm = state.model.voxel_feature_extractor.pfn_layers[0].norm
    hook = norm.register_forward_hook(
        lambda mod, args, out: seen.setdefault("x", args[0].detach()))
    with torch.no_grad():
        state.model(example["voxels"], example["num_points"],
                    example["coordinates"])
    hook.remove()
    result = {"pfn_batchnorm": batchnorm_errors(seen["x"]),
              "rows": int(seen["x"].shape[0]),
              "zero_share": float((seen["x"] == 0).float().mean())}
    steps = {}
    plain = chip_smoke.pillar_scatter.scatter_sorted_to_canvas_plain
    for dev in ("cuda", "cpu"):
        steps[dev] = chip_smoke.device_step(chip_smoke.CONFIG, batch, dev,
                                            60)["grads"]
        with chip_smoke.substituted(chip_smoke.pointpillars,
                                    "scatter_sorted_to_canvas", plain):
            steps[dev + "64"] = chip_smoke.device_step(
                chip_smoke.CONFIG, batch, dev, 60, torch.float64)["grads"]
    truth = steps["cpu64"]
    rel = {}
    for dev in ("cuda", "cpu"):
        err = {n: float((g.double() - truth[n]).abs().max()
                        / truth[n].abs().max())
               for n, g in steps[dev].items()}
        rel[dev] = dict(sorted(err.items(), key=lambda kv: -kv[1])[:5])
    result["f32_grad_err_share"] = rel
    result["f64_card_vs_cpu"] = max(
        float((steps["cuda64"][n] - t).abs().max() / t.abs().max())
        for n, t in truth.items())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
