"""How far the data-parallel car.fhd step lies from the one-process step,
as a share of how far the same step lies when only its rows are
reordered, over several batches.

    python3 dp_control_spread.py [--batches N] [--json PATH]

``chip_smoke.py``'s ``multi_device`` (b) holds one data-parallel step of
``car.fhd.config`` at B = 6 (DP_RANKS ranks sharing the card over gloo)
to the one-process step on the joined batch: the median tensor's max
|diff| / max |g| and the worst tensor's relative L2 distance each within
CONTROL_MARGIN x the larger of two controls', the one-process step on
the batch's rows reversed and rolled by one.  This script runs that
comparison on the first N batches (default 6) of the sequential loader
(seed 0; ``chip_smoke.sequential_batches``) of a synthetic KITTI clone
(``chip_smoke.write_clone``): one spawn of ranks steps every batch
(``chip_smoke.dp_second_step``), then ``chip_smoke.second_reference``
steps it in one process and in the two controls.  For each batch it
prints the DP step's two distances, the larger control's, their ratios
(what the check holds within CONTROL_MARGIN) and the loss; last one JSON
line with every batch's numbers and the ratios' spread (also written to
``--json``).  Needs one GPU; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path


def dp_steps(mesh, config: str, batches: list) -> list:
    """Each rank's body: the DP step of every batch (from the trainer's
    seed-0 state each time).  -> rank 0's results."""
    import torch

    import chip_smoke as cs

    out = []
    with torch.enable_grad():
        for batch in batches:
            res, _ = cs.dp_second_step(mesh, config, batch)
            res.pop("step_ms")
            out.append(res)
    return out if mesh.is_main else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("dp_control_spread: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from automatic_as_built_reconstruction_tpu_torch.data import batching
    from automatic_as_built_reconstruction_tpu_torch.parallel import launch

    card = cs.toolchain()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "kitti"
        cs.write_clone(root, False, "dp spread", card)
        config = cs.kitti_config(cs.SECOND_TRAIN_CONFIG, tmp, root)
        batches = [batching.device_example(b) for b in
                   cs.sequential_batches(config, args.batches)]
        got = launch.spawn(dp_steps, cs.DP_RANKS, cs.DP_DEVICES,
                           args=(str(config), batches),
                           timeout=cs.DP_TIMEOUT)
        for i, (batch, dp) in enumerate(zip(batches, got)):
            ref = cs.second_reference(config, batch)
            median, l2, worst = cs.grad_distance(dp["grads"], ref["grads"])
            ctrl = [cs.grad_distance(c, ref["grads"])
                    for c in ref["controls"]]
            c_median = max(c[0] for c in ctrl)
            c_l2 = max(c[1] for c in ctrl)
            row = {"batch": i, "dp_median_share": median, "dp_l2": l2,
                   "dp_worst_share": worst, "control_median_share": c_median,
                   "control_l2": c_l2,
                   "median_ratio": median / c_median, "l2_ratio": l2 / c_l2,
                   "loss_rel": abs(dp["loss"] - ref["loss"]) / abs(
                       ref["loss"]),
                   "num_pos": [dp["num_pos"], ref["num_pos"]]}
            rows.append(row)
            cs.log(f"dp spread [{card}]: batch {i}: " + json.dumps(row))
    ratios = {k: [r[k] for r in rows] for k in ("median_ratio", "l2_ratio")}
    summary = {"card": card, "batches": len(rows),
               "control_margin": cs.CONTROL_MARGIN, "rows": rows,
               "spread": {k: {"min": min(v), "median": float(np.median(v)),
                              "max": max(v)} for k, v in ratios.items()},
               "over_margin": sum(r["median_ratio"] > cs.CONTROL_MARGIN
                                  or r["l2_ratio"] > cs.CONTROL_MARGIN
                                  for r in rows)}
    line = json.dumps(summary)
    print(line, flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
