"""The lower-precision control of a serve cell: the reference, computed a
step below float32, put in the program's place and judged by the same
comparison as a run.  The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --lower vox,net,decode

One control per ``--lower`` stage and seed, each lowering that stage
alone: ``vox`` computes the cell coordinates in bfloat16, ``net`` lets
the convolutions and products run in TF32, ``decode`` decodes the boxes
in bfloat16.  Each prints its numbers beside the cell's limits; a limit
holds only where every control fails some number.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402
from torch import nn  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import network, postprocess, voxelize  # noqa: E402

STAGES = ("vox", "net", "decode")


class _Net(nn.Module):
    def __init__(self, model, weights, tf32):
        super().__init__()
        self.spec, self.w, self.tf32 = model, weights, tf32

    def forward(self, voxels, num_points, coords):
        return network.heads(voxelize.Voxels(voxels, num_points, coords),
                             self.spec, self.w, tf32=self.tf32)


class ReferencePod:
    """The reference with ``PodInference``'s shape: ``voxelize``,
    ``model``, ``program`` and ``__call__``, each stage lowered where
    ``lower`` names it."""

    def __init__(self, config, weights, device, lower=()):
        self.spec = config["model"]
        self.device = device
        self.lower = set(lower)
        self.model = _Net(self.spec, weights, "net" in self.lower)

    def voxelize(self, pts, nv):
        v = self.spec["voxel"]
        dt = torch.bfloat16 if "vox" in self.lower else torch.float32
        return tuple(voxelize.voxelize(
            pts, nv.tolist(), pc_range=v["pc_range"],
            voxel_size=v["voxel_size"], max_points=v["max_points"],
            max_voxels=v["max_voxels"], point_dtype=dt))

    def program(self, pts, nv):
        heads = self.model(*self.voxelize(pts, nv))
        dt = torch.bfloat16 if "decode" in self.lower else torch.float32
        return postprocess.predict(heads, self.spec, decode_dtype=dt)

    def __call__(self, points, num_valid):
        pts = torch.as_tensor(points, device=self.device)
        nv = torch.as_tensor(num_valid)
        return self.program(pts, nv)


def factory(lower):
    def make(config, weights, device):
        return ReferencePod(config, weights, device, lower)
    return make


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--lower", default=",".join(STAGES))
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    from benchmark import harness
    for seed in (int(s) for s in args.seeds.split(",")):
        for stage in args.lower.split(","):
            t = time.perf_counter()
            r = harness.run_cell(args.workload, seed, 0.0, False,
                                 t0=t, device=args.device,
                                 program_factory=factory([stage]),
                                 control=True)
            print(json.dumps({"control": stage, "seed": seed,
                              "checks": r["checks"],
                              "seconds": time.perf_counter() - t}))
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
