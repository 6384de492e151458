"""K1, the pillar scatter (``ops/pillar_scatter.py``, the whole call with
its fill): the least time its bytes need (the canvas written once, the
request's real pillars and their cell ids read once) over the device time
of the kernels launched inside its calls, in the profiled slice."""
from benchmark import roofline

TARGETS = [("automatic_as_built_reconstruction_tpu_torch.models.pointpillars",
            "scatter_sorted_to_canvas", "bench.k1")]


def read(rec):
    us = rec["slice"].device_us_in("bench.k1")
    calls = rec["calls"].get("bench.k1")
    if not us or not calls or len(calls) != len(rec["slice_served"]):
        return None
    need = 0
    for call, k in zip(calls, rec["slice_served"]):
        (B, _, C), hw = call[0], call[2]
        pillars = rec["work"][k]["voxels"]
        need += roofline.k1_bytes(B, 0, C, hw) + pillars * (C * 4 + 4)
    return 100.0 * roofline.bound_s(0, need) / (us * 1e-6)
