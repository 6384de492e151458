"""K2, the rotated IoU (``ops/rotated_iou.py``, as NMS calls it): the
least time its bytes need over the device time of the kernels launched
inside its calls, in the profiled slice.  The bytes are what the slice's
requests need, whatever width the program hands the kernel: per scan and
class the candidates NMS weighs (counted by the reference), their boxes
read once and their IoU matrix written once."""
from benchmark import roofline

TARGETS = [("automatic_as_built_reconstruction_tpu_torch.ops.nms",
            "rotate_iou_matrix", "bench.k2")]


def read(rec):
    us = rec["slice"].device_us_in("bench.k2")
    if not us or not rec["calls"].get("bench.k2"):
        return None
    need = sum(roofline.k2_bytes(rec["work"][k]["nms_candidates"])
               for k in rec["slice_served"])
    if not need:
        return None
    return 100.0 * roofline.bound_s(0, need) / (us * 1e-6)
