"""The yardstick's arithmetic: the chip's peaks and the operations and
bytes each measured piece of work needs, counted from the model's
definition and the input shapes (never from how the program does it).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): the float32 ceiling is the TF32 tensor-core rate, the fastest any
route accurate to float32 can run (3xTF32 runs below it at a third, plain
float32 on the SIMT cores at 67 TFLOP/s), and HBM3 moves 3.35 TB/s.

Counting rules:
- a sparse convolution does 2 * hits * Cin * Cout operations, a hit being
  an (output site, tap) pair whose input site is active; a dense tail is
  counted as the sparse layers it replaces;
- a dense convolution does 2 * outputs * Cin * Cout * taps, a transposed
  one 2 * inputs * Cin * Cout * taps, a linear layer 2 * rows * in * out
  over the real points only;
- K1 (the pillar scatter) reads the pillars and their cell ids once and
  writes the whole canvas once;
- K2 (the rotated IoU) reads once the boxes that NMS has to weigh and
  writes their IoU matrix once (its arithmetic is not counted): per scan
  and class, the candidates at or over the score threshold, the best
  ``nms_pre_max_size`` of them, inside the centre limits where the model
  sets them, and n * n IoUs of n such boxes (never the padding a program
  may carry);
- a key-match join (K4g) reads its input features and input keys once,
  writes its output once and reads its weights once.
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_FLOPS = 495e12           # dense TF32 tensor cores: the float32 ceiling
PEAK_BYTES = 3.35e12          # HBM3
PEAK_FP32_SIMT = 67e12        # beside it, for PERF.md only
PEAK_3XTF32 = 495e12 / 3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def k1_bytes(B: int, V: int, C: int, hw: int, itemsize: int = 4) -> int:
    return B * hw * C * itemsize + B * V * C * itemsize + B * V * 4


def k2_bytes(candidates: Iterable[int]) -> int:
    """Per NMS row (a scan and a class) its number of candidates."""
    return sum(n * 5 * 4 + n * n * 4 for n in candidates)


def join_flops(hits: int, cin: int, cout: int) -> int:
    return 2 * hits * cin * cout


def join_bytes(n_in: int, n_out: int, cin: int, cout: int,
               taps: int) -> int:
    return (n_in * cin * 4 + n_in * 4 + n_out * cout * 4
            + taps * cin * cout * 4)


def _conv_out(n: int, stride: int) -> int:
    """A 3-wide convolution padded by 1."""
    return (n - 1) // stride + 1


def rpn_flops(rpn: dict, head: dict, anchors_per_loc: int, cin: int,
              H: int, W: int) -> int:
    """One scan's RPN and heads on an [cin, H, W] map."""
    flops, ups = 0, []
    for layers, stride, f, up_s, up_f in zip(
            rpn["layer_nums"], rpn["layer_strides"], rpn["num_filters"],
            rpn["upsample_strides"], rpn["num_upsample_filters"]):
        H, W = _conv_out(H, stride), _conv_out(W, stride)
        flops += 2 * H * W * cin * f * 9 + layers * 2 * H * W * f * f * 9
        s = int(round(up_s))
        flops += 2 * H * W * f * up_f * s * s
        ups.append((H * s, W * s, up_f))
        cin = f
    Hh, Wh = ups[0][0], ups[0][1]
    ch = sum(u[2] for u in ups)
    per_loc = (head["num_class"] + head["box_code_size"]
               + head["num_direction_bins"]) * anchors_per_loc
    return flops + 2 * Hh * Wh * ch * per_loc


def pfn_flops(points: int, vfe: dict) -> int:
    """The pillar encoder's linear layers over the real points."""
    flops, cin = 0, vfe["num_input_features"] + 5
    for units in vfe["num_filters"]:
        flops += 2 * points * cin * units
        cin = 2 * units
    return flops


def sparse_flops(layers: Iterable[Tuple[int, int, int]]) -> int:
    """(hits, Cin, Cout) per sparse convolution -> operations."""
    return sum(join_flops(h, ci, co) for h, ci, co in layers)
