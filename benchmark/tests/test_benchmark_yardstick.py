"""The frozen traffic, the counting arithmetic on hand-worked shapes, and
the reading of a profiler trace."""
import numpy as np
import pytest

from benchmark import roofline, tracing
from benchmark.traffic import generate, scenes


@pytest.mark.parametrize("mix", [
    {"scene": "building_room", "batch": 2, "pool": 2},
    {"scene": "kitti_like", "points": 3000, "batch": 3, "pool": 2}])
def test_traffic_repeats_bit_for_bit(mix):
    seed = 2**31 + 12345
    a, b = (generate.make_requests(mix, seed) for _ in range(2))
    c = generate.make_requests(mix, seed + 1)
    assert len(a) == mix["pool"]
    for (pa, na), (pb, nb) in zip(a, b):
        assert pa.tobytes() == pb.tobytes() and np.array_equal(na, nb)
        assert pa.shape[0] == mix["batch"] and pa.dtype == np.float32
    assert not np.array_equal(a[0][0][0, :10], c[0][0][0, :10])


def test_pad_batch_pads_with_zeros():
    pts, nv = scenes.pad_batch([np.ones((3, 4)), np.ones((5, 4))])
    assert pts.shape == (2, 5, 4) and list(nv) == [3, 5]
    assert (pts[0, 3:] == 0).all() and (pts[1] == 1).all()


def test_counts_on_hand_worked_shapes():
    # canvas 2 * 100 * 4 floats, pillars 2 * 10 * 4 floats, ids 2 * 10
    assert roofline.k1_bytes(2, 10, 4, 100) == 3200 + 320 + 80
    # rows of 2, 0 and 3 candidates: 5 floats a box, n * n IoUs
    assert roofline.k2_bytes([2, 0, 3]) == (40 + 16) + 0 + (60 + 36)
    assert roofline.join_flops(10, 4, 8) == 640
    # features 5 * 4, keys 5, output 7 * 8, weights 27 * 4 * 8, 4 bytes
    assert roofline.join_bytes(5, 7, 4, 8, 27) == 4 * (20 + 5 + 56 + 864)
    # 9 decorated inputs into 64 units, 100 points
    assert roofline.pfn_flops(100, {"num_input_features": 4,
                                    "num_filters": [64]}) == 2 * 100 * 9 * 64
    assert roofline.sparse_flops([(10, 4, 8), (1, 2, 3)]) == 640 + 12
    assert roofline.bound_s(495e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_rpn_flops_on_a_hand_worked_net():
    rpn = {"layer_nums": [1], "layer_strides": [2], "num_filters": [8],
           "upsample_strides": [2], "num_upsample_filters": [4]}
    head = {"num_class": 1, "box_code_size": 7, "num_direction_bins": 2}
    # a 10 x 10 map of 3 channels: the strided conv gives 5 x 5 x 8, one
    # more 3x3 conv, a 2x2 transposed conv to 10 x 10 x 4, 1x1 heads of
    # (1 + 7 + 2) * 2 outputs
    want = (2 * 25 * 3 * 8 * 9 + 2 * 25 * 8 * 8 * 9 + 2 * 25 * 8 * 4 * 4
            + 2 * 100 * 4 * 20)
    assert roofline.rpn_flops(rpn, head, 2, 3, 10, 10) == want


def _trace():
    """Two requests on one thread; kernels launched inside and outside a
    labelled range; a gap while the host waits."""
    ev = []

    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid, "pid": 1}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)

    x("user_annotation", "bench.request", 0, 100)
    x("user_annotation", "bench.request", 100, 100)
    x("user_annotation", "bench.k1", 10, 10)
    x("user_annotation", "bench.k1", 110, 10)
    x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1)
    x("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2)
    x("cuda_runtime", "cudaLaunchKernel", 112, 1, corr=3)
    x("cuda_runtime", "cudaLaunchKernel", 112, 1, tid=2, corr=4)
    x("cpu_op", "aten::item", 40, 80)
    x("kernel", "k1_kernel", 15, 5, tid=7, corr=1)
    x("kernel", "other", 31, 9, tid=7, corr=2)
    x("kernel", "k1_kernel", 130, 5, tid=7, corr=3)
    x("kernel", "side", 150, 10, tid=8, corr=4)
    return {"traceEvents": ev}


def test_trace_reading():
    sl = tracing.Slice(_trace())
    assert sl.requests == 2 and sl.window_us == 200
    assert sl.device_us_in("bench.k1") == 10      # not the other thread's
    assert sl.device_us_in("bench.k2") is None
    assert sl.busy_us == 5 + 9 + 5 + 10
    ops = dict(sl.top_ops())
    assert ops["k1_kernel"] == pytest.approx(10e-6)
    gaps = sl.idle_gaps()
    assert gaps[0][1] == pytest.approx(90e-6)      # 40 .. 130
    assert gaps[0][0] == "bench.request|aten::item"


def test_rotated_iou_on_hand_worked_boxes():
    import torch
    from benchmark.reference import postprocess
    boxes = torch.tensor([[0.0, 0.0, 2.0, 2.0, 0.0],      # x, y, w, l, yaw
                          [1.0, 0.0, 2.0, 2.0, 0.0],      # half over box 0
                          [5.0, 5.0, 2.0, 2.0, 0.3],      # apart
                          [0.0, 0.0, 2.0, 2.0, np.pi / 2],  # box 0 turned
                          [60.0, 30.0, 1.0, 4.0, np.pi / 4]])
    iou = postprocess.rotated_iou(boxes).numpy()
    assert iou[0, 1] == pytest.approx(2.0 / 6.0, abs=1e-12)
    # pi / 2 in float32 turns the square by 4e-8 too far
    assert iou[0, 2] == 0.0 and iou[0, 3] == pytest.approx(1.0, abs=1e-6)
    assert np.allclose(np.diag(iou), 1.0, atol=1e-12)
    assert np.allclose(iou, iou.T, atol=1e-12)


def test_ties_of_rounding_follow_the_judged_answer():
    import torch
    from benchmark.reference import postprocess
    thr, tol = 0.01, 1e-4
    v = torch.zeros(3, 3, dtype=torch.float64)
    v[0, 1] = thr + tol / 2      # a tie: box 1 against kept box 0
    v[0, 2] = thr + 2 * tol      # box 2 clearly suppressed
    keep, ties = postprocess.greedy_keep(v, thr, tol, follow={1})
    assert keep.tolist() == [True, True, False] and ties == 1
    keep, ties = postprocess.greedy_keep(v, thr, tol, follow=set())
    assert keep.tolist() == [True, False, False] and ties == 1
    keep, _ = postprocess.greedy_keep(v, thr, tol)     # exact: suppressed
    assert keep.tolist() == [True, False, False]
    keep, ties = postprocess.greedy_keep(v, thr, tol, follow={2})
    assert keep.tolist()[2] is False                   # not a tie: no say


def test_nms_candidates_on_hand_worked_heads():
    """Candidates per scan and class: over the threshold, the best
    ``nms_pre_max_size``, inside the centre limits."""
    import copy
    import json
    import torch
    from benchmark.reference import postprocess
    from benchmark.tests import helpers
    model = copy.deepcopy(json.loads(
        (helpers.DATA / "asbuilt_tiny.json").read_text())["model"])
    model["post"]["nms_pre_max_size"] = 2
    B, H, W, A, C = 2, 32, 32, 5, 3            # 64 x 64 cells, stride 2
    cls = torch.full((B, H * W * A, C), -10.0)
    cls[0, 0:3, 0] = 5.0                       # 3 over the threshold, 2 kept
    cls[0, 10, 2] = 5.0                        # the anchors at x = 1.0 m
    cls[1, 7, 1] = 5.0

    def nchw(flat, c):
        return flat.reshape(B, H, W, A * c).permute(0, 3, 1, 2)

    preds = {"cls_preds": nchw(cls, C),
             "box_preds": nchw(torch.zeros(B, H * W * A, 7), 7),
             "dir_cls_preds": nchw(torch.zeros(B, H * W * A, 2), 2)}
    assert postprocess.candidate_counts(preds, model) == [2, 0, 1, 0, 1, 0]
    model["post"]["center_limit_range"] = [0.0, 0.0, -1.0, 0.5, 16.0, 1.0]
    assert postprocess.candidate_counts(preds, model) == [2, 0, 0, 0, 1, 0]
