"""The whole request's share of the chip's float32 peak: the operations
every request of the traced window needs (the encoder's linear layers over
the real points, the sparse convolutions by rulebook hits, the RPN and its
heads dense) over the window's length and the peak."""
from benchmark import roofline
from benchmark.reference import network
from benchmark.reference.voxelize import grid_size


def request_flops(model, item) -> float:
    vfe, mid = model["vfe"], model["middle"]
    gx, gy, _ = (int(g) for g in grid_size(model["voxel"]["pc_range"],
                                           model["voxel"]["voxel_size"]))
    flops = 0.0
    if vfe["kind"] == "pillar":
        flops += roofline.pfn_flops(item["points"], vfe)
    if mid["kind"] == "sparse":
        flops += roofline.sparse_flops(item["sparse"])
        out_grid = network.middle_blocks(model)[-1]["out_grid"]
        H, W = out_grid[1], out_grid[2]
    else:
        H, W = gy, gx
    rpn = roofline.rpn_flops(model["rpn"], model["head"],
                             network.num_anchors_per_loc(model),
                             network.rpn_input_channels(model), H, W)
    return flops + item["scans"] * rpn


def read(rec):
    if not rec["served"] or not rec["window_s"]:
        return None
    per = {}
    total = 0.0
    for k in rec["served"]:
        if k not in per:
            per[k] = request_flops(rec["model"], rec["work"][k])
        total += per[k]
    return 100.0 * total / rec["window_s"] / roofline.PEAK_FLOPS
