"""Port vs JAX package, op by op: key-order voxelization (exact), the
pillar scatter (exact), the rotated IoU (atol 1e-5), NMS keep sets
(exact) and predict's top-k tie order (exact).

The JAX side runs its Pallas kernels in interpret mode (the default off
the TPU); the port runs the kernels' plain PyTorch versions on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.models import voxelnet as jvn
from automatic_as_built_reconstruction_tpu.ops import (
    nms_jax, rotated_iou as jax_rotated_iou, voxelize_jax)
from automatic_as_built_reconstruction_tpu.ops.pallas import (
    pillar_scatter as jax_ps, rotated_iou_pallas)
from automatic_as_built_reconstruction_tpu_torch.models import voxelnet as tvn
from automatic_as_built_reconstruction_tpu_torch.ops import (
    nms, pillar_scatter, rotated_iou, voxelize)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# --------------------------------------------------------------------------
# voxelize
# --------------------------------------------------------------------------

def _scan_batch(rng, B, P, n_valid, extent=8.0):
    """Dense clusters (over-cap voxels), out-of-range points, non-finite
    and huge coordinates, and garbage in the padding past num_valid."""
    pts = np.zeros((B, P, 4), np.float32)
    for b in range(B):
        n = n_valid[b]
        xyz = rng.uniform(-1.0, extent + 1.0, (n, 3))
        hot = rng.integers(0, n, n // 3)
        xyz[hot] = rng.uniform(2.0, 2.6, (len(hot), 3))   # crowded cells
        xyz[:, 2] = rng.uniform(-0.5, 3.5, n)
        pts[b, :n, :3] = xyz
        pts[b, :n, 3] = rng.random(n)
        pts[b, n:] = rng.normal(size=(P - n, 4)) * 3      # padding junk
    pts[0, 5, 0] = np.nan
    pts[0, 6, 1] = 1e10
    pts[0, 7, 2] = -3e9
    return pts


@pytest.mark.parametrize("max_voxels,max_points", [
    (512, 4),      # V*T <= 2P: the JAX gather construction
    (2000, 24),    # V*T > 2P: the JAX scatter construction
    (40, 8),       # voxel cap below the occupied cells
])
def test_voxelize_matches_jax_exactly(max_voxels, max_points):
    """Coords, counts and voxel count equal; voxels equal bit for bit.
    Covers padding, out-of-range, NaN and huge points, over-cap voxels."""
    rng = np.random.default_rng(max_voxels)
    B, P = 3, 3000
    n_valid = np.array([3000, 1700, 0], np.int32)
    pts = _scan_batch(rng, B, P, n_valid)
    geo = dict(voxel_size=(0.25, 0.25, 4.0),
               pc_range=(0.0, 0.0, -0.5, 8.0, 8.0, 3.5), grid_size=(32, 32, 1))
    out = voxelize.voxelize(torch.from_numpy(pts), torch.from_numpy(n_valid),
                            max_points=max_points, max_voxels=max_voxels,
                            first_appearance=False, **geo)
    for b in range(B):
        ref = voxelize_jax.voxelize(
            jnp.asarray(pts[b]), jnp.int32(n_valid[b]), max_points=max_points,
            max_voxels=max_voxels, first_appearance=False, **geo)
        np.testing.assert_array_equal(out.coords[b].numpy(),
                                      np.asarray(ref.coords))
        np.testing.assert_array_equal(out.num_points[b].numpy(),
                                      np.asarray(ref.num_points))
        assert int(out.num_voxels[b]) == int(ref.num_voxels)
        np.testing.assert_array_equal(_bits(out.voxels[b].numpy()),
                                      _bits(np.asarray(ref.voxels)))
    assert int(out.num_voxels[2]) == 0
    if max_voxels == 40:
        assert int(out.num_voxels[0]) == 40


# --------------------------------------------------------------------------
# K1: pillar scatter
# --------------------------------------------------------------------------

def test_pillar_scatter_plain_matches_jax_exactly():
    rng = np.random.default_rng(0)
    B, V, C, hw = 2, 300, 16, 40 * 40          # two 1024-cell TPU tiles
    feats = rng.normal(size=(B, V, C)).astype(np.float32)
    lin = np.full((B, V), hw, np.int32)         # padding rows: id >= hw
    for b, n in enumerate((300, 170)):
        lin[b, :n] = np.sort(rng.choice(hw, n, replace=False))
    before = pillar_scatter.scatter_sorted_to_canvas.launches
    out = pillar_scatter.scatter_sorted_to_canvas(
        torch.from_numpy(feats), torch.from_numpy(lin), hw).numpy()
    assert pillar_scatter.scatter_sorted_to_canvas.launches == before
    assert out.shape == (B, hw, C)
    for b in range(B):
        ref_k = jax_ps.scatter_sorted_to_canvas(
            jnp.asarray(feats[b]), jnp.asarray(lin[b]), hw=hw,
            interpret=True)
        ref_x = jax_ps.scatter_to_canvas_xla(
            jnp.asarray(feats[b]), jnp.asarray(lin[b]), hw)
        np.testing.assert_array_equal(out[b], np.asarray(ref_k))
        np.testing.assert_array_equal(out[b], np.asarray(ref_x))


def test_pillar_scatter_plain_takes_ids_in_any_order():
    """Unique ids, unsorted (pillars in first-appearance order, as the
    host voxelizer numbers them) with padding rows in between: the JAX
    package sends these through its XLA scatter."""
    rng = np.random.default_rng(3)
    B, V, C, hw = 2, 300, 16, 40 * 40
    feats = rng.normal(size=(B, V, C)).astype(np.float32)
    lin = np.full((B, V), hw, np.int32)
    for b, n in enumerate((300, 170)):
        rows = rng.choice(V, n, replace=False)
        lin[b, rows] = rng.choice(hw, n, replace=False)
    assert (lin[:, 1:] < lin[:, :-1]).any()
    out = pillar_scatter.scatter_sorted_to_canvas(
        torch.from_numpy(feats), torch.from_numpy(lin), hw).numpy()
    for b in range(B):
        ref = jax_ps.scatter_to_canvas_xla(
            jnp.asarray(feats[b]), jnp.asarray(lin[b]), hw)
        np.testing.assert_array_equal(out[b], np.asarray(ref))
    assert (out != 0).any(-1).sum() == 470


# --------------------------------------------------------------------------
# K2: rotated IoU
# --------------------------------------------------------------------------

def _iou_boxes(rng, n):
    """Random overlapping boxes plus the degenerate cases: coincident
    boxes, zero-area pad boxes, 90-degree-rotated thin boxes.

    Sizes start at 0.5 m, as in the JAX package's own rotated-IoU tests:
    the shoelace sum runs on absolute corners, so a box's fp32 area noise
    grows with its distance from the origin over its area, and the two
    frameworks' cos/sin differ in the last bit (a 0.19 x 0.16 m box at
    (3, 5) m already differs by 1.5e-5)."""
    b = np.concatenate([rng.uniform(0, 6, (n, 2)), rng.uniform(0.5, 3, (n, 2)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    b[1] = b[0]                                   # coincident pair
    b[2] = [1e6, 1e6, 0.0, 0.0, 0.0]              # TPU pad box
    b[3] = [b[4, 0], b[4, 1], 0.0, 0.0, 0.3]      # zero area on a box
    # a thin wall, the same at 90 degrees, and the cross with w/l swapped
    # (near the origin: far out, fp32 cancellation in the shoelace sum
    # alone moves a thin box's IoU by ~1e-5)
    b[5] = [0.3, 0.3, 0.05, 2.5, 0.0]
    b[6] = [0.3, 0.3, 0.05, 2.5, np.pi / 2]
    b[7] = [0.3, 0.3, 2.5, 0.05, 0.0]
    return b.astype(np.float32)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_rotated_iou_plain_matches_jax(criterion):
    rng = np.random.default_rng(7 + criterion)
    R, N, K = 2, 24, 40
    a = np.stack([_iou_boxes(rng, N) for _ in range(R)])
    q = np.stack([_iou_boxes(rng, K) for _ in range(R)])
    q[:, :N] = np.where(rng.random((R, N, 1)) < 0.3, a, q[:, :N])
    before = rotated_iou.rotate_iou_matrix.launches
    out = rotated_iou.rotate_iou_matrix(torch.from_numpy(a),
                                        torch.from_numpy(q), criterion)
    assert rotated_iou.rotate_iou_matrix.launches == before
    out = out.numpy()
    assert out.shape == (R, N, K)
    # IoU over the union against a zero-area column box B is 0/0: the
    # clip by B's degenerate edges keeps all of A, so union = area_a -
    # inter is rounding noise on both sides (the JAX functions included);
    # those columns are held to the other criteria only
    ok = np.ones((R, N, K), bool)
    if criterion == -1:
        ok &= (q[:, None, :, 2] * q[:, None, :, 3]) > 0
    for r in range(R):
        ref_p = rotated_iou_pallas.rotate_iou_matrix_pallas(
            jnp.asarray(a[r]), jnp.asarray(q[r]), criterion=criterion,
            interpret=True)
        ref_x = jax_rotated_iou.rotate_iou_matrix(
            jnp.asarray(a[r]), jnp.asarray(q[r]), criterion=criterion)
        np.testing.assert_allclose(out[r][ok[r]], np.asarray(ref_p)[ok[r]],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(out[r][ok[r]], np.asarray(ref_x)[ok[r]],
                                   atol=1e-5, rtol=0)
    if criterion == -1:
        assert out[0, 0, 0] == pytest.approx(1.0, abs=1e-6)
        self_iou = rotated_iou.rotate_iou_matrix(torch.from_numpy(a[:1]),
                                                 torch.from_numpy(a[:1]))[0]
        assert self_iou[0, 1] == pytest.approx(1.0, abs=1e-6)  # coincident
        assert float(self_iou[2].abs().max()) == 0.0  # pad box as A
        cross = 0.05 * 0.05 / (2 * 0.05 * 2.5 - 0.05 * 0.05)
        assert float(self_iou[5, 6]) == pytest.approx(cross, abs=1e-5)
        assert float(self_iou[6, 7]) == pytest.approx(1.0, abs=1e-5)


def test_clip_flops_counts_the_work_the_boxes_need():
    """Coincident unit squares hold all 4 vertices through the 4 clip
    steps with no crossing (16 held, 4 left): 5*16 + 4*4 + 4 = 100.  A
    square 100 m along x empties at B's second edge (4 + 4 held):
    5*8 + 4 = 44.  No pair needs more than 5*22 + 8*8 + 4*8 + 4 = 210."""
    sq = torch.tensor([[[0.0, 0.0, 1.0, 1.0, 0.0]]])
    far = torch.tensor([[[100.0, 0.0, 1.0, 1.0, 0.0]]])
    assert rotated_iou.clip_flops(sq, sq) == 100
    assert rotated_iou.clip_flops(far, sq) == 44
    rng = np.random.default_rng(5)
    a = torch.from_numpy(np.stack([_iou_boxes(rng, 30) for _ in range(2)]))
    q = torch.from_numpy(np.stack([_iou_boxes(rng, 20) for _ in range(2)]))
    flops = rotated_iou.clip_flops(a, q)
    assert 4 * 2 * 30 * 20 < flops <= 210 * 2 * 30 * 20


# --------------------------------------------------------------------------
# NMS
# --------------------------------------------------------------------------

def _threshold_clear_of(values, thr, margin):
    """Nudge ``thr`` until no value lies within ``margin`` of it."""
    for step in range(1000):
        t = thr + step * 1e-3
        if not np.any(np.abs(values - t) <= margin):
            return t
    raise AssertionError("no clear threshold")


@pytest.mark.parametrize("n_valid", [
    (100, 60, 0),        # every row within compact_cap: compacted width
    (290, 120, 300),     # a row beyond compact_cap: full width
])
def test_rotate_nms_presorted_matches_jax(n_valid):
    rng = np.random.default_rng(sum(n_valid))
    R, K = len(n_valid), 300
    boxes = np.concatenate([
        rng.uniform(0, 12, (R, K, 2)), rng.uniform(0.2, 3.0, (R, K, 2)),
        rng.uniform(-np.pi, np.pi, (R, K, 1))], -1).astype(np.float32)
    scores = -np.sort(-rng.random((R, K)), axis=1).astype(np.float32)
    for r, n in enumerate(n_valid):
        scores[r, n:] = -np.inf
    ious = np.concatenate([np.asarray(jax_rotated_iou.rotate_iou_matrix(
        jnp.asarray(b), jnp.asarray(b))).ravel() for b in boxes])
    thr = _threshold_clear_of(ious, 0.3, 1e-4)
    idx, valid = nms.rotate_nms_presorted(
        torch.from_numpy(boxes), torch.from_numpy(scores), thr,
        post_max_size=100)
    ref_idx, ref_valid = nms_jax.rotate_nms_presorted(
        jnp.asarray(boxes), jnp.asarray(scores), thr, post_max_size=100)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    # suppression really happened: a kept index skips a suppressed one
    kept0 = idx.numpy()[0][valid.numpy()[0]]
    assert len(kept0) and (kept0 != np.arange(len(kept0))).any()


def test_center_suppress_matches_jax():
    rng = np.random.default_rng(3)
    R, K, radius = 3, 120, 0.3
    centers = rng.uniform(0, 4, (R, K, 2)).astype(np.float32)
    d2 = ((centers[:, :, None] - centers[:, None]) ** 2).sum(-1)
    assert not np.any(np.abs(d2 - np.float32(radius * radius)) <= 1e-5)
    valid = rng.random((R, K)) < 0.8
    keep = nms.center_suppress_presorted(torch.from_numpy(centers),
                                         torch.from_numpy(valid), radius)
    ref = nms_jax.center_suppress_presorted(jnp.asarray(centers),
                                            jnp.asarray(valid), radius)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref))
    assert 0 < keep.numpy().sum() < valid.sum()


def _nms_cases(n_valid_rows):
    """Score-sorted rows of 300 random boxes with the given valid counts,
    and an IoU threshold clear of every pair's IoU by 1e-4."""
    rng = np.random.default_rng(5)
    R, K = len(n_valid_rows[0]), 300
    boxes = np.concatenate([
        rng.uniform(0, 12, (R, K, 2)), rng.uniform(0.2, 3.0, (R, K, 2)),
        rng.uniform(-np.pi, np.pi, (R, K, 1))], -1).astype(np.float32)
    ious = np.concatenate([np.asarray(jax_rotated_iou.rotate_iou_matrix(
        jnp.asarray(b), jnp.asarray(b))).ravel() for b in boxes])
    cases = []
    for n_valid in n_valid_rows:
        scores = -np.sort(-rng.random((R, K)), axis=1).astype(np.float32)
        for r, n in enumerate(n_valid):
            scores[r, n:] = -np.inf
        cases.append(scores)
    return boxes, cases, _threshold_clear_of(ious, 0.3, 1e-4)


class _ExportedNms(torch.nn.Module):
    def __init__(self, thr):
        super().__init__()
        self.thr = thr

    def forward(self, boxes, scores):
        idx, valid = nms.rotate_nms_presorted(boxes, scores, self.thr,
                                              post_max_size=100)
        keep = nms.center_suppress_presorted(boxes[..., :2],
                                             scores > -float("inf"), 0.3)
        return idx, valid, keep


def test_exported_nms_decides_on_the_device():
    """One ``torch.export`` of ``rotate_nms_presorted`` and
    ``center_suppress_presorted``, saved and reloaded, takes both
    ``compact_cap`` branches on the data it is given (a ``cond`` node, the
    fixpoints ``while_loop`` nodes) and gives the JAX package's keep sets
    in both; ``greedy_suppress`` row by row gives ``_greedy_suppress``'s."""
    import io

    boxes, cases, thr = _nms_cases([(100, 60, 0), (290, 120, 300)])
    program = torch.export.export(
        _ExportedNms(thr), (torch.from_numpy(boxes),
                            torch.from_numpy(cases[0])))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue()))
    nodes = {str(n.target) for m in loaded.graph_module.modules()
             if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes}
    assert {"cond", "while_loop"} <= nodes
    run = loaded.module()
    for scores in cases:
        idx, valid, keep = run(torch.from_numpy(boxes),
                               torch.from_numpy(scores))
        ref_idx, ref_valid = nms_jax.rotate_nms_presorted(
            jnp.asarray(boxes), jnp.asarray(scores), thr, post_max_size=100)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        ref_keep = nms_jax.center_suppress_presorted(
            jnp.asarray(boxes[..., :2]), jnp.asarray(scores > -np.inf), 0.3)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
        assert 0 < int(valid.sum()) < int((scores > -np.inf).sum())
    iou = rotated_iou.rotate_iou_matrix(torch.from_numpy(boxes),
                                        torch.from_numpy(boxes))
    valid = torch.from_numpy(cases[1] > -np.inf)
    keep = nms.greedy_suppress(iou > thr, valid)
    for r in range(len(boxes)):
        ref = nms_jax._greedy_suppress(jnp.asarray(iou[r].numpy()),
                                       jnp.asarray(valid[r].numpy()), thr)
        np.testing.assert_array_equal(keep[r].numpy(), np.asarray(ref))


# --------------------------------------------------------------------------
# predict: top-k tie order
# --------------------------------------------------------------------------

@pytest.mark.parametrize("limit", [
    None, (0.5, 0.5, -5.0, 3.0, 4.0, 5.0)],
    ids=["sigmoid", "sigmoid_center_limit"])
def test_predict_tied_scores_match_jax(limit):
    """Saturated logits give scores == 1.0 exactly on many anchors of a
    row; the stable descending sort must break the ties by the lower
    anchor index, as jax.lax.top_k does.  Also covers the post-centre
    limit range."""
    rng = np.random.default_rng(11)
    jcfg = jvn.VoxelNetConfig(
        num_class=2, num_anchor_per_loc=2, grid_size=(16, 16, 1),
        encode_background_as_zeros=True, post_center_limit_range=limit,
        direction_offset=0.3, nms_pre_max_size=64, nms_post_max_size=20,
        nms_score_threshold=0.1, nms_iou_threshold=0.3,
        nms_center_suppress_radius=0.3)
    tcfg = tvn.VoxelNetConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tvn.VoxelNetConfig)})
    B, H, W, A = 2, 8, 8, 2
    ncls = 2
    n = H * W * A
    cls = rng.normal(0, 2, (B, H, W, A * ncls)).astype(np.float32)
    hot = rng.choice(n, 60, replace=False)
    flat = cls.reshape(B, n, ncls)
    flat[:, hot, 0] = 40.0
    cls = flat.reshape(B, H, W, A * ncls)
    box = (rng.normal(0, 0.3, (B, H, W, A * 7))).astype(np.float32)
    dirc = rng.normal(size=(B, H, W, A * 2)).astype(np.float32)
    anchors = np.zeros((B, n, 7), np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    anchors[:, :, 0] = np.repeat(xx.ravel() * 0.5, A)
    anchors[:, :, 1] = np.repeat(yy.ravel() * 0.5, A)
    anchors[:, :, 3:6] = [0.6, 1.2, 1.0]
    anchors[:, 1::2, 6] = np.pi / 2
    jpreds = {"cls_preds": cls, "box_preds": box, "dir_cls_preds": dirc}
    ref = {k: np.asarray(v) for k, v in jvn.predict(
        {k: jnp.asarray(v) for k, v in jpreds.items()},
        jnp.asarray(anchors), jcfg).items()}
    tpreds = {k: torch.from_numpy(v).permute(0, 3, 1, 2)
              for k, v in jpreds.items()}
    out = {k: v.numpy() for k, v in tvn.predict(
        tpreds, torch.from_numpy(anchors), tcfg).items()}
    assert (ref["scores"] == 1.0).sum() > 10       # ties really reach NMS
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    np.testing.assert_array_equal(out["label_preds"], ref["label_preds"])
    np.testing.assert_allclose(out["scores"], ref["scores"], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(out["box3d_lidar"], ref["box3d_lidar"],
                               atol=1e-5, rtol=0)
