"""bfloat16 SECOND (``car.fhd.mixed``): the port's mixed-precision network
on host rulebooks, held to the JAX package's bfloat16 run on the CPU.

The twin is ``car.fhd.mixed.config`` cut in the voxels' xy size (0.4 m
for 0.05 m, a 176 x 200 x 40 grid), in ``max_number_of_voxels`` (3000)
and the batch (B = 2); it keeps the SpMiddleFHD plan, RPN 128, the host
rulebooks, ``use_pallas_sparse_gemm`` (the port's gather join; the JAX
package's K3 in interpret mode) and ``enable_mixed_precision``.

Tolerance, measured rather than fitted: bfloat16 rounds at other places in
the two frameworks (XLA's CPU convolutions against PyTorch's), so the
port's bfloat16 run may differ from the JAX package's by about what
bfloat16 itself costs.  Each head, each loss term and the gradients
(worst and median tensor, each as a share of its tensor's max |g| in the
JAX float32 step) must lie within twice the JAX package's own
bfloat16-vs-float32 distance on the same batch from the same weights.
Both numbers are printed.
"""
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.data import (
    batching as jax_batching)
from automatic_as_built_reconstruction_tpu.models import (
    voxelnet as jax_voxelnet)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu.utils import (
    weight_import as jax_weight_import)
from automatic_as_built_reconstruction_tpu_torch.data import (
    batching, synth_kitti)
from automatic_as_built_reconstruction_tpu_torch.models import voxelnet
from automatic_as_built_reconstruction_tpu_torch.ops import (
    sparse_gather_gemm as sgg)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    pod_inference_from_checkpoint)
from automatic_as_built_reconstruction_tpu_torch.train import train
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

from test_torch_kitti import kitti_config

REPO = Path(__file__).resolve().parents[1]
MIXED = (REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
         / "second" / "car" / "car.fhd.mixed.config")
MIXED_MICRO = {
    "voxel_size: [0.05, 0.05, 0.1]": "voxel_size: [0.4, 0.4, 0.1]",
    "batch_size: 6": "batch_size: 2",
    "max_number_of_voxels: 17000": "max_number_of_voxels: 3000",
    "max_number_of_voxels: 40000": "max_number_of_voxels: 3000",
    "nms_score_threshold: 0.3": "nms_score_threshold: 0.05",
}
HEADS = ("cls_preds", "box_preds", "dir_cls_preds")
BF16_MARGIN = 2.0      # x the JAX package's own bf16-vs-float32 distance


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """(the bf16 micro twin, its float32 twin) on a car clone."""
    tmp = tmp_path_factory.mktemp("mixed")
    synth_kitti.write_clone(tmp / "car", 6, 2, seed=0)
    mixed = kitti_config(MIXED.read_text(), tmp / "car", tmp,
                         "mixed.micro.config", **MIXED_MICRO)
    f32 = tmp / "f32.micro.config"
    f32.write_text(mixed.read_text().replace(
        "enable_mixed_precision: true", "enable_mixed_precision: false"))
    return mixed, f32


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _jax_step(path, init, example):
    """The JAX package's training forward on its host rulebooks: (heads
    NHWC float32, loss terms, gradients as the port's state dict)."""
    return _jax_steps(path, init, [example])[0]


def _jax_steps(path, init, examples):
    """:func:`_jax_step` on each of ``examples``, one compiled step."""
    bundle = jax_train.Bundle(path)
    model, cfg = bundle.model, bundle.model_cfg

    @jax.jit
    def step(variables, example):
        books = jax_train._middle_rulebooks(example, cfg)

        def loss_fn(p):
            preds, _ = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                example["voxels"], example["num_points"],
                example["coordinates"], train=True, middle_rulebooks=books,
                mutable=["batch_stats", "intermediates"])
            loss, terms = jax_voxelnet.compute_loss(preds, example, cfg)
            return loss, (preds, terms)

        return jax.grad(loss_fn, has_aux=True)(variables["params"])

    out = []
    for example in examples:
        grads, (preds, terms) = step(init, example)
        grads = jax_weight_import.to_torch_state_dict(
            {"params": _np_tree(grads), "batch_stats": init["batch_stats"]})
        out.append(({k: np.asarray(preds[k], np.float32) for k in HEADS},
                    {k: float(v) for k, v in terms.items()}, grads))
    return out


@pytest.fixture(scope="module")
def runs(configs):
    """The first training batch of the bf16 twin (host rulebooks), and the
    same training forward + backward from the JAX package's initial
    weights: the JAX bf16 and float32 runs and the port's bf16 run."""
    mixed, f32 = configs
    bundle = train.Bundle(mixed)
    assert bundle.model_cfg.compute_dtype == "bfloat16"
    assert bundle.model_cfg.sparse_use_pallas_gemm
    prep_ds, loader = bundle.input_reader(training=True)
    stream = loader._index_stream()
    batch = batching.merge_batch(
        [prep_ds.example(*next(stream)) for _ in range(2)])
    jmodel = jax_train.Bundle(mixed).model
    init = _np_tree(jax.jit(functools.partial(jmodel.init, train=True))(
        jax.random.key(0), np.zeros((1, 64, 5, 4), np.float32),
        np.zeros((1, 64), np.int32), np.full((1, 64, 3), -1, np.int32)))
    example = jax_train._to_device(jax_batching.device_example(batch))
    out = {"jax_bf16": _jax_step(mixed, init, example),
           "jax_f32": _jax_step(f32, init, example)}

    model = bundle.model
    weight_import.load_variables(model, init)
    ex = train.to_device(batch, "cpu")
    preds = train.forward(model.train(), ex, bundle.model_cfg)
    loss, terms = voxelnet.compute_loss(preds, ex, bundle.model_cfg)
    loss.backward()
    out["port_bf16"] = (
        {k: v.detach().permute(0, 2, 3, 1).numpy() for k, v in preds.items()},
        {k: float(v.detach()) for k, v in terms.items()},
        {n: p.grad.numpy() for n, p in model.named_parameters()})
    out["preds"] = preds
    return out


def _head_distance(a, b, k):
    return float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())


def _grad_distances(got, want, scale):
    """(worst, median) over the tensors of max |got - want| / max |scale|."""
    shares = [float(np.abs(got[n] - want[n]).max() / np.abs(scale[n]).max())
              for n in scale if np.abs(scale[n]).max() > 0]
    return max(shares), float(np.median(shares))


def test_mixed_heads_match_jax_bf16(runs):
    """Each head of the port's bfloat16 forward (train mode, host
    rulebooks) against the JAX package's bfloat16 forward, within twice
    the JAX bf16-vs-float32 distance (share of the head's max |x|)."""
    port, jbf, j32 = (runs[k][0] for k in ("port_bf16", "jax_bf16",
                                            "jax_f32"))
    for k in HEADS:
        assert runs["preds"][k].dtype == torch.float32     # cast back
        got, own = _head_distance(port, jbf, k), _head_distance(jbf, j32, k)
        print(f"{k}: port bf16 vs JAX bf16 {got:.4g}; JAX bf16 vs JAX "
              f"float32 {own:.4g}")
        assert np.isfinite(port[k]).all()
        assert 0 < got <= BF16_MARGIN * own, (k, got, own)


def test_mixed_step_matches_jax_bf16(runs):
    """One bfloat16 step: each loss term, and the gradients (worst and
    median tensor), against the JAX bfloat16 step within twice the JAX
    bf16-vs-float32 distance."""
    _, tp, gp = runs["port_bf16"]
    _, tb, gb = runs["jax_bf16"]
    _, t32, g32 = runs["jax_f32"]
    for k in t32:
        got, own = abs(tp[k] - tb[k]), abs(tb[k] - t32[k])
        print(f"{k}: port {tp[k]:.6g} JAX bf16 {tb[k]:.6g} JAX float32 "
              f"{t32[k]:.6g}")
        assert got <= BF16_MARGIN * own, (k, got, own)
    assert set(gp) <= set(gb)             # the JAX dict adds the statistics
    got = _grad_distances(gp, gb, {n: g32[n] for n in gp})
    own = _grad_distances(gb, g32, {n: g32[n] for n in gp})
    print(f"gradients (worst, median share of max |g|): port bf16 vs JAX "
          f"bf16 {got}; JAX bf16 vs JAX float32 {own}")
    assert got[0] <= BF16_MARGIN * own[0]
    assert got[1] <= BF16_MARGIN * own[1]
    assert all(np.isfinite(g).all() for g in gp.values())


def test_mixed_model_computes_in_bf16(configs):
    """The VFE's output stays float32, the middle's canvas is bfloat16,
    every head comes back float32; parameters and BatchNorm statistics
    stay float32; the middle's joins go through the gather function."""
    bundle = train.Bundle(configs[0])
    model = bundle.model.eval()
    prep_ds, loader = bundle.input_reader(training=False)
    ex = train.to_device(next(iter(loader)), "cpu")
    with torch.no_grad():
        preds, stages = model(
            ex["voxels"], ex["num_points"], ex["coordinates"],
            middle_rulebooks=train.middle_rulebooks(ex, bundle.model_cfg),
            return_stages=True)
    assert stages["voxel_features"].dtype == torch.float32
    assert stages["spatial_features"].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in preds.values())
    assert all(t.dtype == torch.float32 for t in model.state_dict().values()
               if t.is_floating_point())


def test_bf16_join_backward_upcasts_dout(monkeypatch):
    """The gather join on bfloat16 features and weights: the backward
    hands float32 ``dout`` (never rounded to bfloat16), float32 features
    and weights to the backward functions, and returns bfloat16
    gradients equal to the float32 backward of the same values, rounded
    once."""
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(2, 40, 16, generator=g).bfloat16().requires_grad_()
    w = torch.randn(27, 16, 32, generator=g).bfloat16().requires_grad_()
    idx = torch.randint(0, 40, (2, 27, 50), generator=g, dtype=torch.int32)
    found = torch.rand(2, 27, 50, generator=g) < 0.3
    dout = torch.randn(2, 50, 32, generator=g)
    seen = []
    for name in ("join_grad_features", "join_grad_weights"):
        fn = getattr(sgg, name)

        def spy(*args, _fn=fn):
            seen.append(tuple(a.dtype for a in args
                              if isinstance(a, torch.Tensor)
                              and a.is_floating_point()))
            return _fn(*args)
        monkeypatch.setattr(sgg, name, spy)
    out = sgg.gather_gemm(feats, idx, found, w)
    assert out.dtype == torch.float32
    out.backward(dout)
    assert seen and all(d == torch.float32 for s in seen for d in s), seen
    df, dw = sgg.join_backward_plain(feats.detach().float(), idx, found,
                                     w.detach().float(), dout)
    assert feats.grad.dtype == w.grad.dtype == torch.bfloat16
    assert torch.equal(feats.grad, df.bfloat16())
    assert torch.equal(w.grad, dw.bfloat16())


def test_mixed_trains_evaluates_and_serves(configs, tmp_path):
    """``train`` (two steps), ``evaluate`` of its checkpoint and
    ``pod_inference_from_checkpoint`` (rulebooks built on the device) run
    the bfloat16 twin on the CPU: the loss is finite, the KITTI table
    comes back, the served heads are finite float32."""
    mixed = configs[0]
    state = train.train(mixed, tmp_path / "m", max_steps=2, display_step=1,
                        device="cpu")
    assert state.step == 2
    result = train.evaluate(mixed, tmp_path / "m", device="cpu")
    assert "Car" in result["result_str"]
    pod = pod_inference_from_checkpoint(mixed, None, device="cpu",
                                        max_voxels=3000,
                                        max_points_per_voxel=5)
    assert pod.cfg.compute_dtype == "bfloat16"
    bundle = train.Bundle(mixed)
    prep_ds, _ = bundle.input_reader(training=False)
    pts = np.asarray(prep_ds.dataset.get_sensor_data(0)["lidar"]["points"],
                     np.float32)
    points = np.zeros((1, len(pts), 4), np.float32)
    points[0] = pts
    heads = pod.heads(points, np.array([len(pts)], np.int32))
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for v in heads.values())
    out = pod(points, np.array([len(pts)], np.int32))
    assert out["box3d_lidar"].shape[0] == 1
