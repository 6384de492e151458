"""bfloat16 pillars (``asbuilt_pillars.config`` with
``enable_mixed_precision``): K1 on bfloat16 rows, the port's bfloat16
pillar network, and the trained checkpoint served and evaluated in
bfloat16, each held to the JAX package on the CPU.

- K1: the port's scatter (its plain version on the CPU) against the JAX
  package's ``scatter_sorted_to_canvas`` in interpret mode, bit for bit;
  its gradient (the gather) against the autodiff of the JAX package's
  XLA scatter, the one its training path differentiates (the Pallas
  kernel has no autodiff), bit for bit.
- The network (train mode, the micro config of ``tests/test_train_runtime
  .py`` with the flag) and the trained checkpoint at full width on one
  val scene: bfloat16 rounds at other places in the two frameworks, so
  each head and the gradients (worst and median tensor, each as a share
  of its tensor's max |g| in the JAX float32 step) must lie within
  ``BF16_MARGIN`` = twice the JAX package's own bfloat16-vs-float32
  distance on the same input from the same weights, as
  ``tests/test_torch_mixed.py`` holds SECOND; each loss term, one scalar,
  on each of the first LOSS_BATCHES batches within twice that distance
  at its largest over the batches, and in root mean square over them
  (``hold_loss_terms``).  The flat (point-major) PFN likewise against
  the JAX flat branch.
- ``evaluate`` of the trained checkpoint in bfloat16 on the first four
  val scenes: every AP within max(|AP_jax_bf16 - AP_jax_f32|, 0.01) of
  the JAX package's bfloat16 AP, every num_gt equal.
"""
import dataclasses
import functools
import itertools
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.data import (
    batching as jax_batching)
from automatic_as_built_reconstruction_tpu.models.voxelnet import (
    VoxelNet as JaxVoxelNet)
from automatic_as_built_reconstruction_tpu.ops import voxelize_jax
from automatic_as_built_reconstruction_tpu.ops.pallas import (
    pillar_scatter as jax_pillar_scatter)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu_torch.data.building import (
    generate_building_scene, pad_batch)
from automatic_as_built_reconstruction_tpu_torch.models import voxelnet
from automatic_as_built_reconstruction_tpu_torch.ops import (
    pillar_scatter, voxelize)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    pod_inference_from_checkpoint)
from automatic_as_built_reconstruction_tpu_torch.train import train
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

from test_torch_eval import shortened_val_split
from test_torch_mixed import (BF16_MARGIN, HEADS, _grad_distances,
                              _head_distance, _jax_steps, _np_tree)
from test_torch_train import MICRO_CONFIG

REPO = Path(__file__).resolve().parents[1]
PORT_CFG = (REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
            / "building")
CKPT = REPO / "artifacts" / "asbuilt_r2_step8000.pkl"
VAL_SCENE = 7 * 100003          # the first val scene (synthetic seed 7)
MIN_AP_MARGIN = 0.01
LOSS_BATCHES = 16               # batches whose loss terms are held


def mixed(text: str) -> str:
    """A config's text with ``enable_mixed_precision: true``."""
    assert "train_config: {" in text and "mixed_precision" not in text
    return text.replace("train_config: {",
                        "train_config: {\n  enable_mixed_precision: true", 1)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """(bf16 micro, float32 micro, bf16 asbuilt_pillars) config files."""
    tmp = tmp_path_factory.mktemp("mixed_pillars")
    paths = []
    for name, text in (("micro.mixed", mixed(MICRO_CONFIG)),
                       ("micro.f32", MICRO_CONFIG),
                       ("asbuilt_pillars.mixed", mixed(
                           (PORT_CFG / "asbuilt_pillars.config")
                           .read_text()))):
        paths.append(tmp / f"{name}.config")
        paths[-1].write_text(text)
    return paths


# --------------------------------------------------------------------------
# K1 on bfloat16 rows
# --------------------------------------------------------------------------

def test_k1_bf16_forward_and_backward_equal_jax():
    """K1 on bfloat16 rows (sorted ids, padding ids >= hw): the canvas
    bit for bit against the JAX kernel in interpret mode, and the rows'
    gradient bit for bit against the autodiff of the JAX XLA scatter,
    through the port's function and autograd alike."""
    rng = np.random.default_rng(11)
    V, C, hw = 700, 64, 48 * 40
    lin = np.concatenate([np.sort(rng.choice(hw, 600, replace=False)),
                          np.full(V - 600, hw)]).astype(np.int32)
    feats = rng.normal(size=(V, C)).astype(np.float32)
    dcanvas = rng.normal(size=(hw, C)).astype(np.float32)
    jf = jnp.asarray(feats, jnp.bfloat16)
    ref = jax_pillar_scatter.scatter_sorted_to_canvas(
        jf, jnp.asarray(lin), hw=hw, interpret=True)
    assert ref.dtype == jnp.bfloat16
    tf = torch.from_numpy(feats).bfloat16()
    tlin = torch.from_numpy(lin)
    got = pillar_scatter.scatter_sorted_to_canvas(tf[None], tlin[None], hw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  np.asarray(ref, np.float32))

    _, vjp = jax.vjp(lambda x: jax_pillar_scatter.scatter_to_canvas_xla(
        x, jnp.asarray(lin), hw), jf)
    (want,) = vjp(jnp.asarray(dcanvas, jnp.bfloat16))
    tdc = torch.from_numpy(dcanvas).bfloat16()[None]
    back = pillar_scatter.pillar_gather(tdc, tlin[None])
    leaf = tf[None].clone().requires_grad_()
    pillar_scatter.scatter_sorted_to_canvas(leaf, tlin[None], hw).backward(
        tdc)
    for g in (back, leaf.grad):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g[0].float().numpy(),
                                      np.asarray(want, np.float32))
    assert bool((back[0, 600:] == 0).all()) and bool(back[0, :600].any())


# --------------------------------------------------------------------------
# the bf16 pillar network, one training forward + backward
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(configs):
    """The first LOSS_BATCHES training batches of the bf16 micro config,
    and one training forward + backward on the first from the JAX
    package's initial weights: the JAX bf16 and float32 runs and the
    port's bf16 and float32 runs; on every batch, the loss terms of the
    JAX bf16 and float32 forward and the port's bf16 forward."""
    mixed_cfg, f32_cfg, _ = configs
    bundle = train.Bundle(mixed_cfg)
    assert bundle.model_cfg.compute_dtype == "bfloat16"
    _, loader = bundle.input_reader(training=True, seed=0)
    batches = list(itertools.islice(iter(loader), LOSS_BATCHES))
    jmodel = jax_train.Bundle(mixed_cfg).model
    init = _np_tree(jax.jit(functools.partial(jmodel.init, train=True))(
        jax.random.key(0), np.zeros((1, 64, 5, 4), np.float32),
        np.zeros((1, 64), np.int32), np.full((1, 64, 3), -1, np.int32)))
    return port_and_jax_steps((mixed_cfg, f32_cfg), (mixed_cfg, f32_cfg),
                              init, batches)


def port_and_jax_steps(port_cfgs, jax_cfgs, init, batches) -> dict:
    """``runs`` from the (bf16, float32) configs of each package, the JAX
    initial weights and the batches: {"jax_bf16" | "jax_f32" |
    "port_bf16" | "port_f32": (heads, terms, gradients) of the first
    batch, ("preds", port run): its heads, ("terms", run): [terms of each
    batch]} (the port's float32 run on the first batch only, a forward:
    its gradients None)."""
    examples = [jax_train._to_device(jax_batching.device_example(b))
                for b in batches]
    out = {}
    for name, path in zip(("jax_bf16", "jax_f32"), jax_cfgs):
        steps = _jax_steps(path, init, examples)
        out[name] = steps[0]
        out["terms", name] = [terms for _, terms, _ in steps]
    exs = [train.to_device(b, "cpu") for b in batches]
    for name, path, n in zip(("port_bf16", "port_f32"), port_cfgs,
                             (len(exs), 1)):
        b = train.Bundle(path)
        model = b.model
        weight_import.load_variables(model, init)
        model.train()                  # BatchNorm on each batch's statistics
        # the float32 run's loss terms alone are held: no backward
        with torch.set_grad_enabled(name == "port_bf16"):
            preds = train.forward(model, exs[0], b.model_cfg)
            loss, terms = voxelnet.compute_loss(preds, exs[0], b.model_cfg)
        grads = None
        if name == "port_bf16":
            loss.backward()
            grads = {n: p.grad.numpy()
                     for n, p in model.named_parameters()}
        out[name] = (
            {k: v.detach().permute(0, 2, 3, 1).numpy()
             for k, v in preds.items()},
            {k: float(v.detach()) for k, v in terms.items()}, grads)
        out["preds", name] = preds
        out["terms", name] = [out[name][1]]
        with torch.no_grad():
            for ex in exs[1:n]:
                _, terms = voxelnet.compute_loss(
                    train.forward(model, ex, b.model_cfg), ex, b.model_cfg)
                out["terms", name].append(
                    {k: float(v) for k, v in terms.items()})
    return out


def hold_loss_terms(runs) -> None:
    """Each loss term of the port's bf16 forward against the JAX bf16
    forward, on every batch within ``BF16_MARGIN`` x the JAX package's own
    bf16-vs-float32 distance at its largest over the batches, and in root
    mean square over the batches within ``BF16_MARGIN`` x the JAX
    package's own in root mean square.  A loss term is one scalar, and its
    bf16 rounding errors may cancel by chance on one batch, so one
    batch's distance is no measure of them; a fault that moves a term
    moves it on every batch.  The port's float32 terms equal the JAX
    package's (rtol 1e-4)."""
    tpf, t32 = runs["port_f32"][1], runs["jax_f32"][1]
    for k in t32:
        np.testing.assert_allclose(tpf[k], t32[k], rtol=1e-4, err_msg=k)
    tp, tb, t32 = (runs["terms", n] for n in ("port_bf16", "jax_bf16",
                                              "jax_f32"))
    assert len(tp) == len(tb) == len(t32) > 1
    def rms(x):
        return float(np.sqrt(np.mean(np.square(x))))

    for k in t32[0]:
        own = [abs(b[k] - f[k]) for b, f in zip(tb, t32)]
        got = [abs(p[k] - b[k]) for p, b in zip(tp, tb)]
        print(f"{k}: port bf16 vs JAX bf16 by batch "
              f"{[f'{g:.3g}' for g in got]} (rms {rms(got):.3g}); JAX bf16 "
              f"vs JAX float32 {[f'{o:.3g}' for o in own]} (rms "
              f"{rms(own):.3g})")
        assert max(got) <= BF16_MARGIN * max(own), (k, got, own)
        assert rms(got) <= BF16_MARGIN * rms(own), (k, got, own)


def test_mixed_pillar_heads_match_jax_bf16(runs):
    """Each head of the port's bf16 pillar forward (train mode) against
    the JAX package's bf16 forward, within twice the JAX bf16-vs-float32
    distance (share of the head's max |x|); heads back in float32."""
    port, jbf, j32 = (runs[k][0] for k in ("port_bf16", "jax_bf16",
                                            "jax_f32"))
    for k in HEADS:
        assert runs["preds", "port_bf16"][k].dtype == torch.float32
        got, own = _head_distance(port, jbf, k), _head_distance(jbf, j32, k)
        print(f"{k}: port bf16 vs JAX bf16 {got:.4g}; JAX bf16 vs JAX "
              f"float32 {own:.4g}")
        assert np.isfinite(port[k]).all()
        assert 0 < got <= BF16_MARGIN * own, (k, got, own)


def test_mixed_pillar_step_matches_jax_bf16(runs):
    """One bf16 pillar step: the gradients (worst and median tensor;
    every PFN gradient nonzero) against the JAX bf16 step within twice the
    JAX bf16-vs-float32 distance; the loss terms as
    :func:`hold_loss_terms` holds them (loss_cls on the first batch is
    3.9e-4 from float32 in the JAX package and 1.0e-3 from the JAX bf16
    run in the port, while the float32 runs agree to 1.2e-7)."""
    _, _, gp = runs["port_bf16"]
    _, _, gb = runs["jax_bf16"]
    _, _, g32 = runs["jax_f32"]
    hold_loss_terms(runs)
    assert set(gp) <= set(gb)
    got = _grad_distances(gp, gb, {n: g32[n] for n in gp})
    own = _grad_distances(gb, g32, {n: g32[n] for n in gp})
    print(f"gradients (worst, median share of max |g|): port bf16 vs JAX "
          f"bf16 {got}; JAX bf16 vs JAX float32 {own}")
    assert got[0] <= BF16_MARGIN * own[0]
    assert got[1] <= BF16_MARGIN * own[1]
    assert all(np.isfinite(g).all() for g in gp.values())
    assert all(np.abs(g).max() > 0 for n, g in gp.items()
               if n.startswith("voxel_feature_extractor"))


def test_pillar_network_computes_in_bf16(configs):
    """The PFN's output and the canvas are bfloat16 (the canvas is K1's),
    every head comes back float32, parameters and BatchNorm statistics
    stay float32; float16 stays refused."""
    bundle = train.Bundle(configs[0])
    model = bundle.model.eval()
    assert model.voxel_feature_extractor.dtype == torch.bfloat16
    _, loader = bundle.input_reader(training=False)
    ex = train.to_device(next(iter(loader)), "cpu")
    with torch.no_grad():
        preds, stages = model(ex["voxels"], ex["num_points"],
                              ex["coordinates"], return_stages=True)
    assert stages["voxel_features"].dtype == torch.bfloat16
    assert stages["spatial_features"].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in preds.values())
    assert all(t.dtype == torch.float32 for t in model.state_dict().values()
               if t.is_floating_point())
    with pytest.raises(NotImplementedError):
        voxelnet.VoxelNet(dataclasses.replace(bundle.model_cfg,
                                              compute_dtype="float16"))


# --------------------------------------------------------------------------
# the trained checkpoint in bf16, full width
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def variables():
    with open(CKPT, "rb") as f:
        return pickle.load(f)


def _jax_voxels(cfg, pts, nv, flat: bool):
    """The JAX package's device voxelization of one request (padded, or
    point-major for the flat PFN), at the served caps."""
    kw = dict(voxel_size=cfg.voxel_size, pc_range=cfg.pc_range,
              grid_size=cfg.grid_size, max_points=24, max_voxels=25600,
              first_appearance=False)
    fn = voxelize_jax.voxelize_flat if flat else voxelize_jax.voxelize
    return jax.vmap(lambda p, n: fn(p, n, **kw))(jnp.asarray(pts),
                                                 jnp.asarray(nv))


def _jax_stages(cfg, variables, vox, flat: bool):
    """The JAX package's network on a voxelization: (heads NHWC float32,
    voxel features float32)."""
    model = JaxVoxelNet(cfg=cfg)
    if flat:
        preds, stages = jax.jit(lambda v, *a: model.apply(
            v, None, a[0], a[1], train=False, return_stages=True,
            flat_points=a[2], flat_slot=a[3]))(
                variables, vox.num_points, vox.coords, vox.points, vox.slot)
    else:
        preds, stages = jax.jit(lambda v, *a: model.apply(
            v, *a, train=False, return_stages=True))(
                variables, vox.voxels, vox.num_points, vox.coords)
    return ({k: np.asarray(preds[k], np.float32) for k in HEADS},
            np.asarray(stages["voxel_features"], np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def served(configs, variables):
    """One val scene through the trained checkpoint at full width: the
    JAX package's bf16 and float32 networks on its voxelization (padded
    and flat), the port's bf16 network on the same voxelizations, and the
    port's bf16 ``PodInference`` heads (its own voxelization)."""
    path = configs[2]
    jcfg = jax_train.Bundle(path).model_cfg
    assert jcfg.compute_dtype == "bfloat16"
    pts, nv = pad_batch([generate_building_scene(VAL_SCENE)])
    vox = {flat: _jax_voxels(jcfg, pts, nv, flat) for flat in (False, True)}
    out = {}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(jcfg, compute_dtype=dt)
        for flat in (False, True):
            out["jax", flat, dt] = _jax_stages(c, variables, vox[flat], flat)
    pod = pod_inference_from_checkpoint(path, CKPT, device="cpu",
                                        max_voxels=25600,
                                        max_points_per_voxel=24)
    assert pod.cfg.compute_dtype == "bfloat16"
    heads = pod.heads(pts, nv)
    out["pod"] = {k: v.permute(0, 2, 3, 1).numpy() for k, v in heads.items()}
    out["pod_dtypes"] = {v.dtype for v in heads.values()}
    with torch.no_grad():
        v = vox[False]
        out["port", False] = pod.model(
            _t(v.voxels), _t(v.num_points), _t(v.coords),
            return_stages=True)
        v = vox[True]
        out["port", True] = pod.model(
            None, _t(v.num_points), _t(v.coords), return_stages=True,
            flat_points=_t(v.points), flat_slot=_t(v.slot))
    return out


def _nhwc(preds):
    return {k: v.permute(0, 2, 3, 1).numpy() for k, v in preds.items()}


def test_checkpoint_served_in_bf16_matches_jax_bf16(served):
    """The trained checkpoint served in bf16 (``PodInference.heads``, the
    port's own voxelization) on the first val scene: each head within
    twice the JAX bf16-vs-float32 distance of the JAX bf16 network's;
    float32 heads."""
    assert served["pod_dtypes"] == {torch.float32}
    jbf = served["jax", False, "bfloat16"][0]
    j32 = served["jax", False, "float32"][0]
    for k in HEADS:
        got = _head_distance(served["pod"], jbf, k)
        own = _head_distance(jbf, j32, k)
        print(f"{k}: port bf16 vs JAX bf16 {got:.4g}; JAX bf16 vs JAX "
              f"float32 {own:.4g}")
        assert got <= BF16_MARGIN * own, (k, got, own)


@pytest.mark.parametrize("flat", [False, True], ids=["padded", "flat"])
def test_bf16_pfn_matches_jax_bf16(served, flat):
    """The padded and the flat PFN in bf16 (the flat one in segment-ops
    form, the empty-pillar floor 0) on the JAX voxelization: the bf16
    pillar features and the heads against the JAX bf16 network's, within
    twice the JAX package's own bf16-vs-float32 distance.  (On the port's
    own voxelization one face point, y = 6.7999997 m, falls into the
    neighbouring pillar: IEEE division against XLA's CPU division, the
    same in float32; the heads above absorb it.)"""
    preds, stages = served["port", flat]
    vf = stages["voxel_features"]
    assert vf.dtype == stages["spatial_features"].dtype == torch.bfloat16
    jbf, j32 = served["jax", flat, "bfloat16"], served["jax", flat, "float32"]
    heads = _nhwc(preds)
    for k in HEADS:
        got = _head_distance(heads, jbf[0], k)
        own = _head_distance(jbf[0], j32[0], k)
        print(f"{k}: port bf16 vs JAX bf16 {got:.4g}; JAX bf16 vs JAX "
              f"float32 {own:.4g}")
        assert got <= BF16_MARGIN * own, (k, got, own)
    got = float(np.abs(vf.float().numpy() - jbf[1]).max())
    own = float(np.abs(jbf[1] - j32[1]).max())
    print(f"voxel features: port vs JAX bf16 {got:.4g}; JAX bf16 vs "
          f"float32 {own:.4g}")
    assert got <= BF16_MARGIN * own


@pytest.fixture(scope="module")
def four_scenes_ap(configs, variables, tmp_path_factory):
    """``evaluate`` of the trained checkpoint on the first four val
    scenes: the port in bf16, the JAX package in bf16 and in float32."""
    path = configs[2]
    f32 = tmp_path_factory.mktemp("f32") / "asbuilt_pillars.config"
    f32.write_text((PORT_CFG / "asbuilt_pillars.config").read_text())
    with shortened_val_split(4):
        port = train.evaluate(path, variables=variables, device="cpu")
        jax_ap = {dt: jax_train.evaluate(
            None, None, bundle=jax_train.Bundle(p), state=variables)
            for dt, p in (("bfloat16", path), ("float32", f32))}
    return port, jax_ap


def test_evaluate_in_bf16_four_scenes_ap_matches_jax_bf16(four_scenes_ap):
    port, jax_ap = four_scenes_ap
    jbf, j32 = jax_ap["bfloat16"], jax_ap["float32"]
    assert sorted(port) == sorted(jbf) == sorted(j32)
    for k, want in jbf.items():
        if k.endswith("num_gt"):
            assert port[k] == want == j32[k], k
            continue
        tol = max(abs(want - j32[k]), MIN_AP_MARGIN)
        print(f"{k}: port bf16 {port[k]:.6f} JAX bf16 {want:.6f} JAX "
              f"float32 {j32[k]:.6f}")
        assert abs(port[k] - want) <= tol, (k, port[k], want, tol)
