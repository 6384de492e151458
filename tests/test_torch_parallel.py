"""The port's data parallelism on the CPU: two ranks over gloo, started
through ``parallel/launch.py`` (``spawn``, a ``file://`` rendezvous under
the test's temporary directory, one thread a rank).

This module imports JAX only inside its tests: the spawned ranks import
it for their bodies (``_rank_checks``, ``_rank_evaluate``), and a rank
must not load JAX.  One spawn runs every rank-side check and hands rank
0's results back; the tests hold them against the port's one-process
run and against the JAX package:

- the global BatchNorm statistics (``_FlaxBatchNorm`` in 1-D and 2-D,
  ``MaskedBatchNorm``), their outputs and gradients, against one process
  over the joined rows, in float64 (1e-12 of each tensor's max |x|);
- the data-parallel ``make_train_step`` against the one-process step on
  the joined batch, in float64, after one and after two steps
  (parameters, BatchNorm statistics and losses within 1e-9 of each
  tensor's max |x|);
- the same step in float32 against the JAX package's
  ``make_train_step(mesh=make_mesh(2))`` on two host devices, from the
  same weights and batch, with ``test_torch_train.py``'s rules;
- SECOND's key-match micro twin: the gradients and the middle's
  ``MaskedBatchNorm`` statistics of one data-parallel forward and
  backward against one process, in float64;
- ``make_sharded_mean_canvas`` against the JAX function on a 2-device
  mesh and against both packages' ``single_device_mean_canvas``
  (``tests/test_parallel.py``'s data shape and tolerances);
- sharded ``PodInference`` against unsharded (``tests/test_parallel.py``'s
  tolerances), with an even and an uneven request;
- ``evaluate(num_devices=2)`` against one device on three scenes (a
  short last batch leaves rank 0 no rows).

``train(num_devices=2)`` starts its own ranks and is held to ``train()``.
"""
import contextlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu_torch.builder import (
    input_reader_builder)
from automatic_as_built_reconstruction_tpu_torch.data import (
    batching, building)
from automatic_as_built_reconstruction_tpu_torch.models import (
    middle, pointpillars, voxelnet)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    PodInference, distributed, launch, sharded_voxelize)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    mesh as mesh_mod)
from automatic_as_built_reconstruction_tpu_torch.train import (
    checkpoint, train)
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

REPO = Path(__file__).resolve().parents[1]
TINY_CFG = (REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
            / "building" / "asbuilt_pillars_tiny.config")
# tests/test_train_runtime.py's micro config with the optimizer every
# shipped config sets (as tests/test_torch_train.py builds it), B = 2
MICRO_CONFIG = re.search(
    r'MICRO_CONFIG = """(.*?)"""',
    (REPO / "tests" / "test_train_runtime.py").read_text(), re.S).group(1)
MICRO_CONFIG = MICRO_CONFIG.replace(
    "learning_rate: { constant_learning_rate: { learning_rate: 0.001 } }\n"
    "    }",
    "learning_rate: { one_cycle: { lr_max: 0.002 div_factor: 10.0 "
    "pct_start: 0.4 } }\n      weight_decay: 0.01\n    }\n"
    "    fixed_weight_decay: true")
assert "fixed_weight_decay" in MICRO_CONFIG
DP_CONFIG = MICRO_CONFIG.replace("batch_size: 1", "batch_size: 2", 1)
TOTAL_STEPS = 40
RANKS = 2
F64_SHARE = 1e-9                     # DP vs one process, float64
BN_SHARE = 1e-12
LOSS_TOL = dict(rtol=1e-4, atol=0)   # test_torch_train.py's rules
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
G_NOISE = 1e-4
CANVAS = dict(voxel_size=(0.25, 0.25, 4.0), pc_range=(0, 0, 0, 16, 16, 4),
              grid_hw=(64, 64))
SHARD_POINTS = 4000
EVAL_SCENES = 3


@pytest.fixture
def one_thread():
    """One torch thread in this process while it starts ranks, so each
    rank takes one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def shortened_val_split(n):
    """The port's reader builds the synthetic val split (seed 7) with its
    first ``n`` scenes only."""
    mp = pytest.MonkeyPatch()
    mp.setattr(input_reader_builder, "_build_dataset",
               lambda ds, names, training: building.BuildingDataset(
                   class_names=names, num_synthetic=n, synthetic_seed=7))
    try:
        yield
    finally:
        mp.undo()


# --------------------------------------------------------------------------
# rank bodies (run in the spawned ranks: no JAX)
# --------------------------------------------------------------------------

def bn_inputs(seed: int = 0) -> dict:
    """Rows of both ranks joined (rank r owns the r-th half): inputs of a
    1-D (PFN-like) and a 2-D (RPN-like) ``_FlaxBatchNorm`` and of a
    ``MaskedBatchNorm`` with a mask, and the weights of a loss on each
    output, in float64."""
    rng = np.random.default_rng(seed)
    C = 5
    x1 = rng.normal(2.0, 3.0, (2 * 7, C))
    x2 = rng.normal(-1.0, 0.5, (2 * 2, C, 3, 4))
    xm = rng.normal(0.5, 2.0, (2 * 2, 6, C))
    mask = rng.random((2 * 2, 6)) < 0.6
    return {"x1": x1, "x2": x2, "xm": xm, "mask": mask,
            "w1": rng.normal(size=x1.shape), "w2": rng.normal(size=x2.shape),
            "wm": rng.normal(size=xm.shape)}


def bn_case(inputs: dict, mesh=None) -> dict:
    """The three BatchNorms in training mode on this rank's rows (all rows
    without ``mesh``); -> outputs, input gradients, parameter gradients
    (summed over the ranks) and running statistics."""
    torch.manual_seed(0)
    bn1 = pointpillars.FlaxBatchNorm1d(5, eps=pointpillars.BN_EPS,
                                       momentum=pointpillars.BN_MOMENTUM)
    bn2 = pointpillars.FlaxBatchNorm2d(5, eps=pointpillars.BN_EPS,
                                       momentum=pointpillars.BN_MOMENTUM)
    bnm = middle.MaskedBatchNorm(5)
    mods = torch.nn.ModuleList([bn1, bn2, bnm]).double().train()
    for m in mods:
        with torch.no_grad():
            m.weight.uniform_(0.5, 1.5)
            m.bias.uniform_(-0.5, 0.5)
    voxelnet.set_batch_norm_group(mods, None if mesh is None else mesh.group)
    mine = (inputs if mesh is None
            else mesh_mod.shard_batch(inputs, mesh))
    t = {k: torch.as_tensor(v) for k, v in mine.items()}
    xs = [t["x1"].requires_grad_(), t["x2"].requires_grad_(),
          t["xm"].requires_grad_()]
    ys = [bn1(xs[0]), bn2(xs[1]), bnm(xs[2], t["mask"])]
    loss = ((ys[0] * t["w1"]).sum() + (ys[1] * t["w2"]).sum()
            + (ys[2] * t["wm"]).sum())
    params = list(mods.parameters())
    grads = torch.autograd.grad(loss, xs + params)
    pgrads = list(grads[3:])
    if mesh is not None:
        pgrads = mesh_mod.all_reduce_sum(pgrads, mesh)
    out = {"y": [y.detach() for y in ys], "dx": list(grads[:3]),
           "dparams": pgrads,
           "stats": {k: v.clone() for k, v in mods.state_dict().items()}}
    if mesh is not None:    # every rank's rows, in rank order, on rank 0
        parts = mesh_mod.gather_objects({"y": out["y"], "dx": out["dx"]},
                                        mesh)
        if mesh.is_main:
            for k in ("y", "dx"):
                out[k] = [torch.cat([p[k][i] for p in parts])
                          for i in range(3)]
    return out


def dp_steps(cfg_path, variables, batches, dtype, mesh=None) -> dict:
    """``make_train_step`` from ``variables`` over ``batches`` (this rank's
    rows of each with ``mesh``), in ``dtype``; -> the loss and the state
    after each step."""
    bundle = train.Bundle(cfg_path)
    state = train.init_state(bundle, total_steps=TOTAL_STEPS, device="cpu")
    weight_import.load_variables(state.model, variables)
    state.model.to(dtype)
    step = train.make_train_step(bundle, mesh=mesh)
    losses, states = [], []
    for batch in batches:
        rows = batching.device_example(batch)
        if mesh is not None:
            rows = mesh_mod.shard_batch(rows, mesh)
        example = {k: v.to(dtype) if v.is_floating_point() else v
                   for k, v in train.to_device(rows, "cpu").items()}
        metrics = step(state, example)
        losses.append({k: float(metrics[k]) for k in
                       ("loss", "loss_cls", "loss_loc", "loss_dir",
                        "num_pos")})
        states.append({k: v.clone() for k, v in
                       state.model.state_dict().items()})
    return {"losses": losses, "states": states}


def second_grads(cfg_path, batch, mesh=None) -> dict:
    """The SECOND micro twin's loss terms, gradients and middle BatchNorm
    statistics of one forward in train mode, in float64 (this rank's rows
    with ``mesh``; the gradients of the joined batch)."""
    bundle = train.Bundle(cfg_path)
    state = train.init_state(bundle, total_steps=TOTAL_STEPS, device="cpu")
    model = state.model.to(torch.float64).train()
    voxelnet.set_batch_norm_group(model, None if mesh is None else mesh.group)
    rows = batch if mesh is None else mesh_mod.shard_batch(batch, mesh)
    example = {k: v.double() if v.is_floating_point() else v
               for k, v in train.to_device(rows, "cpu").items()}
    _, terms, grads = train.loss_and_grads(model, example, bundle.model_cfg,
                                           mesh)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("middle_feature_extractor") and "running" in k}
    voxelnet.set_batch_norm_group(model, None)
    return {"grads": {n: g for (n, _), g in
                      zip(model.named_parameters(), grads)},
            "stats": stats, "loss": float(terms["loss"].detach())}


def serving_inputs(B: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    Pn = 2000
    pts = np.concatenate([
        rng.uniform(0, 8, (B, Pn, 2)), rng.uniform(-0.2, 3.4, (B, Pn, 1)),
        rng.random((B, Pn, 1))], axis=-1).astype(np.float32)
    nv = rng.integers(Pn // 2, Pn + 1, B).astype(np.int32)
    return pts, nv


def micro_pod(cfg_path, variables, mesh=None) -> PodInference:
    """The micro config's network served with every box kept (score
    threshold 0), on the CPU or over ``mesh``."""
    import dataclasses
    bundle = train.Bundle(cfg_path)
    weight_import.load_variables(bundle.model, variables)
    anchors = bundle.target_assigner.generate_anchors(
        bundle.feature_map_size)["anchors"].reshape(-1, 7)
    cfg = dataclasses.replace(bundle.model_cfg, nms_score_threshold=0.0)
    return PodInference(bundle.model, cfg, anchors, device="cpu", mesh=mesh,
                        max_voxels=256, max_points_per_voxel=8)


def canvas_inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    n = RANKS * SHARD_POINTS
    pts = np.concatenate([
        rng.uniform(0, 16, (n, 1)), rng.uniform(0, 16, (n, 1)),
        rng.uniform(0, 3, (n, 1)), rng.random((n, 1))],
        axis=1).astype(np.float32)
    nv = np.full((RANKS,), SHARD_POINTS, np.int32)
    nv[1] = 1000     # one shard partly padded
    return pts, nv


def _rank_checks(mesh, cfg_path, variables, batches, second_cfg,
                 second_batch) -> dict:
    """Every rank-side check but ``evaluate``; -> rank 0's results."""
    out = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device)}
    # the torchrun-style helpers inside a group
    out["slice"] = distributed.local_batch_slice(4)
    try:
        distributed.local_batch_slice(3)
    except ValueError as e:
        out["odd_slice"] = str(e)
    out["bn"] = bn_case(bn_inputs(), mesh)
    out["f64"] = dp_steps(cfg_path, variables, batches, torch.float64, mesh)
    out["f32"] = dp_steps(cfg_path, variables, batches[:1], torch.float32,
                          mesh)
    out["second"] = second_grads(second_cfg, second_batch, mesh)
    # the ranks' losses sum to the joined batch's
    out["second"]["loss"] = mesh_mod.all_reduce_sum(
        [torch.tensor(out["second"]["loss"], dtype=torch.float64)],
        mesh)[0].item()
    pts, nv = canvas_inputs()
    fn = sharded_voxelize.make_sharded_mean_canvas(mesh, **CANVAS)
    out["canvas"] = fn(torch.as_tensor(pts), nv)
    pod = micro_pod(cfg_path, variables, mesh)
    out["serve"] = [pod(*serving_inputs(B)) for B in (4, 3)]
    return out


def _rank_evaluate(mesh, n_scenes: int) -> dict:
    """``evaluate(num_devices=2)`` run in place on a rank, on the first
    ``n_scenes`` val scenes."""
    with shortened_val_split(n_scenes):
        return train.evaluate(TINY_CFG, device="cpu", num_devices=2, seed=3)


# --------------------------------------------------------------------------
# the parent's side
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_cfg(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "micro_dp.config"
    p.write_text(DP_CONFIG)
    return p


@pytest.fixture(scope="module")
def jax_side(dp_cfg):
    """The JAX package on the B = 2 micro config: initial variables, two
    batches of its training reader, the gradients of the first, and its
    state after one data-parallel step on a 2-device mesh."""
    import jax

    from automatic_as_built_reconstruction_tpu.data import (
        batching as jax_batching)
    from automatic_as_built_reconstruction_tpu.models import (
        voxelnet as jax_voxelnet)
    from automatic_as_built_reconstruction_tpu.train import (
        train as jax_train)
    from jax.sharding import NamedSharding, PartitionSpec as P

    def np_tree(tree):
        return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)

    bundle = jax_train.Bundle(dp_cfg)
    _, loader = bundle.input_reader(training=True, seed=0)
    it = iter(loader)
    batches = [next(it) for _ in range(2)]
    state, tx = jax_train.init_state(bundle, rng_seed=0,
                                     total_steps=TOTAL_STEPS)
    init = np_tree({"params": state["params"],
                    "batch_stats": state["batch_stats"]})
    model, cfg = bundle.model, bundle.model_cfg

    @jax.jit
    def grads_fn(params, batch_stats, example):
        def loss_fn(p):
            preds, _ = model.apply(
                {"params": p, "batch_stats": batch_stats},
                example["voxels"], example["num_points"],
                example["coordinates"], train=True, mutable=["batch_stats"])
            return jax_voxelnet.compute_loss(preds, example, cfg)
        return jax.grad(loss_fn, has_aux=True)(params)

    ex = jax_train._to_device(jax_batching.device_example(batches[0]))
    grads, _ = grads_fn(state["params"], state["batch_stats"], ex)
    mesh = jax_train.make_mesh(2)
    step = jax_train.make_train_step(bundle, tx, mesh=mesh)
    dstate = jax.device_put(state, NamedSharding(mesh, P()))
    dstate, metrics = step(dstate, jax_train._to_device(
        jax_batching.device_example(batches[0]), mesh))
    after = np_tree({"params": dstate["params"],
                     "batch_stats": dstate["batch_stats"]})
    return {"init": init, "batches": batches, "grads": np_tree(grads),
            "after_one": after, "loss": float(metrics["loss"])}


@pytest.fixture(scope="module")
def second_cfg(tmp_path_factory):
    """car.fhd.config's micro twin (tests/test_torch_second_train.py's: 0.4
    m voxels in xy, 3000 voxels, B = 2) on a 6 + 2 frame synthetic KITTI
    clone, and its first training batch."""
    from automatic_as_built_reconstruction_tpu_torch.data import synth_kitti
    tmp = tmp_path_factory.mktemp("second")
    root = tmp / "clone"
    synth_kitti.write_clone(root, 6, 2, seed=0)
    text = (REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
            / "second" / "car" / "car.fhd.config").read_text()
    text = text.replace('"data/kitti', f'"{root}')
    for old, new in [("voxel_size: [0.05, 0.05, 0.1]",
                      "voxel_size: [0.4, 0.4, 0.1]"),
                     ("batch_size: 6", "batch_size: 2"),
                     ("max_number_of_voxels: 17000",
                      "max_number_of_voxels: 3000"),
                     ("max_number_of_voxels: 40000",
                      "max_number_of_voxels: 3000")]:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp / "car.fhd.micro.config"
    path.write_text(text)
    _, loader = train.Bundle(path).input_reader(training=True, seed=0)
    return path, batching.device_example(next(iter(loader)))


@pytest.fixture(scope="module")
def ranks(dp_cfg, jax_side, second_cfg):
    """One spawn of two CPU ranks running ``_rank_checks``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return launch.spawn(_rank_checks, RANKS, ["cpu"] * RANKS, args=(
            dp_cfg, jax_side["init"], jax_side["batches"], *second_cfg))
    finally:
        torch.set_num_threads(n)


def max_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| as a share of max |want| (of 1 where it is 0)."""
    scale = float(want.abs().max()) or 1.0
    return float((got.double() - want.double()).abs().max()) / scale


def test_ranks_join_over_gloo_and_slice_the_batch(ranks):
    assert ranks["rank"] == 0 and ranks["backend"] == "gloo"
    assert ranks["device"] == "cpu"
    assert ranks["slice"] == slice(0, 2)
    assert "not divisible by 2 processes" in ranks["odd_slice"]


def test_global_batch_norm_statistics_and_gradients(ranks):
    """``_FlaxBatchNorm`` (1-D and 2-D) and ``MaskedBatchNorm`` over two
    ranks: outputs, input and parameter gradients and running statistics
    of one process over the joined rows."""
    got, want = ranks["bn"], bn_case(bn_inputs())
    for k in ("y", "dx", "dparams"):
        for i, (g, w) in enumerate(zip(got[k], want[k])):
            assert g.shape == w.shape, (k, i)
            assert max_share(g, w) <= BN_SHARE, (k, i, max_share(g, w))
    for name, w in want["stats"].items():
        if w.is_floating_point():
            assert max_share(got["stats"][name], w) <= BN_SHARE, name
            # the running statistics moved
            assert not torch.equal(w, torch.zeros_like(w)), name
        else:
            assert torch.equal(got["stats"][name], w), name


def test_dp_step_equals_one_process_step_in_float64(ranks, dp_cfg,
                                                    jax_side):
    """Two data-parallel steps against the one-process steps on the
    joined batches: losses, parameters and BatchNorm statistics."""
    want = dp_steps(dp_cfg, jax_side["init"], jax_side["batches"],
                    torch.float64)
    got = ranks["f64"]
    assert len(got["states"]) == 2
    for s in range(2):
        for k, w in want["losses"][s].items():
            assert abs(got["losses"][s][k] - w) <= F64_SHARE * abs(w), (s, k)
        for name, w in want["states"][s].items():
            g = got["states"][s][name]
            if not w.is_floating_point():
                assert torch.equal(g, w), name
                continue
            assert g.dtype == torch.float64, name
            assert max_share(g, w) <= F64_SHARE, (s, name, max_share(g, w))
    # the step moved the weights and the statistics
    first = want["states"][0]
    assert any(not torch.equal(first[n], want["states"][1][n])
               for n in first)


def test_second_dp_gradients_equal_one_process_in_float64(ranks,
                                                         second_cfg):
    """SECOND's key-match middle (``MaskedBatchNorm`` on sparse rows)
    over two ranks: the loss, every gradient and the middle's running
    statistics of the joined batch."""
    want = second_grads(*second_cfg)
    got = ranks["second"]
    assert abs(got["loss"] - want["loss"]) <= F64_SHARE * abs(want["loss"])
    assert len(want["stats"]) > 0
    for kind in ("grads", "stats"):
        for name, w in want[kind].items():
            assert max_share(got[kind][name], w) <= F64_SHARE, (kind, name)


def test_dp_step_matches_the_jax_two_device_step(ranks, jax_side, dp_cfg):
    """The port's data-parallel float32 step against the JAX package's
    ``make_train_step(mesh=make_mesh(2))`` from the same weights and
    batch: the loss, the parameters after the update and the BatchNorm
    statistics, with ``test_one_train_step_matches_jax``'s rules."""
    from automatic_as_built_reconstruction_tpu.utils import (
        weight_import as jax_weight_import)

    got = ranks["f32"]
    np.testing.assert_allclose(got["losses"][0]["loss"], jax_side["loss"],
                               **LOSS_TOL)
    grads = jax_weight_import.to_torch_state_dict(
        {"params": jax_side["grads"],
         "batch_stats": jax_side["init"]["batch_stats"]})
    want = jax_weight_import.to_torch_state_dict(jax_side["after_one"])
    state = got["states"][0]
    lr = train.init_state(train.Bundle(dp_cfg), total_steps=TOTAL_STEPS,
                          device="cpu").schedule(0)
    excused = 0
    for name, w in want.items():
        g = state[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, **PARAM_TOL, err_msg=name)
            continue
        noise = np.abs(grads[name]) < G_NOISE * np.abs(grads[name]).max()
        excused += int((noise & ~np.isclose(g, w, **PARAM_TOL)).sum())
        np.testing.assert_allclose(g[~noise], w[~noise], **PARAM_TOL,
                                   err_msg=name)
        # a sign flip of a near-zero gradient moves Adam's first step by
        # at most 2 * lr
        assert np.abs(g - w).max() <= 2 * lr * 1.01, name
    print(f"{excused} parameter elements with |g| < {G_NOISE} * max|g| "
          f"differ beyond {PARAM_TOL}")


def test_sharded_mean_canvas_matches_jax_and_the_oracle(ranks):
    import jax.numpy as jnp

    from automatic_as_built_reconstruction_tpu.parallel import (
        data_parallel_mesh as jax_mesh)
    from automatic_as_built_reconstruction_tpu.parallel import (
        sharded_voxelize as jax_sv)

    mean, cnt = (t.numpy() for t in ranks["canvas"])
    pts, nv = canvas_inputs()
    jmean, jcnt = jax_sv.make_sharded_mean_canvas(jax_mesh(RANKS), **CANVAS)(
        jnp.asarray(pts), jnp.asarray(nv))
    mask = np.zeros(len(pts), bool)
    for d in range(RANKS):
        mask[d * SHARD_POINTS: d * SHARD_POINTS + nv[d]] = True
    omean, ocnt = sharded_voxelize.single_device_mean_canvas(
        torch.as_tensor(pts[mask]), int(mask.sum()), **CANVAS)
    jomean, jocnt = jax_sv.single_device_mean_canvas(
        jnp.asarray(pts[mask]), jnp.int32(mask.sum()), **CANVAS)
    for m, c in ((jmean, jcnt), (omean, ocnt), (jomean, jocnt)):
        np.testing.assert_array_equal(cnt, np.asarray(c))
        np.testing.assert_allclose(mean, np.asarray(m), rtol=1e-5, atol=1e-6)
    assert cnt.sum() == mask.sum() and cnt.shape == (64, 64)


def test_sharded_serving_equals_unsharded(ranks, dp_cfg, jax_side):
    """Each rank serves its rows (2 + 2, then 1 + 2 of an uneven request)
    and every rank answers with the whole batch."""
    pod = micro_pod(dp_cfg, jax_side["init"])
    for B, got in zip((4, 3), ranks["serve"]):
        want = pod(*serving_inputs(B))
        assert got["scores"].shape[0] == B
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_allclose(got["scores"], want["scores"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["box3d_lidar"], want["box3d_lidar"],
                                   rtol=1e-4, atol=1e-5)
        assert want["valid"].any()


def test_evaluate_over_two_ranks_gives_the_one_device_result(one_thread):
    got = launch.spawn(_rank_evaluate, RANKS, ["cpu"] * RANKS,
                       args=(EVAL_SCENES,))
    with shortened_val_split(EVAL_SCENES):
        want = train.evaluate(TINY_CFG, device="cpu", seed=3)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k.endswith("num_gt"):
            assert got[k] == w, k
        else:
            assert abs(got[k] - w) <= 1e-4, (k, got[k], w)
    assert want["wall.bev.num_gt"] > 50


def test_train_over_two_ranks_matches_one_process(dp_cfg, tmp_path,
                                                  one_thread):
    """``train(num_devices=2)`` starts its own ranks; rank 0 alone logs and
    writes the checkpoints; the caller gets the final state, which is
    ``train()``'s after the same steps (``tests/test_train_runtime.py``'s
    DP tolerances)."""
    dp = train.train(dp_cfg, tmp_path / "dp", max_steps=2, display_step=1,
                     num_devices=2, device="cpu")
    one = train.train(dp_cfg, tmp_path / "one", max_steps=2, display_step=1,
                      device="cpu")
    assert dp.step == one.step == 2
    for name, w in one.model.state_dict().items():
        np.testing.assert_allclose(dp.model.state_dict()[name].numpy(),
                                   w.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)

    def losses(run):
        lines = [json.loads(x) for x in
                 (tmp_path / run / "metrics.jsonl").read_text().splitlines()]
        return [x["loss"] for x in lines if x["prefix"] == "train"]

    assert len(losses("dp")) == 2
    np.testing.assert_allclose(losses("dp"), losses("one"), rtol=1e-5)
    log = (tmp_path / "dp" / "log.txt").read_text()
    assert "data-parallel training over 2 ranks (gloo)" in log
    assert log.count("training finished at step 2") == 1
    assert checkpoint.CheckpointManager(tmp_path / "dp").all_steps() == [2]


def test_train_refuses_a_batch_the_ranks_cannot_share(tmp_path):
    cfg = tmp_path / "odd.config"
    cfg.write_text(MICRO_CONFIG.replace("batch_size: 1", "batch_size: 3", 1))
    with pytest.raises(ValueError, match="not divisible"):
        train.train(cfg, tmp_path / "bad", max_steps=1, num_devices=2,
                    device="cpu")
    assert not (tmp_path / "bad").exists()


class TestDistributedHelpers:
    """``tests/test_parallel.py``'s helper tests with torchrun's
    variables."""

    def test_single_host_noop(self, monkeypatch):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        assert distributed.multi_host_env() is None
        assert distributed.ensure_initialized() is False

    def test_env_detection(self, monkeypatch):
        monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1234")
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("RANK", "2")
        monkeypatch.setenv("LOCAL_RANK", "0")
        assert distributed.multi_host_env() == {
            "init_method": "tcp://10.0.0.1:1234", "world_size": 4,
            "rank": 2, "local_rank": 0}

    def test_local_batch_slice(self):
        s = distributed.local_batch_slice(8)   # single process -> all
        assert (s.start, s.stop) == (0, 8)

    def test_devices_and_backend(self, monkeypatch):
        assert mesh_mod.rank_devices(2, device="cpu") == [
            torch.device("cpu")] * 2
        assert mesh_mod.choose_backend(["cpu", "cpu"]) == "gloo"
        assert mesh_mod.choose_backend(["cuda:0", "cuda:0"]) == "gloo"
        assert mesh_mod.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="only 1 visible"):
            mesh_mod.rank_devices(2)
        with pytest.raises(ValueError, match="3 devices given for 2"):
            mesh_mod.rank_devices(2, ["cpu"] * 3)
        assert [mesh_mod.rank_rows(3, r, 2) for r in range(2)] == [
            slice(0, 1), slice(1, 3)]
