"""Host-rulebook SECOND (``people.fhd``, ``car.lite``): the port's
host-built sparse rulebooks, examples, middle and training step, held to
the JAX package on the CPU.

- Rulebooks: the port's native builder (``csrc/rulebook_host.cpp``, built
  with g++ at first use) and its numpy twins equal the JAX package's
  ``ops/rulebook_host.py`` (its native library) bit for bit, on random
  sites at the people.fhd, car.lite and car.fhd grids, for every block
  kind (3x3x3 with submanifold layers in one native call, the z-only
  (3,1,1) strided kernel, ``n_subm == 0``) and with ``max_out``
  truncation; and they equal the port's device merge builders integer for
  integer where a tap is found.
- Examples: the training and eval readers of micro twins give the JAX
  readers' examples key for key (``rb*`` included), bit for bit, on
  synthetic KITTI clone frames; the loader's thread and process pools
  carry them unchanged.
- Middle: a ``SparseMiddle`` twin on host rulebooks, plain and
  ``gather_gemm`` forms, against the JAX module on the same rulebooks:
  rtol / atol 1e-4 (float32 sums in another order).
- Training step: the port's people.fhd micro step in float64 against the
  JAX package's step run in float64 on the same host rulebooks: loss
  terms rtol 1e-10, every gradient within 1e-10 of its tensor's max |g|.
- The command line trains and evaluates the people.fhd micro twin.

The micro twins keep each config's plan, widths, sampler groups and
augmentation; they are cut in the voxels' xy size (people.fhd: 0.2 m for
0.05 m, a 264 x 320 x 40 grid; car.lite: 0.4 m for 0.1 m), in
``max_number_of_voxels`` (3000) and the batch (B = 2).
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.data import (
    batching as jax_batching)
from automatic_as_built_reconstruction_tpu.models import (
    middle as jax_middle, middle_plans as jax_plans, voxelnet as jax_voxelnet)
from automatic_as_built_reconstruction_tpu.ops import (
    rulebook_host as jax_rh, sparse_conv as jax_sc)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu.utils import (
    weight_import as jax_weight_import)
from automatic_as_built_reconstruction_tpu_torch import cli
from automatic_as_built_reconstruction_tpu_torch.data import (
    batching, synth_kitti)
from automatic_as_built_reconstruction_tpu_torch.models import (
    middle, voxelnet)
from automatic_as_built_reconstruction_tpu_torch.ops import (
    _build, rulebook_host, sparse_conv as sc, sparse_gather_gemm as sgg)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    pod_inference_from_checkpoint)
from automatic_as_built_reconstruction_tpu_torch.train import (
    input_pipeline, train)
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

from test_torch_kitti import assert_same_tree, kitti_config
from test_torch_multiclass import F64_MODULES
from test_torch_kitti_pillars import _Float64Numpy
from test_torch_sparse_middle import load_middle, seeded_variables
from test_torch_train_data import assert_same

REPO = Path(__file__).resolve().parents[1]
SECOND = REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs" \
    / "second"
PEOPLE = SECOND / "people.fhd.config"
LITE = SECOND / "car" / "car.lite.config"
CAR_FHD = SECOND / "car" / "car.fhd.config"
MIXED = SECOND / "car" / "car.fhd.mixed.config"
MIDDLE_TOL = dict(rtol=1e-4, atol=1e-4)
F64_LOSS_TOL = dict(rtol=1e-10, atol=0)
F64_GRAD_SHARE = 1e-10

# micro twins: xy voxel size, voxel cap, batch, a lower score threshold
PEOPLE_MICRO = {
    "voxel_size: [0.05, 0.05, 0.1]": "voxel_size: [0.2, 0.2, 0.1]",
    "batch_size: 6": "batch_size: 2",
    "max_number_of_voxels: 17000": "max_number_of_voxels: 3000",
    "max_number_of_voxels: 40000": "max_number_of_voxels: 3000",
    "nms_score_threshold: 0.2": "nms_score_threshold: 0.05",
}
LITE_MICRO = {
    "voxel_size: [0.1, 0.1, 0.2]": "voxel_size: [0.4, 0.4, 0.2]",
    "batch_size: 6": "batch_size: 2",
    "max_number_of_voxels: 8000": "max_number_of_voxels: 3000",
    "max_number_of_voxels: 12000": "max_number_of_voxels: 3000",
    "nms_score_threshold: 0.3": "nms_score_threshold: 0.05",
}


def micro_config(src: Path, root: Path, tmp: Path, replace: dict,
                 name: str) -> Path:
    return kitti_config(src.read_text(), root, tmp, name, **replace)


@pytest.fixture(scope="module")
def clones(tmp_path_factory):
    """The port's synthetic KITTI clones: multi-class (people.fhd) and
    car (car.lite), 6 training and 2 validation frames each."""
    tmp = tmp_path_factory.mktemp("host_rb")
    synth_kitti.write_clone(tmp / "mc", 6, 2, seed=0, multiclass=True)
    synth_kitti.write_clone(tmp / "car", 6, 2, seed=0)
    return tmp


@pytest.fixture(scope="module")
def people_cfg(clones):
    return micro_config(PEOPLE, clones / "mc", clones, PEOPLE_MICRO,
                        "people.micro.config")


@pytest.fixture(scope="module")
def lite_cfg(clones):
    return micro_config(LITE, clones / "car", clones, LITE_MICRO,
                        "lite.micro.config")


# --------------------------------------------------------------------------
# rulebooks
# --------------------------------------------------------------------------

def random_coords(rng, grid, n_active, n_pad):
    """``n_active`` distinct sites of ``grid`` in key order, then padding."""
    D, H, W = grid
    lin = rng.choice(D * H * W, n_active, replace=False)
    zyx = np.stack([lin // (H * W), (lin // W) % H, lin % W], 1)
    zyx = zyx[np.argsort((zyx[:, 1] * W + zyx[:, 2]) * D + zyx[:, 0])]
    return np.concatenate([zyx, np.full((n_pad, 3), -1)]).astype(np.int32)


def config_plans(path: Path, v_cap: int, out_caps=None):
    """(port plan, JAX plan) of a config's sparse middle at ``v_cap``."""
    cfg = train.Bundle(path).model_cfg
    jcfg = jax_train.Bundle(path).model_cfg
    if out_caps is not None:
        cfg = cfg.__class__(**{**cfg.__dict__, "sparse_out_caps": out_caps})
        jcfg = jcfg.__class__(**{**jcfg.__dict__,
                                 "sparse_out_caps": out_caps})
    return voxelnet.middle_plan(cfg, v_cap), jax_voxelnet.middle_plan(jcfg,
                                                                      v_cap)


def assert_books_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert_same(got[k], want[k], k)


@pytest.mark.parametrize("caps", [None, (512, 256, 256, 64)],
                         ids=["plan_caps", "truncated"])
@pytest.mark.parametrize("config", [PEOPLE, LITE, CAR_FHD],
                         ids=["people.fhd", "car.lite", "car.fhd"])
def test_middle_rulebooks_equal_jax(config, caps):
    """Every block of the config's plan (3x3x3 blocks in one native call,
    the z-only (3,1,1) strided block, the legacy stack of car.lite): the
    port's native builder == the JAX package's native builder == the
    port's numpy twins, bit for bit; ``truncated``: caps below the site
    counts, truncated in key order."""
    plan, jplan = config_plans(config, 2048, caps)
    assert [tuple(b) for b in plan] == [tuple(b) for b in jplan]
    coords = random_coords(np.random.default_rng(len(config.name)),
                           plan[0].grid, 1500, 548)
    got = rulebook_host.build_middle_rulebooks(coords, plan)
    assert_books_equal(got, jax_rh.build_middle_rulebooks(coords, jplan))
    assert_books_equal(rulebook_host.build_middle_rulebooks(
        coords, plan, numpy=True), got)
    saturated = [int(got[f"rb{i}_out_valid"].sum()) == b.out_cap
                 for i, b in enumerate(plan)]
    if caps is not None:                 # the first three truncate
        assert all(saturated[:3]), saturated


@pytest.mark.parametrize("kind", ["subm_3x3x3", "subm_z_only", "no_subm"])
def test_block_kinds_equal_jax_and_device_builders(kind):
    """One block of each kind, native and numpy, against the JAX package
    and against the port's device merge builders (where a tap is found,
    the same row; the same output sites in the same order)."""
    grid = (41, 160, 132)
    spec = {"subm_3x3x3": sc.BlockSpec(2, 16, 32, (3, 3, 3), (2, 2, 2),
                                       (1, 1, 1)),
            "subm_z_only": sc.BlockSpec(3, 64, 64, (3, 1, 1), (2, 1, 1),
                                        (0, 0, 0)),
            "no_subm": sc.BlockSpec(0, 0, 32, (3, 3, 3), (2, 2, 2),
                                    (1, 1, 1))}[kind]
    blk = sc.plan_from_specs(grid, 1200, (spec,), out_caps=(1536,))[0]
    jblk = jax_sc.plan_from_specs(grid, 1200, (jax_sc.BlockSpec(*spec),),
                                  out_caps=(1536,))[0]
    coords = random_coords(np.random.default_rng(3), grid, 1000, 200)
    got = rulebook_host.block_rulebooks(coords, blk)
    for want in (jax_rh.block_rulebooks(coords, jblk),
                 rulebook_host.block_rulebooks(coords, blk, numpy=True)):
        for g, w in zip(got, want):
            assert_same(g, w)
    gi, fo, oc, ov, dgi, dfo = got
    assert gi.shape[0] == (0 if kind == "no_subm" else 27)
    tc = torch.from_numpy(coords)
    valid = tc[:, 0] >= 0
    if blk.n_subm:
        rb = sc.build_submanifold_rulebook_merge(tc, valid, grid,
                                                 blk.subm_kernel)
        np.testing.assert_array_equal(rb.found.numpy(), fo)
        np.testing.assert_array_equal(rb.gather_idx.numpy()[fo], gi[fo])
        assert fo.any()
    lay = sc.build_strided_layout_merge(tc, valid, grid, blk.kernel,
                                        blk.stride, blk.pad, blk.out_cap)
    np.testing.assert_array_equal(lay.out_coords.numpy(), oc)
    np.testing.assert_array_equal(lay.out_valid.numpy(), ov)
    np.testing.assert_array_equal(lay.found.numpy(), dfo)
    np.testing.assert_array_equal(lay.gather_idx.numpy()[dfo], dgi[dfo])
    assert int(lay.num_out) == int(ov.sum()) > 0


def test_native_builder_is_required(monkeypatch, lite_cfg, tmp_path):
    """The native builder is built from the port's own source into its
    ``_build/`` (not the root ``csrc/``), and when it cannot be built the
    calls and the reader raise: nothing falls back to the numpy twins."""
    lib = _build.lib_path("rulebook_host", ".cpp")
    assert lib.parent == _build.BUILD_DIR
    rulebook_host.native()
    assert lib.exists()

    def no_compiler():
        raise _build.KernelBuildError("g++ not found (PATH, /usr/bin)")

    monkeypatch.setattr(_build, "cxx_path", no_compiler)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "lib_path",
                        lambda name, suffix: tmp_path / lib.name)
    rulebook_host.native.cache_clear()
    _build._load_host.cache_clear()
    try:
        coords = random_coords(np.random.default_rng(0), (8, 16, 16), 50, 14)
        with pytest.raises(_build.KernelBuildError):
            rulebook_host.subm_rulebook(coords, (8, 16, 16))
        with pytest.raises(_build.KernelBuildError):
            train.Bundle(lite_cfg).input_reader(training=False)
        numpy_only = rulebook_host.subm_rulebook_np(coords, (8, 16, 16))
        assert numpy_only[1].any()
    finally:
        monkeypatch.undo()
        rulebook_host.native.cache_clear()
        _build._load_host.cache_clear()
    assert rulebook_host.native() is not None


# --------------------------------------------------------------------------
# examples and the loader
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["people_train", "lite_eval"])
def test_examples_equal_jax_key_for_key(which, people_cfg, lite_cfg):
    """The first two examples of the reader, in stream order, on clone
    frames: every key of the JAX reader's, ``rb*`` included, bit for bit
    (people.fhd's training reader: its two sampler groups and the
    augmentation; car.lite's eval reader)."""
    path, training = ((people_cfg, True) if which == "people_train"
                      else (lite_cfg, False))
    bundle, jbundle = train.Bundle(path), jax_train.Bundle(path)
    tds, tloader = bundle.input_reader(training=training)
    jds, jloader = jbundle.input_reader(training=training)
    stream, jstream = tloader._index_stream(), jloader._index_stream()
    plan = bundle.middle_plan(training)
    for _ in range(2):
        idx, seed = next(stream)
        assert next(jstream) == (idx, seed)
        got, want = tds.example(idx, seed), jds.example(idx, seed)
        assert sorted(got) == sorted(want)
        assert sum(k.startswith("rb") for k in got) == 6 * len(plan)
        for k in want:
            if k in ("metadata", "calib"):
                assert_same_tree(got[k], want[k])
            else:
                assert_same(got[k], want[k], k)
    assert int(got["num_voxels"]) > 500
    for i, blk in enumerate(plan):
        assert got[f"rb{i}_out_valid"].shape == (blk.out_cap,)


@pytest.mark.parametrize("pool", [dict(num_workers=3),
                                  dict(process_workers=True,
                                       num_workers=2)],
                         ids=["threads", "processes"])
def test_pools_carry_rulebooks_unchanged(pool, lite_cfg):
    """The eval reader's batches through the thread pool and the forked
    process pool equal the sequential loader's, ``rb*`` arrays (bool and
    int32) included, dtype for dtype."""
    bundle = train.Bundle(lite_cfg)
    prep_ds, _ = bundle.input_reader(training=False)
    common = dict(batch_size=2, shuffle=False, repeat=False,
                  drop_last=False)
    plain = list(input_pipeline.BatchLoader(prep_ds, **common))
    pooled = list(input_pipeline.BatchLoader(prep_ds, **common, **pool))
    assert len(plain) == len(pooled) == 1
    for k, want in plain[0].items():
        if k in ("metadata", "calib"):
            continue
        assert_same(pooled[0][k], want, k)
    assert plain[0]["rb0_subm_found"].dtype == np.bool_
    assert plain[0]["rb0_subm_idx"].dtype == np.int32
    dev = batching.device_example(plain[0])
    assert "rb3_down_found" in dev and "metadata" not in dev


def test_buckets_with_host_rulebooks_are_refused(lite_cfg, tmp_path):
    """Host rulebooks with ``static_shape_buckets`` were refused until the
    port had them: now the training reader of car.lite's micro twin with
    buckets builds each example's rulebooks at its own bucket's plan and
    pads them to its batch's bucket, and its first two batches (the
    sequential loader, stream order) equal the JAX package's, ``rb*``
    included, key for key."""
    text = lite_cfg.read_text()
    old = "anchor_area_threshold: -1.0"
    assert old in text
    path = tmp_path / "lite.buckets.config"
    text = text.replace(old, old + "\n    static_shape_buckets: [4000, 8000]",
                        1)
    # room above the scans' voxel counts (3000 saturates every one)
    path.write_text(text.replace("max_number_of_voxels: 3000",
                                 "max_number_of_voxels: 12000"))
    bundle, jbundle = train.Bundle(path), jax_train.Bundle(path)
    tds, tloader = bundle.input_reader(training=True)
    jds, jloader = jbundle.input_reader(training=True)
    assert tloader._buckets == jloader._buckets == (4000, 8000, 12000)
    stream, jstream = tloader._index_stream(), jloader._index_stream()

    class Queue(list):
        put = list.append

    caps = []
    for _ in range(2):
        keys = [next(stream) for _ in range(2)]
        assert [next(jstream) for _ in range(2)] == keys
        got = tloader._merge([tds.example(*k) for k in keys])
        q = Queue()
        jloader._emit(q, [jds.example(*k) for k in keys])
        want = q[0]
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], list):
                assert len(got[k]) == len(want[k]), k
                for g, w in zip(got[k], want[k]):
                    assert_same_tree(g, w)
            else:
                assert_same(got[k], want[k], k)
        V = got["voxels"].shape[1]
        caps.append(V)
        plan = tloader._bucket_plans[V]
        assert got["rb0_subm_idx"].shape[-1] == plan[0].in_cap
    assert min(caps) < 12000, caps


# --------------------------------------------------------------------------
# the middle on host rulebooks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "gather_gemm"])
def test_sparse_middle_on_host_rulebooks_matches_jax(mode):
    """A SparseMiddle twin of the FHD plan (cut in xy) given host
    rulebooks, in train mode (batch statistics), against the JAX module
    given the same rulebooks: the BEV map and the saturation counts; in
    ``gather_gemm`` form the port's joins take the gather function."""
    grid = (41, 48, 40)
    kw = dict(grid_dhw=grid, num_input_features=4, blocks=jax_plans._FHD,
              out_caps=(3072, 3072, 1024, 384))
    rng = np.random.default_rng(11)
    coords = np.stack([random_coords(rng, (40, 48, 40), n, 900 - n)
                       for n in (800, 650)])
    feats = rng.normal(size=(2, 900, 4)).astype(np.float32)
    feats[coords[..., 0] < 0] = 0
    jmod = jax_middle.SparseMiddle(**kw, use_pallas_gemm=mode != "plain")
    variables = seeded_variables(jmod, 4, jnp.asarray(feats),
                                 jnp.asarray(coords))
    mod = middle.SparseMiddle(**kw, use_pallas_gemm=mode != "plain")
    plan = mod.plan(900)
    flat = [rulebook_host.build_middle_rulebooks(c, plan) for c in coords]
    stacked = {k: np.stack([f[k] for f in flat]) for k in flat[0]}
    jbooks = jax_rh.unflatten({k: jnp.asarray(v)
                               for k, v in stacked.items()}, len(plan))
    ref, mut = jmod.apply(variables, jnp.asarray(feats), jnp.asarray(coords),
                          train=True, rulebooks=jbooks,
                          mutable=["batch_stats", "intermediates"])
    load_middle(mod, variables)
    launches = sgg.gather_gemm.launches
    with torch.no_grad():
        got = mod.train()(torch.from_numpy(feats), torch.from_numpy(coords),
                          rulebooks=rulebook_host.unflatten(stacked,
                                                            len(plan)))
    assert sgg.gather_gemm.launches == launches      # the CPU: no kernel
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **MIDDLE_TOL)
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    for i in range(len(plan)):
        assert int(mod.capacity_saturated[f"b{i}"]) == int(
            mut["intermediates"][f"b{i}_capacity_saturated"][0])


# --------------------------------------------------------------------------
# the training step, float64
# --------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def people_step(people_cfg):
    """The first training batch of the people.fhd twin (two examples in
    stream order, host rulebooks included), JAX's initial variables, and
    its loss terms and gradients in float64 on the same host rulebooks."""
    bundle = train.Bundle(people_cfg)
    prep_ds, loader = bundle.input_reader(training=True)
    stream = loader._index_stream()
    batch = batching.merge_batch(
        [prep_ds.example(*next(stream)) for _ in range(2)])
    jmodel = jax_train.Bundle(people_cfg).model
    init = _np_tree(jax.jit(functools.partial(jmodel.init, train=True))(
        jax.random.key(0), np.zeros((1, 64, 5, 4), np.float32),
        np.zeros((1, 64), np.int32), np.full((1, 64, 3), -1, np.int32)))
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for module in F64_MODULES:
            mp.setattr(module, "jnp", _Float64Numpy())
        jbundle = jax_train.Bundle(people_cfg)
        model, cfg = jbundle.model, jbundle.model_cfg
        assert cfg.num_class == 2 and not cfg.sparse_keymatch

        def f64(x):
            x = np.asarray(x)
            return jnp.asarray(x, jnp.float64 if x.dtype == np.float32
                               else x.dtype)

        variables = jax.tree_util.tree_map(f64, init)
        example = {k: f64(v) for k, v in jax_batching.device_example(
            batch).items()}

        def loss_fn(p, example):
            books = jax_train._middle_rulebooks(example, cfg)
            assert books is not None
            preds, _ = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                example["voxels"], example["num_points"],
                example["coordinates"], train=True, middle_rulebooks=books,
                mutable=["batch_stats"])
            return jax_voxelnet.compute_loss(preds, example, cfg)

        grads, terms = jax.jit(jax.grad(loss_fn, has_aux=True))(
            variables["params"], example)
        grads = _np_tree(grads)
        terms = {k: float(v) for k, v in terms.items()}
    return {"batch": batch, "init": init, "grads": grads, "terms": terms}


def test_people_fhd_float64_step_matches_jax(people_cfg, people_step):
    """The port's people.fhd step in float64 on the host rulebooks (the
    plain joins) against the JAX package's step in float64: loss terms
    and every gradient, the two-class head's included."""
    bundle = train.Bundle(people_cfg)
    assert bundle.middle_plan(True) is not None
    weight_import.load_variables(bundle.model, people_step["init"])
    model = bundle.model.to(torch.float64).train()
    example = {k: v.double() if v.is_floating_point() else v
               for k, v in train.to_device(people_step["batch"],
                                           "cpu").items()}
    assert example["rb0_subm_found"].dtype == torch.bool
    preds = train.forward(model, example, bundle.model_cfg)
    loss, terms = voxelnet.compute_loss(preds, example, bundle.model_cfg)
    for k, want in people_step["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), want,
                                   **F64_LOSS_TOL, err_msg=k)
    loss.backward()
    grads = jax_weight_import.to_torch_state_dict(
        {"params": people_step["grads"],
         "batch_stats": people_step["init"]["batch_stats"]})
    worst = 0.0
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float64, name
        want = grads[name]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   rtol=F64_GRAD_SHARE,
                                   atol=F64_GRAD_SHARE * scale,
                                   err_msg=name)
        worst = max(worst, float(np.abs(p.grad.numpy() - want).max())
                    / scale)
    print(f"people.fhd float64 step vs the JAX float64 step: gradients "
          f"within {worst:.3g} of max|g|")


def test_cli_trains_and_evaluates_people_fhd(people_cfg, tmp_path, capsys):
    """``cli train`` (two steps, host rulebooks from three loader
    threads) and ``cli evaluate`` of its checkpoint on the people.fhd
    twin, on the CPU: the loss is finite, the two-class table printed;
    ``pod_inference_from_checkpoint`` serves the twin (rulebooks built
    on the device)."""
    model_dir = tmp_path / "people"
    assert cli.main(["train", f"--config_path={people_cfg}",
                     f"--model_dir={model_dir}", "--max_steps=2",
                     "--display_step=1", "--device=cpu"]) in (None, 0)
    out = capsys.readouterr().out
    assert "mid_capacity_saturated" in out and "step=2" in out
    assert (model_dir / "checkpoints").is_dir()
    assert cli.main(["evaluate", f"--config_path={people_cfg}",
                     f"--model_dir={model_dir}", "--device=cpu"]) in (None,
                                                                      0)
    out = capsys.readouterr().out
    assert "Pedestrian" in out and "Cyclist" in out
    pod = pod_inference_from_checkpoint(people_cfg, None, device="cpu",
                                        max_voxels=3000,
                                        max_points_per_voxel=5)
    pts = np.asarray(train.Bundle(people_cfg).input_reader(training=False)[
        0].dataset.get_sensor_data(0)["lidar"]["points"], np.float32)
    served = pod(pts[None], np.array([len(pts)], np.int32))
    assert served["box3d_lidar"].shape == (1, 2 * pod.cfg.nms_post_max_size,
                                           7)
