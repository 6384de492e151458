"""The serving export (``utils/serving_export.py``) and the registered
kernel ops under it (``ops/library.py``), on the CPU.

At the micro shapes of ``tests/test_serving_export.py`` (``tiny_pod``,
``sparse_km_pod``): the port's artifact, exported with
``platforms=("cpu",)``, saved to bytes and reloaded, equals the port's
live ``PodInference`` exactly, and matches the JAX package's own CPU
artifact of the same variables on the same points as sets per (scan,
class), boxes within 1e-3 and scores within 1e-4 (the serving
tolerance of ``tests/test_torch_serving.py``).  ``fused_mean`` is held to
the JAX package's ``hard`` artifact: it gives ``hard``'s detections.
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.core import anchors as jax_anchors
from automatic_as_built_reconstruction_tpu.models import voxelnet as jvn
from automatic_as_built_reconstruction_tpu.parallel.inference import (
    PodInference as JaxPodInference)
from automatic_as_built_reconstruction_tpu.utils import (
    serving_export as jax_serving_export)
from automatic_as_built_reconstruction_tpu_torch.models import voxelnet as tvn
from automatic_as_built_reconstruction_tpu_torch.ops import (
    library, voxel_mean, voxelize)
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    PodInference, detections_mismatch)
from automatic_as_built_reconstruction_tpu_torch.utils import (
    serving_export, weight_import)

from test_torch_weight_import import (PILLAR_MICRO, SPARSE_MICRO,
                                      micro_variables, port_cfg, scan)

REPO = Path(__file__).resolve().parents[1]
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4
V, T = 64, 4                  # the reference fixtures' caps
B, P = 2, 300                 # the served shape

# (micro config, its changes, port voxelization, anchor grid) of each
# served mode; the JAX package serves ``fused_mean`` as ``hard``
MODES = {
    "pillar_hard": ("pillar", {}, "hard", (1, 16, 16)),
    "keymatch_hard": ("sparse", {}, "hard", (1, 8, 8)),
    "keymatch_fused_mean": ("sparse", {}, "fused_mean", (1, 8, 8)),
    "gather_gemm_hard": ("sparse", {"sparse_keymatch": False}, "hard",
                         (1, 8, 8)),
}
MICRO = {"pillar": PILLAR_MICRO, "sparse": SPARSE_MICRO}
# the kernel ops each mode's exported program holds
MODE_OPS = {
    "pillar_hard": {"pillar_scatter", "rotated_iou"},
    "keymatch_hard": {"keymatch_gemm", "rotated_iou"},
    "keymatch_fused_mean": {"point_keys_fill", "segment_mean",
                            "keymatch_gemm", "rotated_iou"},
    "gather_gemm_hard": {"gather_gemm", "rotated_iou"},
}


def anchors_of(grid) -> np.ndarray:
    """The reference fixtures' anchors."""
    gen = jax_anchors.AnchorGeneratorRange(
        anchor_ranges=(0.0, -4.0, -1.0, 8.0, 4.0, -1.0),
        sizes=((0.5, 1.0, 1.5),), rotations=(0.0, np.pi / 2))
    return gen.generate(grid).reshape(-1, 7).astype(np.float32)


def port_pod(mode) -> PodInference:
    """The port's PodInference of one mode on the CPU, on the micro
    config's seeded variables."""
    kind, changes, voxelization, grid = MODES[mode]
    cfg = port_cfg(jvn.VoxelNetConfig(**dict(MICRO[kind], **changes)))
    model = tvn.VoxelNet(cfg)
    weight_import.load_variables(model, micro_variables(kind))
    return PodInference(model, cfg, anchors_of(grid), device="cpu",
                        max_voxels=V, max_points_per_voxel=T,
                        voxelization=voxelization)


@functools.cache
def jax_artifact(kind: str, keymatch: bool = True) -> bytes:
    """The JAX package's CPU artifact of a micro config's ``hard``
    serving program, on the same variables."""
    changes = {"sparse_keymatch": keymatch} if kind == "sparse" else {}
    jcfg = jvn.VoxelNetConfig(**dict(MICRO[kind], **changes))
    grid = {"pillar": (1, 16, 16), "sparse": (1, 8, 8)}[kind]
    pod = JaxPodInference(jvn.VoxelNet(cfg=jcfg), jcfg, micro_variables(kind),
                          anchors_of(grid), max_voxels=V,
                          max_points_per_voxel=T)
    return jax_serving_export.export_serving(pod, B, P, platforms=("cpu",))


@functools.cache
def artifact(mode: str) -> bytes:
    """The port's CPU artifact of one mode."""
    return serving_export.export_serving(port_pod(mode), B, P,
                                         platforms=("cpu",))


def kernel_ops(artifact) -> set:
    """The ``abr`` ops anywhere in a loaded artifact's graph (its NMS
    subgraphs included)."""
    return {str(n.target).split(".")[1] for n in graph_nodes(artifact)
            if str(n.target).startswith("abr.")}


def graph_nodes(artifact) -> list:
    """The call nodes of a loaded artifact's graph and subgraphs."""
    return [n for m in artifact._exported.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if n.op == "call_function"]


@pytest.fixture(scope="module", params=list(MODES))
def served(request):
    """(mode, port pod, the port's reloaded artifact, its bytes, the JAX
    package's reloaded CPU artifact, its bytes)."""
    kind, changes = MODES[request.param][:2]
    blob = artifact(request.param)
    jax_blob = jax_artifact(kind, changes.get("sparse_keymatch", True))
    return (request.param, port_pod(request.param),
            serving_export.load_serving(blob), blob,
            jax_serving_export.load_serving(jax_blob), jax_blob)


def test_artifact_equals_live_pod_and_holds_the_kernel_ops(served):
    mode, port, art, blob, _, _ = served
    meta = art.meta
    assert meta == {"batch": B, "max_points": P, "num_features": 4,
                    "platforms": ["cpu"],
                    "voxelization": port.voxelization,
                    "outputs": ["box3d_lidar", "scores", "label_preds",
                                "valid"], "format": "torch.export"}
    for seed in (0, 7):
        pts, nv = scan(seed, B, P)
        nv[1] = P // 2
        live, got = port(pts, nv), art(pts, nv)
        assert sorted(got) == sorted(live)
        for k in live:
            assert got[k].dtype == live[k].dtype, k
            np.testing.assert_array_equal(got[k], live[k], err_msg=k)
        assert live["valid"].any()
    assert kernel_ops(art) == MODE_OPS[mode]
    nodes = {str(n.target) for n in graph_nodes(art)}
    assert "while_loop" in nodes                   # NMS on the device


def test_artifact_matches_the_jax_packages_artifact(served):
    _, _, art, _, jax_art, _ = served
    for seed in (0, 7):
        pts, nv = scan(seed, B, P)
        got = art(pts, nv)
        ref = {k: np.asarray(v) for k, v in jax_art(pts, nv).items()}
        diff = detections_mismatch(got, ref, 1, BOX_ATOL, SCORE_ATOL)
        assert diff is None, diff


def test_artifact_refuses_wrong_shapes_and_foreign_blobs(served):
    _, _, art, blob, _, jax_blob = served
    pts, nv = scan(0, B, P)
    with pytest.raises(ValueError, match="the artifact takes"):
        art(pts[:, :100], nv)
    with pytest.raises(ValueError, match="not an ABRSERVE1 artifact"):
        serving_export.load_serving(b"NOTANARTIFACT" + blob)
    with pytest.raises(ValueError, match="not a torch.export program"):
        serving_export.load_serving(jax_blob)


def test_export_refuses_a_mesh_pod_and_other_platforms():
    class MeshPod:
        mesh = object()
    with pytest.raises(ValueError, match="single-device"):
        serving_export.export_serving(MeshPod(), 1, 10)
    port = port_pod("pillar_hard")
    with pytest.raises(ValueError, match="tpu"):
        serving_export.export_serving(port, 1, 10, platforms=("tpu",))
    with pytest.raises(ValueError, match="one of"):
        serving_export.export_serving(port, 1, 10,
                                      platforms=("cuda", "cpu"))
    # the default platform is the card: refused for a CPU pod (with no
    # card, resolving the device refuses first)
    with pytest.raises((RuntimeError, ValueError), match="cuda"):
        serving_export.export_serving(port, 1, 10)


_LOAD_AND_CALL = """
import json, sys
import numpy as np
from automatic_as_built_reconstruction_tpu_torch.utils import serving_export
art = serving_export.load_serving(open(sys.argv[1], "rb").read())
req = np.load(sys.argv[2])
out = art(req["points"], req["num_valid"])
np.savez(sys.argv[3], **out)
print(json.dumps(sorted(m for m in sys.modules if m.startswith((
    "automatic_as_built_reconstruction_tpu_torch.models",
    "automatic_as_built_reconstruction_tpu_torch.builder",
    "automatic_as_built_reconstruction_tpu_torch.train",
    "automatic_as_built_reconstruction_tpu_torch.parallel",
    "automatic_as_built_reconstruction_tpu.", "jax", "flax"))
    or m == "automatic_as_built_reconstruction_tpu")))
"""


def test_artifact_loads_and_runs_without_the_model_code(tmp_path):
    """A fresh process loads and calls a key-match ``fused_mean``
    artifact: the live pod's answer, and no module of ``models/``,
    ``builder/``, ``train/`` or ``parallel/`` (and no JAX) imported."""
    port = port_pod("keymatch_fused_mean")
    (tmp_path / "model.abr").write_bytes(artifact("keymatch_fused_mean"))
    pts, nv = scan(3, B, P)
    np.savez(tmp_path / "req.npz", points=pts, num_valid=nv)
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD_AND_CALL, str(tmp_path / "model.abr"),
         str(tmp_path / "req.npz"), str(tmp_path / "out.npz")],
        cwd=tmp_path, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                           "HOME": str(tmp_path)},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    got = np.load(tmp_path / "out.npz")
    live = port(pts, nv)
    for k in live:
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)


def _op_cases():
    """CPU inputs for every op of ops/library.py."""
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(2, 6, 8, generator=g)
    lin = torch.tensor([[0, 5, 3, 17, 2, 9], [1, 4, 30, 7, 6, 8]],
                       dtype=torch.int32)
    boxes = torch.rand(2, 5, 5, generator=g) * 3
    boxes[..., 2:4] += 0.5
    f = torch.randn(10, 3, generator=g)
    w = torch.randn(4, 3, 8, generator=g)
    idx = torch.randint(0, 10, (4, 7), dtype=torch.int32, generator=g)
    found = torch.rand(4, 7, generator=g) > 0.3
    keys = torch.arange(10, dtype=torch.int32) * 2
    q = torch.randint(0, 20, (4, 7), dtype=torch.int32, generator=g)
    pts = torch.rand(2, 50, 4, generator=g) * 4
    nv = torch.tensor([50, 30], dtype=torch.int32)
    geo = ([1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 4.0, 4.0, 4.0], [4, 4, 4])

    def buffers():
        out = voxel_mean._empty_outputs(2, 20, 4, pts.device)
        state = torch.empty((2, voxel_mean.scan_words(50)),
                            dtype=torch.int32)
        return dict(out._asdict(), tile_state=state)

    packed = torch.sort(voxel_mean.point_keys_plain(
        pts, nv, voxel_size=geo[0], pc_range=geo[1], grid_size=geo[2]),
        1).values
    cell, tab = voxelize.slot_table(pts, nv, max_voxels=20,
                                    first_appearance=True, voxel_size=geo[0],
                                    pc_range=geo[1], grid_size=geo[2])
    return {
        "pillar_scatter": ((feats, lin, 20), {}),
        "rotated_iou": ((boxes, boxes, -1), {}),
        "gather_gemm": ((f, idx, found, w), {}),
        "gather_gemm_batched": ((f[None].expand(2, 10, 3).contiguous(),
                                 idx[None].expand(2, 4, 7).contiguous(),
                                 found[None].expand(2, 4, 7).contiguous(),
                                 w), {}),
        "keymatch_gemm": ((f, keys, q, w), {}),
        "point_keys": ((pts, nv, *geo), {}),
        "point_keys_fill": ((pts, nv, *geo, *buffers().values()), {}),
        "segment_mean": ((pts, packed, geo[2], 3,
                          *buffers().values()), {}),
        "mean_from_table": ((pts, cell, tab.order, tab.start, tab.count,
                             3, 20), {}),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_opcheck_every_op(case):
    """``torch.library.opcheck``: schema, fake function against the real
    op, autograd registration, AOT dispatch."""
    args, kwargs = _op_cases()[case]
    op = getattr(library, case.replace("_batched", ""))
    torch.library.opcheck(op, args, kwargs)


def test_every_kernel_op_is_checked():
    names = {c.replace("_batched", "") for c in _op_cases()}
    assert names == {op._qualname.split("::")[1] for op in library.OPS}


def test_cli_export_serving_from_a_model_directory(tmp_path, capsys):
    """The ``export_serving`` cli verb on a model directory: with no
    checkpoint there it warns and exports the seed-0 weights that
    ``pod_inference_from_checkpoint`` serves, and prints the reference's
    line; the file reloads into that pod's program."""
    from automatic_as_built_reconstruction_tpu_torch import cli
    from automatic_as_built_reconstruction_tpu_torch.data.building import (
        generate_building_scene, pad_batch)
    from automatic_as_built_reconstruction_tpu_torch.parallel import (
        pod_inference_from_checkpoint)

    config = (REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
              / "building" / "asbuilt_pillars_tiny.config")
    out = tmp_path / "tiny.abr"
    pts, nv = pad_batch([generate_building_scene(9)["points"][::8]])
    cli.main(["export_serving", "--config_path", str(config), "--model_dir",
              str(tmp_path / "empty"), "--output", str(out), "--batch", "1",
              "--max_points", str(pts.shape[1]), "--platforms", "cpu",
              "--max_voxels", "1024", "--max_points_per_voxel", "8"])
    printed = capsys.readouterr().out
    assert "WARNING: no checkpoint; serving random weights from seed 0" \
        in printed
    blob = out.read_bytes()
    art = serving_export.load_serving(blob)
    assert f"wrote {out} ({len(blob)} bytes): {art.meta}" in printed
    assert art.meta["platforms"] == ["cpu"]
    pod = pod_inference_from_checkpoint(config, tmp_path / "empty",
                                        device="cpu", max_voxels=1024,
                                        max_points_per_voxel=8)
    want, got = pod(pts, nv), art(pts, nv)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
