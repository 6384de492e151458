"""The port's last command-line verbs on the CPU: ``building_data_prep``
(synthetic and ``--scan_dir``) against the JAX package's prep,
``export_asbuilt --device cpu`` on the tiny as-built config against the
export of the viewer predictor's detections, ``train --profile_steps``
writing a trace that Chrome / Perfetto read, and the verb list against the
reference's ``cli.py``."""
import json
import re

import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu import cli as jax_cli
from automatic_as_built_reconstruction_tpu.data import (
    create_data as jax_create_data, scan_io as jax_scan_io)
from automatic_as_built_reconstruction_tpu.utils import (
    asbuilt_export as jax_ax)
from automatic_as_built_reconstruction_tpu_torch import cli
from automatic_as_built_reconstruction_tpu_torch.data import building
from automatic_as_built_reconstruction_tpu_torch.train import (
    checkpoint as ckpt_mod)
from automatic_as_built_reconstruction_tpu_torch.viewer import server

from test_torch_eval import numpy_reference
from test_torch_models import PORT_CFG
from test_torch_scan_io import same_layout
from test_torch_viewer import TINY, seed0_model_dir


def verbs(main, capsys) -> list:
    with pytest.raises(SystemExit):
        main(["--help"])
    out = capsys.readouterr().out
    return sorted(re.search(r"\{([a-z_,]+)\}", out).group(1).split(","))


def test_help_lists_every_verb_of_the_reference(capsys):
    want = verbs(jax_cli.main, capsys)
    assert verbs(cli.main, capsys) == want
    assert {"building_data_prep", "export_asbuilt", "viewer"} <= set(want)
    with pytest.raises(SystemExit):
        cli.main(["train", "--help"])
    assert "--profile_steps" in capsys.readouterr().out


def test_building_data_prep_verbs_equal_the_reference(tmp_path):
    root, ref = tmp_path / "port", tmp_path / "jax"
    cli.main(["building_data_prep", "--root_path", str(root),
              "--num_scenes", "2", "--num_val", "1", "--seed", "2"])
    with numpy_reference():
        jax_create_data.building_data_prep(ref, num_scenes=2, num_val=1,
                                           seed=2)
    same_layout(root, ref)
    scans = tmp_path / "scans"
    scans.mkdir()
    for i in range(3):
        scene = building.generate_building_scene(40 + i)
        jax_scan_io.write_ply(scene["points"], scans / f"s{i}.ply")
        jax_scan_io.write_annotations(scans / f"s{i}.json",
                                      scene["gt_boxes"], scene["gt_names"])
    root, ref = tmp_path / "port_scans", tmp_path / "jax_scans"
    cli.main(["building_data_prep", "--root_path", str(root), "--scan_dir",
              str(scans), "--val_fraction", "0.5"])
    with numpy_reference():
        jax_create_data.building_data_prep_from_scans(scans, ref,
                                                      val_fraction=0.5)
    same_layout(root, ref)


def test_export_asbuilt_writes_the_model_of_the_detections(tmp_path,
                                                           capsys,
                                                           monkeypatch):
    """``export_asbuilt --device cpu`` from a model directory of seed-0
    weights: the JSON and SVG files are the reference exporter's on the
    detections that the viewer's predictor gave the verb for the scene
    (recorded); without ``--device`` it runs on the card, and raises where
    there is none."""
    port_dir, _ = seed0_model_dir(tmp_path)
    out_json, out_svg = tmp_path / "m.json", tmp_path / "m.svg"
    seen = []
    make_predictor = server._make_predictor

    def recording(*args, **kw):
        dataset, run = make_predictor(*args, **kw)
        seen.append(kw.get("device"))
        return dataset, lambda idx: seen.append(run(idx)) or seen[-1]
    monkeypatch.setattr(server, "_make_predictor", recording)
    cli.main(["export_asbuilt", "--config_path", str(PORT_CFG / TINY),
              "--model_dir", str(port_dir), "--scene", "1", "--output",
              str(out_json), "--svg", str(out_svg), "--score_threshold",
              "0.25", "--device", "cpu"])
    assert f"wrote {out_json}: " in capsys.readouterr().out
    device, dets = seen
    assert device == "cpu" and len(dets["scores"]) > 0
    ref_json, ref_svg = tmp_path / "ref.json", tmp_path / "ref.svg"
    model = jax_ax.export_asbuilt(
        {"box3d_lidar": dets["boxes"], "scores": dets["scores"],
         "label_preds": dets["labels"]}, building.CLASSES,
        json_path=str(ref_json), svg_path=str(ref_svg),
        score_threshold=0.25)
    assert out_json.read_text() == ref_json.read_text()
    assert out_svg.read_text() == ref_svg.read_text()
    assert json.loads(out_json.read_text())["stats"] == model["stats"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for verb in (["export_asbuilt", "--output", str(tmp_path / "x.json")],
                 ["viewer"]):
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main([*verb, "--config_path", str(PORT_CFG / TINY),
                      "--model_dir", str(port_dir)])


def test_train_profile_steps_writes_a_trace(tmp_path, capsys):
    """``train --profile_steps 1 --max_steps 3 --device cpu``: one step
    after two warm-up steps traced into ``<model_dir>/profile``, the
    trace's path logged, the final checkpoint saved after it."""
    model_dir = tmp_path / "run"
    cli.main(["train", "--config_path", str(PORT_CFG / TINY), "--model_dir",
              str(model_dir), "--max_steps", "3", "--display_step", "1",
              "--profile_steps", "1", "--device", "cpu"])
    trace = model_dir / "profile" / "steps_2-3.trace.json"
    assert f"profile trace written to {trace}" in capsys.readouterr().out
    assert sorted(p.name for p in (model_dir / "profile").iterdir()) == [
        trace.name]
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert "pillar_scatter" in " ".join(names)      # K1's op, CPU body
    assert ckpt_mod.CheckpointManager(model_dir).all_steps() == [3]
    log = (model_dir / "log.txt").read_text()
    assert log.index("profile trace written") < log.index(
        "training finished at step 3")
    assert np.isfinite([json.loads(line)["loss"] for line in
                        (model_dir / "metrics.jsonl").read_text()
                        .splitlines() if '"loss"' in line]).all()
