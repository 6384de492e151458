"""The port's viewer backend (``viewer/server.py``) against the JAX
package's, each served in-process on 127.0.0.1: every case of
``tests/test_viewer.py`` with no model loaded, where the port answers what
the reference answers (the page byte for byte, ``/api/info`` and
``/api/scene`` as the same JSON text, the same error codes), and with a
model: ``asbuilt_pillars_tiny.config`` on the CPU,

- from an empty model directory (the seed-0 initial weights, the model in
  eval mode);
- from a model directory holding the seed-0 weights of
  ``utils/seeded_init.py::load_seeded`` (spread BatchNorm statistics and
  class logits), where ``/api/detect`` equals, as sets, what the JAX
  package's ``_make_predictor`` gives from an empty model directory with
  the same weights as its initial state.  Both sides round boxes and
  scores to 3 decimals, so a value may differ by one unit in its last
  place: boxes and scores within 1e-3 (and 1e-6 for the float32 of the
  rounded value).
"""
import functools
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.data import (
    building as jax_building)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu.utils import (
    weight_import as jax_weight_import)
from automatic_as_built_reconstruction_tpu.viewer import (
    server as jax_server)
from automatic_as_built_reconstruction_tpu_torch.data import building
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    detections_mismatch)
from automatic_as_built_reconstruction_tpu_torch.train import (
    checkpoint as ckpt_mod, train)
from automatic_as_built_reconstruction_tpu_torch.utils.seeded_init import (
    load_seeded)
from automatic_as_built_reconstruction_tpu_torch.viewer import server

from test_torch_models import JAX_CFG, PORT_CFG

TINY = "asbuilt_pillars_tiny.config"
DET_ATOL = 1e-3 + 1e-6


def serve(module):
    """A ThreadingHTTPServer of ``module.Handler`` on a free port.  ->
    (base url, server)."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), module.Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


def _error(url):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url)
    return e.value.code, e.value.read()


@pytest.fixture(scope="module")
def viewers():
    """The port's and the JAX package's viewers over three synthetic
    scenes, no model loaded."""
    server._STATE.clear()
    server._STATE.update(dataset=building.BuildingDataset(num_synthetic=3),
                         classes=list(building.CLASSES), predict=None)
    jax_server._STATE.clear()
    jax_server._STATE.update(
        dataset=jax_building.BuildingDataset(num_synthetic=3),
        classes=list(jax_building.CLASSES), predict=None)
    port, p_httpd = serve(server)
    ref, r_httpd = serve(jax_server)
    yield port, ref
    p_httpd.shutdown()
    r_httpd.shutdown()


class TestViewerEndpoints:
    def test_index(self, viewers):
        port, ref = viewers
        status, body = _get(port + "/")
        assert status == 200 and b"canvas" in body
        assert body == _get(ref + "/")[1]
        assert len(body) == 10516

    def test_index_is_3d(self, viewers):
        _, body = _get(viewers[0] + "/")
        for marker in (b"boxCorners3d", b"EDGES", b"orbit", b"makeProject",
                       b"mode3d"):
            assert marker in body, marker

    def test_info(self, viewers):
        port, ref = viewers
        status, body = _get(port + "/api/info")
        assert status == 200 and body == _get(ref + "/api/info")[1]
        info = json.loads(body)
        assert info == {"num_scenes": 3, "classes": list(building.CLASSES),
                        "has_model": False}

    @pytest.mark.parametrize("idx", [0, 1])
    def test_scene(self, viewers, idx):
        """The same JSON text: points subsampled with ``default_rng(0)``
        to 60 000 where a scan has more, rounded to 3 decimals, and the
        ground truth."""
        port, ref = viewers
        _, body = _get(port + f"/api/scene?idx={idx}")
        assert body == _get(ref + f"/api/scene?idx={idx}")[1]
        scene = json.loads(body)
        assert 1000 < len(scene["points"]) <= 60000
        assert len(scene["points"][0]) == 3
        assert len(scene["gt_boxes"]) == len(scene["gt_names"])
        assert all(len(b) == 7 for b in scene["gt_boxes"])

    def test_detect_without_model(self, viewers):
        port, ref = viewers
        got = _error(port + "/api/detect?idx=0")
        assert got == _error(ref + "/api/detect?idx=0")
        assert got[0] == 400

    def test_bad_index(self, viewers):
        port, ref = viewers
        code, body = _error(port + "/api/scene?idx=99")
        assert code == 500 and b"error" in body
        assert (code, body) == _error(ref + "/api/scene?idx=99")
        assert _error(port + "/nowhere")[0] == 404


def seed0_model_dir(tmp_path):
    """The tiny config's model with the seed-0 weights of
    ``utils/seeded_init.py::load_seeded`` (spread BatchNorm statistics and
    class logits), saved as the port's checkpoint at step 0.  -> (the
    model directory, its state)."""
    state = train.init_state(train.Bundle(PORT_CFG / TINY), device="cpu")
    load_seeded(state.model, 0)
    model_dir = tmp_path / "seed0"
    ckpt_mod.CheckpointManager(model_dir).save(0, state, force=True)
    return model_dir, state


def jax_variables(state) -> dict:
    """The port's weights as the JAX package's variables of the tiny
    config, through its import of the lineage state_dict."""
    jmodel = jax_train.Bundle(JAX_CFG / TINY).model
    shapes = jax.eval_shape(
        functools.partial(jmodel.init, train=True), jax.random.key(0),
        jnp.zeros((1, 8, 16, 4)), jnp.zeros((1, 8), jnp.int32),
        jnp.full((1, 8, 3), -1, jnp.int32))
    template = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                      shapes)
    return jax_weight_import.from_torch_state_dict(state.model.state_dict(),
                                                   template)


def padded(dets_list):
    """``run(idx)`` outputs -> the padded dict ``detections_mismatch``
    takes."""
    n = max(max(len(d["scores"]) for d in dets_list), 1)
    out = {"box3d_lidar": np.zeros((len(dets_list), n, 7)),
           "scores": np.zeros((len(dets_list), n)),
           "label_preds": np.zeros((len(dets_list), n), np.int64),
           "valid": np.zeros((len(dets_list), n), bool)}
    for i, d in enumerate(dets_list):
        k = len(d["scores"])
        out["box3d_lidar"][i, :k] = np.asarray(d["boxes"]).reshape(-1, 7)
        out["scores"][i, :k] = d["scores"]
        out["label_preds"][i, :k] = d["labels"]
        out["valid"][i, :k] = True
    return out




def test_predictor_from_an_empty_model_directory(tmp_path, monkeypatch,
                                                 capsys):
    """No checkpoint: the seed-0 initial weights, the model put in eval
    mode (``init_state`` leaves it training: the BatchNorms would take
    batch statistics), detections as host arrays; ``device="cuda"`` raises
    without a GPU."""
    states = []
    init_state = train.init_state
    monkeypatch.setattr(train, "init_state",
                        lambda *a, **k: states.append(init_state(*a, **k))
                        or states[-1])
    dataset, run = server._make_predictor(PORT_CFG / TINY, tmp_path / "none",
                                          device="cpu")
    assert "loaded checkpoint" not in capsys.readouterr().out
    assert len(states) == 1 and not states[0].model.training
    dets = run(0)
    assert run(0) is dets                       # cached
    assert set(dets) == {"boxes", "scores", "labels"}
    assert all(isinstance(v, np.ndarray) for v in dets.values())
    assert dataset._class_names == list(building.CLASSES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        server._make_predictor(PORT_CFG / TINY, tmp_path / "none")
    with pytest.raises(RuntimeError, match="is_available"):
        server.main(["--config_path", str(PORT_CFG / TINY), "--model_dir",
                     str(tmp_path / "none")])


def test_detect_matches_the_reference_predictor(tmp_path, capsys,
                                                monkeypatch):
    """``/api/detect`` of the port's viewer with the seed-0 weights from
    its model directory against the JAX package's ``_make_predictor`` from
    an empty model directory, its ``init_state`` giving the same weights:
    equal as sets on two scenes (boxes and scores within one unit of their
    third decimal), and ``/api/info`` reports the model."""
    model_dir, state = seed0_model_dir(tmp_path)
    variables = jax_variables(state)
    dataset, run = server._make_predictor(PORT_CFG / TINY, model_dir,
                                          device="cpu")
    assert "viewer: loaded checkpoint at step 0" in capsys.readouterr().out
    monkeypatch.setattr(jax_train, "init_state",
                        lambda bundle: (dict(variables), None))
    _, ref_run = jax_server._make_predictor(JAX_CFG / TINY, tmp_path / "ref")
    saved = dict(server._STATE)
    server._STATE.update(dataset=dataset, classes=dataset._class_names,
                         predict=run)
    url, httpd = serve(server)
    try:
        assert json.loads(_get(url + "/api/info")[1])["has_model"] is True
        got = [json.loads(_get(url + f"/api/detect?idx={i}")[1])
               for i in range(2)]
        assert json.loads(_get(url + "/api/detect?idx=0")[1]) == got[0]
        code, body = _error(url + "/api/detect?idx=x")
        assert code == 500 and b"error" in body
    finally:
        httpd.shutdown()
        server._STATE.clear()
        server._STATE.update(saved)
    want = [ref_run(i) for i in range(2)]
    assert sum(len(d["scores"]) for d in want) > 10
    diff = detections_mismatch(padded(got), padded(want), 3,
                               box_atol=DET_ATOL, score_atol=DET_ATOL)
    assert diff is None, diff


def test_module_runs_as_a_script():
    """``python -m ...viewer.server --help`` (README's command) names
    ``--device``."""
    out = subprocess.run(
        [sys.executable, "-m",
         "automatic_as_built_reconstruction_tpu_torch.viewer.server",
         "--help"], capture_output=True, text=True, timeout=120, check=True)
    assert "--device" in out.stdout and "--model_dir" in out.stdout
