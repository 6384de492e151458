"""Viewer backend.

    python -m automatic_as_built_reconstruction_tpu_torch.viewer.server \
        --config_path <cfg> [--model_dir <dir>] [--port 8090] \
        [--device cuda|cpu]

Endpoints:
    GET /                     -> the single-file BEV viewer
    GET /api/info             -> dataset size, classes
    GET /api/scene?idx=N      -> points (subsampled) + gt boxes
    GET /api/detect?idx=N     -> detections from the loaded checkpoint

The port's copy of the JAX package's ``viewer/server.py``: the same
endpoints and JSON.  The detector runs on ``--device`` (``cuda`` by
default, which raises without a GPU; ``cpu`` only when asked for).
"""
from __future__ import annotations

import argparse
import functools
import json
import pathlib
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_STATE = {}


def _jsonable(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    raise TypeError(type(o))


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, body: bytes, ctype="application/json", code=200):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        q = parse_qs(url.query)
        try:
            if url.path == "/":
                html = (pathlib.Path(__file__).parent / "index.html"
                        ).read_bytes()
                self._send(html, "text/html")
            elif url.path == "/api/info":
                ds = _STATE["dataset"]
                self._send(json.dumps({
                    "num_scenes": len(ds),
                    "classes": list(_STATE["classes"]),
                    "has_model": _STATE.get("predict") is not None,
                }).encode())
            elif url.path == "/api/scene":
                idx = int(q.get("idx", ["0"])[0])
                sd = _STATE["dataset"].get_sensor_data(idx)
                pts = np.asarray(sd["lidar"]["points"], np.float32)
                if len(pts) > 60000:
                    sel = np.random.default_rng(0).choice(
                        len(pts), 60000, replace=False)
                    pts = pts[sel]
                out = {"points": np.round(pts[:, :3], 3)}
                if "annotations" in sd:
                    out["gt_boxes"] = np.round(
                        np.asarray(sd["annotations"]["boxes"], np.float64), 3)
                    out["gt_names"] = list(map(str,
                                               sd["annotations"]["names"]))
                self._send(json.dumps(out, default=_jsonable).encode())
            elif url.path == "/api/detect":
                if _STATE.get("predict") is None:
                    self._send(b'{"error": "no model loaded"}', code=400)
                    return
                idx = int(q.get("idx", ["0"])[0])
                dets = _STATE["predict"](idx)
                self._send(json.dumps(dets, default=_jsonable).encode())
            else:
                self._send(b"not found", "text/plain", 404)
        except Exception as e:  # surface errors to the client
            self._send(json.dumps({"error": str(e)}).encode(), code=500)


def _make_predictor(config_path, model_dir, device="cuda"):
    """-> (the eval split's dataset, ``run(idx)``): the detections of eval
    scene ``idx`` from the latest checkpoint in ``model_dir`` (the seed-0
    initial weights where it holds none) on ``device``, as host arrays
    (``boxes`` and ``scores`` rounded to 3 decimals, ``labels``); the last
    32 scenes' detections are cached.  ``run.raw(idx)`` runs the scene
    again and gives its detections unrounded, as ``predict`` names them
    (``box3d_lidar``, ``scores``, ``label_preds``)."""
    import torch

    from ..data import batching
    from ..device import resolve_device
    from ..train import checkpoint as ckpt_mod
    from ..train import train as train_mod

    dev = resolve_device(device)
    bundle = train_mod.Bundle(config_path)
    prep_ds, _ = bundle.input_reader(training=False)
    state = train_mod.init_state(bundle, device=dev)
    restored, step = ckpt_mod.try_restore_latest(model_dir, state)
    if restored is not None:
        state = restored
        print(f"viewer: loaded checkpoint at step {step}")
    # init_state leaves the model in train mode: the BatchNorms must use
    # their running statistics here
    state.model.eval()
    predict_fn = train_mod.make_predict_fn(bundle)
    lock = threading.Lock()

    def raw(idx: int) -> dict:
        with lock, torch.no_grad():
            ex = prep_ds.example(idx, seed=0)
            batch = batching.merge_batch([ex])
            out = {k: v.cpu().numpy() for k, v in
                   predict_fn(train_mod.to_device(batch, dev)).items()}
        v = out["valid"][0]
        return {k: out[k][0][v]
                for k in ("box3d_lidar", "scores", "label_preds")}

    @functools.lru_cache(maxsize=32)
    def run(idx: int):
        dets = raw(idx)
        return {
            "boxes": np.round(dets["box3d_lidar"], 3),
            "scores": np.round(dets["scores"], 3),
            "labels": dets["label_preds"],
        }

    run.raw = raw
    return prep_ds.dataset, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--model_dir", default=None)
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--device", default="cuda",
                    help="where the detector runs: 'cuda' (raises without a "
                         "GPU) or 'cpu'")
    args = ap.parse_args(argv)

    if args.model_dir:
        dataset, predict = _make_predictor(args.config_path, args.model_dir,
                                           device=args.device)
        _STATE["predict"] = predict
    else:
        from ..train import train as train_mod
        bundle = train_mod.Bundle(args.config_path)
        prep_ds, _ = bundle.input_reader(training=False)
        dataset = prep_ds.dataset
        _STATE["predict"] = None
    _STATE["dataset"] = dataset
    _STATE["classes"] = getattr(dataset, "_class_names", ["Car"])

    server = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    print(f"viewer listening on http://localhost:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
