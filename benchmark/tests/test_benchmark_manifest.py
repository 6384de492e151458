"""``BENCHMARK.json`` and the files it names: names and units of the
allowed characters, every configuration, cell and per-layer metric a file
of its own that the harness finds by name, and no import of JAX or the
JAX package anywhere in ``benchmark/``, none of the port in the
reference."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PORT = "automatic_as_built_reconstruction_tpu_torch"
JAX_NAMES = {"jax", "jaxlib", "flax", "automatic_as_built_reconstruction_tpu"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.fullmatch(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.fullmatch(entry["unit"]), entry["unit"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))
    for w in MANIFEST["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    files = harness.cell_files(cell)
    assert files["workload"]["config"] == entry["config"]
    assert files["workload"]["traffic"] == entry["traffic"]
    assert files["workload"]["chips"] == entry["chips"]
    assert (BENCH / f"{files['workload']['entry']}.py").is_file()
    conf = next(c for c in MANIFEST["configs"]
                if c["name"] == entry["config"])
    assert (ROOT / conf["file"]).is_file()
    assert files["config"]["reduced"] == conf["reduced"]
    reported = {m["name"] for m in MANIFEST["end_to_end"]
                if cell in m.get("workloads", [cell])}
    assert "setup_s" in reported and len(reported) >= 2
    layer = [m for m in MANIFEST["per_layer"]
             if cell in m.get("workloads", [cell])]
    assert layer
    for m in layer:
        assert m["moves"] in reported
        reader = harness.load_reader(m["name"])
        assert callable(reader.read)


def test_every_file_is_named():
    for conf in MANIFEST["configs"]:
        assert Path(conf["file"]).parts[0] in MANIFEST["paths"]
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_in_benchmark_sources():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in JAX_NAMES, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".", 1)[0] != PORT, (path, name)
    code = ("import sys; import benchmark.reference.compare, "
            "benchmark.reference.network, benchmark.reference.postprocess, "
            "benchmark.reference.voxelize, benchmark.reference.checkpoint; "
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert PORT not in loaded and not loaded & JAX_NAMES


def test_harness_loads_no_jax():
    """What a run imports, the port's serving path included (no card
    needed to import it)."""
    code = ("import sys; from benchmark import harness, serve, control, "
            "weights, tracing, roofline; "
            "from automatic_as_built_reconstruction_tpu_torch.parallel "
            "import inference; "
            "[harness.load_reader(m['name']) for m in "
            "harness.load_json(harness.ROOT / 'BENCHMARK.json')"
            "['per_layer']]; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compared_whole():
    names = [PORT, f"{PORT}.ops.nms", "jaxtyping", "flaxen.x",
             "jax.numpy", "automatic_as_built_reconstruction_tpu.models",
             "flax"]
    assert harness.forbidden_modules(names) == [
        "automatic_as_built_reconstruction_tpu.models", "flax", "jax.numpy"]


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout
