"""The port runs on a machine without JAX: no module of ``nezha_tpu_torch``,
nor ``chip_smoke.py``, nor a tool that drives the port, may import
``jax`` or the JAX package ``nezha_tpu`` (not even a module of it that
does not import JAX itself). Checked on the source with ``ast``, at any
depth (a function-level import counts), without importing anything."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "nezha_tpu")


def _port_files():
    for dirpath, _, names in os.walk(os.path.join(ROOT, "nezha_tpu_torch")):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    tools = os.path.join(ROOT, "tools")
    for name in sorted(os.listdir(tools)):
        path = os.path.join(tools, name)
        if name.endswith(".py"):
            with open(path) as f:
                if "nezha_tpu_torch" in f.read():
                    yield path


def _imported_roots(tree: ast.AST):
    """(line, top-level module) of every import in the tree; relative
    imports stay inside their package and are skipped."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value.split(".")[0]


PORT_FILES = sorted(os.path.relpath(p, ROOT) for p in _port_files())


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_no_jax(rel):
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), filename=rel)
    bad = [(line, mod) for line, mod in _imported_roots(tree)
           if mod in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_the_guard_sees_the_port_and_catches_an_import():
    assert "chip_smoke.py" in PORT_FILES
    assert os.path.join("nezha_tpu_torch", "models", "bert.py") in PORT_FILES
    assert len(PORT_FILES) > 50
    src = ("import nezha_tpu_torch.ops\n"
           "def f():\n    from nezha_tpu.ops import gelu\n"
           "import importlib\nimportlib.import_module('jax.numpy')\n")
    roots = [mod for _, mod in _imported_roots(ast.parse(src))]
    assert [m for m in roots if m in FORBIDDEN] == ["nezha_tpu", "jax"]


# The data path, checkpoints and the CLIs around them. The port depends
# on torch and numpy alone: none of it imports ``regex`` (the JAX
# tokenizer's) or ``transformers`` (the ``--hf-dir`` path's), except the
# one module that reads and writes Hugging Face checkpoints. The card
# has transformers 5.5.0 and this machine 4.57, so its use stays in that
# module, imported only when called.
TRANSFORMERS_ALLOWED = (os.path.join("nezha_tpu_torch", "models", "hf.py"),)
DATA_PATH_MODULES = ("data/tokenizer.py", "data/bpe_train.py",
                     "data/pack.py", "data/native.py", "data/mlm.py",
                     "train/checkpoint.py", "cli/pack_text.py")


@pytest.mark.parametrize("rel", DATA_PATH_MODULES)
def test_data_path_modules_are_guarded(rel):
    assert os.path.join("nezha_tpu_torch", *rel.split("/")) in PORT_FILES


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_needs_no_package_the_card_lacks(rel):
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), filename=rel)
    banned = ("regex",) if rel in TRANSFORMERS_ALLOWED else (
        "regex", "transformers")
    bad = [(line, mod) for line, mod in _imported_roots(tree)
           if mod in banned]
    assert not bad, f"{rel} imports {bad}"


# Multi-process training: the coordinator's binding, the process group's
# start, the collectives, dp, ZeRO-1, the int8 wire and the per-shard
# checkpoints; and the test worker that runs them in child processes.
DIST_MODULES = ("dist/__init__.py", "dist/native.py", "dist/coordinator.py",
                "dist/launch.py", "parallel/collectives.py",
                "parallel/data_parallel.py", "parallel/zero1.py",
                "parallel/quantized.py", "train/sharded_checkpoint.py")


@pytest.mark.parametrize("rel", DIST_MODULES)
def test_dist_modules_are_guarded(rel):
    assert os.path.join("nezha_tpu_torch", *rel.split("/")) in PORT_FILES


def test_dist_test_worker_imports_no_jax():
    rel = os.path.join("tests", "torch_dist_worker.py")
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), filename=rel)
    bad = [(line, mod) for line, mod in _imported_roots(tree)
           if mod in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


# Single-device serving: the engine (speculative decoding, the dense
# layout), its pools (the host tier, the block wire's export and
# install), the sampling pieces, the scheduler (WFQ lanes, tenant caps,
# preemption, the park), the wire and the CLI over them.
SERVE_MODULES = ("serve/engine.py", "serve/scheduler.py", "serve/slots.py",
                 "serve/sampling.py", "serve/migrate.py", "cli/serve.py",
                 "models/gpt2.py")


@pytest.mark.parametrize("rel", SERVE_MODULES)
def test_serve_modules_are_guarded(rel):
    path = os.path.join("nezha_tpu_torch", *rel.split("/"))
    assert path in PORT_FILES
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    assert not [mod for _, mod in _imported_roots(tree) if mod in FORBIDDEN]


def test_the_wire_module_speaks_to_jax_without_importing_it():
    """``serve/migrate.py`` is byte-compatible with JAX's wire, yet a copy
    of its own: it imports the standard library, numpy and the port,
    nothing of ``jax`` or ``nezha_tpu``, at any depth."""
    path = os.path.join("nezha_tpu_torch", "serve", "migrate.py")
    assert path in PORT_FILES
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = {mod for _, mod in _imported_roots(tree)}
    assert roots <= {"__future__", "base64", "http", "json", "time",
                     "typing", "numpy", "nezha_tpu_torch"}, roots
    assert not roots & set(FORBIDDEN)


# The train side's telemetry, the run-dir report and its schema check,
# and the fleet view: the port's own copies, stdlib only beside the
# port's obs modules (a run dir renders wherever it is copied).
TELEMETRY_MODULES = ("utils/logging.py", "obs/report.py",
                     "analysis/telemetry_schema.py", "cli/telemetry.py",
                     "cli/top.py")
STDLIB = {"__future__", "argparse", "json", "logging", "os", "re", "sys",
          "time", "typing", "urllib"}


@pytest.mark.parametrize("rel", TELEMETRY_MODULES)
def test_telemetry_modules_import_no_jax_and_no_torch(rel):
    path = os.path.join("nezha_tpu_torch", *rel.split("/"))
    assert path in PORT_FILES
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = {mod for _, mod in _imported_roots(tree)}
    assert not roots & set(FORBIDDEN), roots
    assert roots <= STDLIB | {"nezha_tpu_torch"}, roots
    port = {node.module for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module
            and node.module.startswith("nezha_tpu_torch")}
    assert port <= {"nezha_tpu_torch.obs.metrics",
                    "nezha_tpu_torch.obs.registry",
                    "nezha_tpu_torch.obs.sink", "nezha_tpu_torch.obs.slo",
                    "nezha_tpu_torch.obs.report",
                    "nezha_tpu_torch.obs.timeseries",
                    "nezha_tpu_torch.analysis.telemetry_schema"}, port
