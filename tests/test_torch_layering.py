"""The port's own structural checks, over the AST of every module of
``src/repro_torch`` and of the example twins in ``examples_torch/``
(nothing is imported):

- no module or example twin imports JAX or the reference package
  ``repro``, not even a module of it that does not import JAX;
- every module has a docstring;
- the layer order of ``PERF.md`` §3 holds — kernels -> core/engine (with
  distributed, the node-axis mesh and the checkpoints, and the models) ->
  core/sessions and training -> core/profiler -> serving — with no import
  from a lower layer into a higher one.  Function-scope imports count too.

``scripts/check_layering.py`` and the ``scripts/ci.sh`` docstring gate walk
only ``src/repro``; this file is their counterpart for the port.
"""

import ast
import pathlib

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"

# Longest-prefix match decides a module's layer; unlisted packages
# (telemetry, workload, data, configs, launch, device, convert) are
# infrastructure shared across layers and not constrained.
LAYERS = {
    "repro_torch.kernels": 0,
    "repro_torch.core.disaggregation": 0,  # pure-math leaf under the solver kernels
    "repro_torch.core.engine": 1,
    "repro_torch.core.kalman": 1,
    "repro_torch.core.contribution": 1,
    "repro_torch.core.cpu_model": 1,
    "repro_torch.core.sync": 1,
    "repro_torch.core.metrics": 1,
    "repro_torch.core.footprints": 1,
    "repro_torch.core.shapley": 1,
    "repro_torch.core.capping": 1,
    "repro_torch.core.pricing": 1,
    "repro_torch.core.baselines": 1,
    "repro_torch.distributed": 1,
    "repro_torch.distributed.tensor_parallel": 1,  # the "model" collectives beside the sharding rules
    "repro_torch.models": 1,
    "repro_torch.core.sessions": 2,
    "repro_torch.training": 2,
    "repro_torch.core.profiler": 3,
    "repro_torch.core": 3,  # the package facade re-exports the profiler
    "repro_torch.serving": 4,
}


def _module_name(path: pathlib.Path) -> str:
    parts = list(path.relative_to(SRC).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


MODULES = {_module_name(p): p for p in sorted(PKG.rglob("*.py"))}


def _layer(mod: str):
    best, best_len = None, -1
    for prefix, layer in LAYERS.items():
        if (mod == prefix or mod.startswith(prefix + ".")) and len(prefix) > best_len:
            best, best_len = layer, len(prefix)
    return best


def _imports(mod: str, tree: ast.AST):
    """Every module name an import statement of ``tree`` targets (``from
    pkg import sub`` counts as ``pkg.sub`` when that is a module)."""
    package = mod if MODULES[mod].name == "__init__.py" else mod.rpartition(".")[0]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(parent + ([base] if base else []))
            for alias in node.names:
                sub = f"{base}.{alias.name}"
                yield node.lineno, sub if sub in MODULES else base


def _trees():
    return {mod: ast.parse(path.read_text(), filename=str(path)) for mod, path in MODULES.items()}


def test_no_module_imports_jax_or_the_reference():
    bad = [
        f"{mod}:{line} imports {target}"
        for mod, tree in _trees().items()
        for line, target in _imports(mod, tree)
        if target.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert len(MODULES) > 50 and not bad, bad


def test_example_twins_import_neither_jax_nor_the_reference():
    """The example twins (``examples_torch/``) run on the port alone."""
    scripts = sorted((SRC.parent / "examples_torch").glob("*.py"))
    bad = []
    for path in scripts:
        tree = ast.parse(path.read_text(), filename=str(path))
        assert ast.get_docstring(tree), path
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{path.name}:{node.lineno} imports {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(scripts) == 5 and not bad, bad


def test_every_module_has_a_docstring():
    missing = [mod for mod, tree in _trees().items() if not ast.get_docstring(tree)]
    assert not missing, missing


def test_layer_order_has_no_upward_import():
    edges, bad = 0, []
    for mod, tree in _trees().items():
        src = _layer(mod)
        if src is None:
            continue
        for line, target in _imports(mod, tree):
            dst = _layer(target)
            if dst is None:
                continue
            edges += 1
            if dst > src:
                bad.append(f"{mod}:{line} (layer {src}) imports {target} (layer {dst})")
    assert edges > 50 and not bad, bad


def test_layer_map_places_this_slices_modules():
    """Each module of this slice sits where its reference twin does and the
    map gives it that twin's layer."""
    expected = {
        "repro_torch.core.engine.targets": 1,
        "repro_torch.core.cpu_model": 1,
        "repro_torch.core.capping": 1,
        "repro_torch.core.sessions.combined": 2,
        "repro_torch.core.sessions.retrain": 2,
        "repro_torch.serving.scheduler": 4,
        "repro_torch.telemetry.counters": None,
    }
    assert {mod: _layer(mod) for mod in expected if mod in MODULES} == expected


def test_layer_map_places_the_elastic_slice():
    """The elastic-serving slice's modules sit where their reference twins
    do: the mesh and the baselines beside the engine stages, the slot pool
    in the session layer, the admission queue in serving."""
    expected = {
        "repro_torch.core.baselines": 1,
        "repro_torch.core.engine.buckets": 1,
        "repro_torch.core.engine.sharding": 1,
        "repro_torch.distributed": 1,
        "repro_torch.distributed.sharding": 1,
        "repro_torch.core.sessions.slots": 2,
        "repro_torch.serving.scheduler": 4,
    }
    assert {mod: _layer(mod) for mod in expected} == expected
    assert all(mod in MODULES for mod in expected)


def test_layer_map_places_the_training_slice():
    """The training slice sits above what it drives: the step loop and the
    optimizer over the models, the checkpoints beside the node-axis mesh in
    ``distributed``."""
    expected = {
        "repro_torch.training": 2,
        "repro_torch.training.optimizer": 2,
        "repro_torch.training.train_step": 2,
        "repro_torch.training.trainer": 2,
        "repro_torch.distributed.checkpoint": 1,
        "repro_torch.models.common": 1,
        "repro_torch.models.model_zoo": 1,
        "repro_torch.kernels.ops": 0,
        "repro_torch.launch.train": None,
    }
    assert {mod: _layer(mod) for mod in expected} == expected
    assert all(mod in MODULES for mod in expected)


def test_layer_map_places_the_tensor_parallel_slice():
    """The "model" collectives sit in layer 1 beside the sharding rules, with
    the models whose products they split; the train step that reads the
    split leaves above them."""
    expected = {
        "repro_torch.distributed.tensor_parallel": 1,
        "repro_torch.distributed.sharding": 1,
        "repro_torch.models.attention": 1,
        "repro_torch.models.mlp": 1,
        "repro_torch.models.common": 1,
        "repro_torch.training.train_step": 2,
    }
    assert {mod: _layer(mod) for mod in expected} == expected
    assert all(mod in MODULES for mod in expected)


def test_layer_map_places_the_distributed_slice():
    """The distributed slice: the rules, the collectives and the MoE
    block's EP path in layer 1 beside the models that call them, the
    placement in the training layer, the launchers' meshes and costs in
    ``launch`` (infrastructure)."""
    expected = {
        "repro_torch.distributed.sharding": 1,
        "repro_torch.distributed.collectives": 1,
        "repro_torch.models.moe": 1,
        "repro_torch.training.train_step": 2,
        "repro_torch.launch.mesh": None,
        "repro_torch.launch.costs": None,
        "repro_torch.version": None,
    }
    assert {mod: _layer(mod) for mod in expected} == expected
    assert all(mod in MODULES for mod in expected)


def test_launch_costs_imports_only_the_configs():
    """``launch.costs`` is analytic: besides the standard library it
    imports only ``repro_torch.configs``, as the reference's imports only
    its configs."""
    mod = "repro_torch.launch.costs"
    targets = {t for _, t in _imports(mod, ast.parse(MODULES[mod].read_text()))}
    port = {t for t in targets if t.split(".")[0] == "repro_torch"}
    assert port and all(t.startswith("repro_torch.configs") for t in port), port
    assert targets - port <= {"__future__", "dataclasses"}, targets - port
