"""Every twin in place: the port ``src/repro_torch`` against the reference
``src/repro``, both read with ``ast`` (neither is imported for the walk).

- every module of the reference has a twin at the same path in the port;
- every public top-level function and class of a reference module, every
  public method of a public class and every field of its body (a dataclass
  or ``NamedTuple`` field) has a twin of the same name there (a twin may
  be a ``def``, a ``class``, an assignment or an import; a method may come
  from a base class of the same module);
- every reference package's ``__all__`` is contained in its twin's;
- every public function and public method (``__init__`` included) whose
  twin is a ``def`` of the same name takes the reference's parameters:
  each under its name, of its kind (positional, positional or keyword,
  ``*``, keyword-only, ``**``), the positional ones at their place; a
  parameter the port adds is named too (``f(+name)``);
- every function of ``src/repro/kernels/`` whose body holds a
  ``pl.pallas_call`` (the sites of ``PERF.md``'s kernel table) has a
  ``repro_torch::<name>`` custom op defined in ``kernels/ops.py``.

The port's departures are the ``DEPARTURES`` below (by dotted name, a
parameter as ``f(name)``) and the ``PARAMETER_DEPARTURES`` (a parameter
name wherever it appears: the Pallas tuning arguments, the port's
``device``), each with its reason (ROADMAP Queue 3 lists them); an entry
that no longer matches a missing twin fails, so the list cannot outlive
what it excuses.  ``test_walker_reports_each_fault`` runs the walker on
small synthetic trees, so the test cannot pass vacuously.
"""

import ast
import pathlib
import re

import pytest

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

_SHARDINGS = "a JAX NamedSharding; the port's FleetMesh is a tuple of torch devices and places a Shards tuple"
_ABSTRACT = ("a jax.ShapeDtypeStruct tree; the port's dry run traces fake tensors "
             "(train_step.abstract_state, sharding.empty_placed)")
_HLO = "parses compiled HLO text; the port's twin is collectives.CollectiveCounter, which counts the traced collectives"
DEPARTURES = {
    "repro.core.batched_engine": "the reference's deprecation shim over core.engine; nothing is owed for it",
    "repro.distributed.compat": "a shim over JAX API versions (shard_map, AbstractMesh); nothing is owed for it",
    "repro.kernels.compat": "a shim over JAX/Pallas API versions (CompilerParams, cost_analysis); nothing is owed for it",
    "repro.core.sessions.base.FleetSession.compile_counts": (
        "reports jit cache sizes; the port's stand-in is buffer_pointers, no build after warmup() and the "
        "sync-debug gate (core/sessions/base.py)"),
    "repro.distributed.sharding.FleetMesh.mesh": "a jax.sharding.Mesh; the port's FleetMesh is a tuple of torch devices",
    "repro.distributed.sharding.FleetMesh.node_sharding": _SHARDINGS,
    "repro.distributed.sharding.FleetMesh.replicated_sharding": _SHARDINGS,
    "repro.models.common.abstract": _ABSTRACT,
    "repro.models.common.is_param": "the jax.tree is_leaf predicate of abstract's Param trees",
    "repro.models.model_zoo.TensorSpec.abstract": _ABSTRACT,
    "repro.models.model_zoo.is_spec": "the jax.tree is_leaf predicate of spec_abstract's and spec_logical's trees",
    "repro.models.model_zoo.spec_abstract": _ABSTRACT,
    "repro.models.model_zoo.spec_logical": "maps a TensorSpec tree with jax.tree; the port reads TensorSpec.axes",
    "repro.distributed.collectives.collective_bytes": _HLO,
    "repro.distributed.collectives.collective_bytes_from_compiled": _HLO,
    "repro.distributed.collectives.collective_bytes_structured": _HLO,
    "repro.core.engine.Array": "the type alias jax.Array",
    "repro.distributed.collectives.compressed_psum(axis_name)": (
        "names a vmap/shard_map axis; the port reduces over a torch.distributed process group, its (+group)"),
    "repro.distributed.collectives.compressed_psum(+group)": (
        "the process group of the reduction, the twin of the reference's named axis (axis_name)"),
    "repro.models.common.materialize(+trainable)": (
        "makes the fp32 masters of the training path require grad; a JAX tree carries no gradient flag"),
    "repro.models.mlp.mlp_apply(+d_ff)": (
        "the MLP's hidden width, so that a narrower weight is read as this rank's 'model' block (tensor parallelism)"),
    "repro.launch.dryrun.lower_cell(+mesh)": (
        "the mesh to trace on (the pod, the multipod, a card's (1, 1) or a small fake world); the reference's "
        "is fixed by multi_pod"),
    "repro.training.train_step.jit_train_step(+accum_steps)": (
        "make_train_step's gradient accumulation, which the dry run's cells pass through"),
    "repro.training.train_step.jit_train_step(+cast_params)": (
        "make_train_step's bf16 compute copy of the masters, which the dry run's cells pass through"),
    "repro.models.common.cross_entropy_loss(+padded_vocab)": (
        "the model's padded vocabulary, so that narrower logits are read as a vocab-parallel block"),
    "repro.models.common.chunked_lm_loss(+padded_vocab)": (
        "the model's padded vocabulary, so that a narrower unembedding is read as a vocab-parallel block"),
}
_PALLAS = "a Pallas tuning argument (grid blocks, interpret mode); the CUDA kernel plans its own launch"
_KEY = "a jax.random key; the port draws from a torch.Generator, its (+generator)"
#: Parameter names excused wherever they appear: ``name`` a reference
#: parameter the port does not take, ``+name`` one the port adds.
PARAMETER_DEPARTURES = {
    "interpret": _PALLAS,
    "q_block": _PALLAS,
    "kv_block": _PALLAS,
    "n_block": _PALLAS,
    "row_block": _PALLAS,
    "rng": _KEY,
    "+generator": "a torch.Generator, the twin of the reference's jax.random key (rng)",
    "+device": "the torch device the entry point runs on (the card unless the caller asks for the CPU)",
    "+device_type": "the torch device type of a DeviceMesh (cuda on the card, cpu in the gloo tests)",
    "+lse": "the kernel's optional log-sum-exp store (the flash VJP, the kv_seq merge); the reference returns none",
    "+return_lse": "the plain version's log-sum-exp, the oracle of the kernels' lse store",
    "+argv": "the launcher's argument list (sys.argv when None), so that tests and chip_smoke.py call it in-process",
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _body(nodes):
    """Statements of a module or class body, those under a top-level
    ``if`` or ``try`` included."""
    for node in nodes:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _body(node.body + node.orelse + getattr(node, "finalbody", []))
            for handler in getattr(node, "handlers", []):
                yield from _body(handler.body)
        else:
            yield node


def _bound(node) -> list:
    """Names a statement binds in its scope."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)]
    if isinstance(node, (ast.AnnAssign, ast.AugAssign)) and isinstance(node.target, ast.Name):
        return [node.target.id]
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return [(a.asname or a.name).split(".")[0] for a in node.names]
    return []


def _members(cls: ast.ClassDef) -> set:
    return {name for node in _body(cls.body) for name in _bound(node)}


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _module_name(root: pathlib.Path, path: pathlib.Path, package: str) -> str:
    parts = list(path.relative_to(root).with_suffix("").parts)
    return ".".join([package] + (parts[:-1] if parts[-1] == "__init__" else parts))


def reference_names(tree: ast.Module) -> dict:
    """Public top-level functions and classes -> for a public class its
    public methods and fields (members of its body), else None."""
    out = {}
    for node in _body(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            out[node.name] = None
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out[node.name] = {m for m in _members(node) if _public(m)}
    return out


def twin_names(tree: ast.Module) -> dict:
    """Every name a module binds -> for a class the names its body and its
    bases of the same module bind, else None."""
    classes = {node.name: node for node in _body(tree.body) if isinstance(node, ast.ClassDef)}

    def members(cls, seen=()):
        out = _members(cls)
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes and base.id not in seen:
                out |= members(classes[base.id], seen + (cls.name,))
        return out

    out = {}
    for node in _body(tree.body):
        for name in _bound(node):
            out[name] = members(node) if isinstance(node, ast.ClassDef) else None
    return out


def exports(tree: ast.Module):
    """A module's ``__all__`` as a set, or None where it has none."""
    for node in _body(tree.body):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def module_gaps(ref_root: pathlib.Path, port_root: pathlib.Path, rel: pathlib.Path, package: str) -> set:
    """Dotted names (under ``package``) of reference module ``rel`` that
    have no twin: the module itself, or its names, members and exports."""
    name = _module_name(ref_root, ref_root / rel, package)
    twin = port_root / rel
    if not twin.exists():
        return {name}
    ref_tree, port_tree = _tree(ref_root / rel), _tree(twin)
    have = twin_names(port_tree)
    gaps = set()
    for fn, members in reference_names(ref_tree).items():
        if fn not in have:
            gaps.add(f"{name}.{fn}")
        elif members:
            gaps |= {f"{name}.{fn}.{m}" for m in members - (have[fn] or set())}
    want = exports(ref_tree)
    if want is not None:
        gaps |= {f"{name}.{e}" for e in want - (exports(port_tree) or set())}
    return gaps | signature_gaps(name, ref_tree, port_tree)


_KINDS = {"posonlyargs": "positional", "args": "positional or keyword", "kwonlyargs": "keyword"}
_POSITIONAL = ("positional", "positional or keyword")


def parameters(fn) -> list:
    """(name, kind) of each parameter of a ``def``, in order."""
    a = fn.args
    out = [(x.arg, _KINDS["posonlyargs"]) for x in a.posonlyargs] + [(x.arg, _KINDS["args"]) for x in a.args]
    if a.vararg:
        out.append((a.vararg.arg, "*"))
    out += [(x.arg, _KINDS["kwonlyargs"]) for x in a.kwonlyargs]
    if a.kwarg:
        out.append((a.kwarg.arg, "**"))
    return out


def _defs(tree: ast.Module) -> dict:
    """Top-level functions and the methods of top-level classes ->
    their ``def`` node, keyed ``f`` and ``C.m``."""
    out = {}
    for node in _body(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for member in _body(node.body):
                if isinstance(member, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{member.name}"] = member
    return out


def signature_gaps(name: str, ref_tree: ast.Module, port_tree: ast.Module) -> set:
    """``name.f(p)`` for each parameter ``p`` of a public reference
    function or method (``__init__`` included) that its ``def`` twin does
    not take by the same name and kind, positional ones at the same place;
    ``name.f(+p)`` for each parameter that the twin adds."""
    port = _defs(port_tree)
    gaps = set()
    for key, fn in _defs(ref_tree).items():
        if key not in port or any(not _public(part) for part in key.split(".") if part != "__init__"):
            continue
        want, have = parameters(fn), parameters(port[key])
        have_kind = dict(have)
        want_pos = [n for n, k in want if k in _POSITIONAL]
        have_pos = [n for n, k in have if k in _POSITIONAL]
        for n, k in want:
            moved = k in _POSITIONAL and (n not in have_pos or have_pos.index(n) != want_pos.index(n))
            if have_kind.get(n) != k or moved:
                gaps.add(f"{name}.{key}({n})")
        gaps |= {f"{name}.{key}(+{n})" for n, _ in have if n not in dict(want)}
    return gaps


def _parameter(gap: str) -> str | None:
    """The parameter part of a gap (``p`` or ``+p``), or None."""
    m = re.search(r"\((\+?\w+)\)$", gap)
    return m.group(1) if m else None


def excused(gap: str, departures: dict, parameter_departures: dict) -> bool:
    return gap in departures or _parameter(gap) in parameter_departures


def reference_modules(ref_root: pathlib.Path) -> list:
    return sorted(p.relative_to(ref_root) for p in ref_root.rglob("*.py"))


def gaps(ref_root: pathlib.Path, port_root: pathlib.Path, package: str) -> set:
    """Every dotted name of the reference tree without a twin."""
    return set().union(*(module_gaps(ref_root, port_root, rel, package) for rel in reference_modules(ref_root)))


def problems(found: set, departures: dict, parameter_departures: dict | None = None) -> list:
    """Gaps that no departure excuses, and departures that excuse nothing."""
    by_name = parameter_departures or {}
    used = {_parameter(g) for g in found}
    return ([f"no twin: {g}" for g in sorted(found) if not excused(g, departures, by_name)]
            + [f"stale departure: {d}" for d in sorted(departures.keys() - found)]
            + [f"stale parameter departure: {p}" for p in sorted(by_name.keys() - used)])


def pallas_functions(kernels_dir: pathlib.Path) -> set:
    """The top-level functions of ``kernels_dir`` whose bodies hold a
    ``pallas_call``."""
    out = set()
    for path in sorted(kernels_dir.glob("*.py")):
        for node in _body(_tree(path).body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and any(
                    isinstance(c, ast.Call) and (getattr(c.func, "attr", None) == "pallas_call"
                                                 or getattr(c.func, "id", None) == "pallas_call")
                    for c in ast.walk(node)):
                out.add(node.name)
    return out


def custom_ops(ops_path: pathlib.Path, namespace: str = "repro_torch") -> set:
    """The ops a ``torch.library.Library(namespace, "DEF")`` defines in
    ``ops_path`` (``_lib.define("name(...) -> ...")``), and any
    ``"namespace::name"`` string."""
    out = set()
    for node in ast.walk(_tree(ops_path)):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "define" and node.args
                and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            out.add(node.args[0].value.split("(")[0].strip())
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            m = re.fullmatch(rf"{namespace}::(\w+)", node.value)
            if m:
                out.add(m.group(1))
    return out


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", reference_modules(REF), ids=str)
def test_module_twins(rel):
    """The module's twin, its names and members (for a package, its
    ``__all__`` inside the twin's), but for the listed departures."""
    unexcused = sorted(g for g in module_gaps(REF, PORT, rel, "repro")
                       if not excused(g, DEPARTURES, PARAMETER_DEPARTURES))
    assert not unexcused, f"{rel}: no twin in src/repro_torch for {unexcused}"


def test_no_stale_departure():
    stale = [p for p in problems(gaps(REF, PORT, "repro"), DEPARTURES, PARAMETER_DEPARTURES)
             if p.startswith("stale")]
    assert not stale, stale


def test_every_departure_has_a_reason():
    reasons = list(DEPARTURES.values()) + list(PARAMETER_DEPARTURES.values())
    assert all(isinstance(r, str) and len(r) > 20 for r in reasons)


def test_every_pallas_kernel_has_a_custom_op():
    kernels = pallas_functions(REF / "kernels")
    assert kernels, "the walk found no pallas_call in src/repro/kernels"
    missing = sorted(kernels - custom_ops(PORT / "kernels" / "ops.py"))
    assert not missing, f"no repro_torch:: custom op for the Pallas kernels {missing}"


# ---------------------------------------------------------------------------
# The walker on synthetic trees
# ---------------------------------------------------------------------------


def _write(root: pathlib.Path, files: dict) -> pathlib.Path:
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return root


def test_walker_reports_each_fault(tmp_path):
    """A missing function, method, field, export and module, a parameter
    missing, of another kind, moved or added, and a stale departure, each
    reported by name; a complete twin reports nothing."""
    ref = _write(tmp_path / "ref", {
        "__init__.py": "from .a import f, g\n__all__ = ['f', 'g']\n",
        "a.py": ("import dataclasses\n\n"
                 "def f(x, y=1, *, flag=True):\n    pass\n\n"
                 "def k(a, b):\n    pass\n\n"
                 "def g():\n    pass\n\n"
                 "def _private():\n    pass\n\n"
                 "@dataclasses.dataclass\nclass C:\n    x: int = 0\n    y: int = 0\n\n"
                 "    def m(self):\n        pass\n\n"
                 "    def n(self):\n        pass\n"),
        "b.py": "def h():\n    pass\n",
    })
    port = _write(tmp_path / "port", {
        "__init__.py": "from .a import f\n__all__ = ['f']\n",
        "a.py": ("class Base:\n    def m(self):\n        pass\n\n"
                 "class C(Base):\n    x: int = 0\n\n"
                 "def f(x, *, y=1, extra=None):\n    pass\n\n"
                 "def k(b, a):\n    pass\n"),
    })
    found = gaps(ref, port, "pkg")
    assert found == {"pkg.g", "pkg.a.g", "pkg.a.C.y", "pkg.a.C.n", "pkg.b", "pkg.a.f(y)", "pkg.a.f(flag)",
                     "pkg.a.f(+extra)", "pkg.a.k(a)", "pkg.a.k(b)"}, found
    assert problems(found, {"pkg.b": "a shim", "pkg.zzz": "excuses nothing", "pkg.a.f(flag)": "a Pallas flag"},
                    {"+extra": "the port's", "+zzz": "excuses nothing"}) == [
        "no twin: pkg.a.C.n", "no twin: pkg.a.C.y", "no twin: pkg.a.f(y)", "no twin: pkg.a.g", "no twin: pkg.a.k(a)",
        "no twin: pkg.a.k(b)", "no twin: pkg.g", "stale departure: pkg.zzz", "stale parameter departure: +zzz"]
    kernels = _write(tmp_path / "kernels", {
        "k.py": "def kern(x):\n    return pl.pallas_call(body)(x)\n\ndef other(x):\n    return kern(x)\n",
        "ops.py": "_lib.define('other_op(Tensor x) -> Tensor')\nOP = 'repro_torch::third'\n",
    })
    assert pallas_functions(kernels) == {"kern"}
    assert custom_ops(kernels / "ops.py") == {"other_op", "third"}
    assert pallas_functions(kernels) - custom_ops(kernels / "ops.py") == {"kern"}

    _write(port, {"b.py": "from .a import f as h\n",
                  "__init__.py": "from .a import f, g\n__all__ = ['f', 'g', 'extra']\n",
                  "a.py": ("class C:\n    x: int = 0\n    y = 1\n\n    def m(self):\n        pass\n\n"
                           "    n = m\n\ndef f(x, y=1, *, flag=True, device=None):\n    pass\n\ng = f\n\n"
                           "def k(a, b):\n    pass\n")})
    assert gaps(ref, port, "pkg") == {"pkg.a.f(+device)"}
    assert problems({"pkg.a.f(+device)"}, {}, {"+device": "the port's"}) == []
    assert problems(set(), {}) == []
