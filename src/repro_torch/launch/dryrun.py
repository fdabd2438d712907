"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors
-- the twin of the reference's ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell with ``jax.jit(...).lower`` on
512 placeholder host devices and reads XLA's memory and cost analyses and
the collectives of the compiled HLO.  Torch has no compiled program to
read, so the port runs the card's program itself, once, on fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage) in a fake world of the
mesh's size (``launch.mesh.fake_process_group``: rank 0 of 256 or 512 ranks
that exchange nothing), and counts what the program does while it runs:

- the program is the card's: device "cuda" (fake CPU tensors on torch built
  without CUDA, which cannot run autograd on fake CUDA tensors), the rule
  context ``use_rules(mesh, rules)``, the hand kernels as the
  ``repro_torch::`` custom ops (``kernels.ops``), whose fake
  implementations give shapes alone -- nothing is built or launched;
- train cells run ``jit_train_step``'s placed step on this rank's fake
  blocks of the state and batch (``sharding.empty_placed`` of
  ``abstract_with_sharding`` specs); prefill and decode cells run this
  rank's local program under ``SERVE_RULES``: the parameters and the decode
  cache read through ``sharding.local_view(split=...)``, which keeps the
  batch blocks and the "model" blocks of the split leaves
  (``models.common.split_mask``: the attention, MLP, embedding and
  unembedding weights, the Mamba2 and mLSTM blocks and the sLSTM's input
  product, the attention caches, the int8 cache's scales and the
  recurrent states on heads or channels, read where they lie) and
  gathers the rest; the products split over "model"
  (``distributed.tensor_parallel``), as the train cells' do;
- ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the whole step, every layer and the recompute of remat included.  It is
  not XLA's "body-once" figure: the trace is unrolled;
- ``bytes_per_device``: the eager program's device-memory traffic, each
  non-view op's operands read once and outputs written once;
- ``collective_bytes``: ``distributed.collectives.CollectiveCounter``
  (output bytes by kind and by mesh axis; ``CommDebugMode``'s counts are
  its cross-check, and a cell whose counts disagree fails);
- ``memory``: the arguments (this rank's state and batch blocks, or
  parameters, batch and cache), the outputs, the state the step updates in
  place (``alias_bytes``), and the peak of the storages the step allocates
  above the arguments, counted live as they are made and freed
  (``temp_bytes`` is that peak less the new outputs, so
  ``peak_bytes_est``, the reference's formula, is the arguments plus that
  peak);
- ``kernels``: the custom ops the trace called, by name.

``mesh="local"`` traces on the (1, 1) mesh of a one-rank world, the shape
of a real step on one card (``chip_smoke.py`` holds the trace to one); a
small ("data", "model") shape traces what a few real ranks run (the tests
hold the collective bytes to 2 gloo ranks').

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
import weakref
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, as_completed

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import get_config, get_shape, runnable_cells
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import CollectiveCounter
from repro_torch.kernels import ops  # noqa: F401  (registers the custom ops and their FLOP formulas)
from repro_torch.launch import mesh as meshlib
from repro_torch.models import build
from repro_torch.models.common import ParamTree, keeps_fp32, layer_specs, logical_axes, split_mask, tree_map
from repro_torch.models.common import tree_leaves
from repro_torch.models.model_zoo import TensorSpec, model_flops
from repro_torch.models.transformer import compute_dtype
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import TrainState, abstract_batch, abstract_state, jit_train_step, state_logical

RULES = {"train": shd.TRAIN_RULES, "zero3": shd.ZERO3_RULES, "ep": shd.EP_RULES}


def trace_device() -> str:
    """The fake tensors' device: "cuda" where torch can reach a card,
    "cpu" on torch without one."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return _local(t).untyped_storage()._cdata


def _tensors(x, found: list) -> list:
    """The tensors of an op's arguments or outputs (nested lists, tuples)."""
    if isinstance(x, torch.Tensor):
        found.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, found)
    return found


class _TraceStats(CollectiveCounter):
    """The collective counter, plus: live bytes of the storages the traced
    step allocates (``known``: the arguments' storages, never counted) and
    their peak, each non-view op's operand and output bytes, and the
    ``repro_torch`` custom ops called.  One mode, so each op pays for one
    Python dispatch."""

    def __init__(self, mesh, known: set):
        super().__init__(mesh)
        self.known, self.sizes, self._refs = known, {}, {}
        self.live = self.peak = self.traffic = 0
        self.kernels: Counter = Counter()
        self._is_view: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        view = self._is_view.get(func)
        if view is None:
            view = self._is_view[func] = bool(getattr(func, "is_view", False))
        if getattr(func, "namespace", None) == "repro_torch":
            self.kernels[func._opname] += 1
        outs = _tensors(out, [])
        if not view:
            ins = _tensors(args, _tensors(list(kwargs.values()), []) if kwargs else [])
            self.traffic += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.known or key in self.sizes:
            return
        self.sizes[key] = n = storage.nbytes()
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        self._refs[key] = weakref.ref(storage, lambda _, k=key: self._free(k))

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key, 0)
        self._refs.pop(key, None)


def _serve_param_specs(api) -> dict:
    """The serving weights' specs: the compute dtype, the ``keeps_fp32``
    leaves fp32 (as ``models.common.load_params`` casts them)."""
    cdt = compute_dtype(api.cfg)

    def spec(name, p):
        return TensorSpec(p.shape, torch.float32 if keeps_fp32(name) else cdt, p.axes)

    def walk(node):
        if isinstance(node, list):
            return [walk(x) for x in node]
        return tree_map(lambda name, p: walk(p) if isinstance(p, list) else spec(name, p), node)

    return walk(layer_specs(api.params_def))


def _with_sharding(specs: dict, mesh, rules) -> dict:
    return shd.abstract_with_sharding(specs, {k: s.axes for k, s in specs.items()}, mesh, rules)


def _train_program(api, shape, mesh, rules_name, opt_config, accum_steps, cast_params, dev):
    rules = RULES.get(rules_name, shd.TRAIN_RULES)
    compile_for, _ = jit_train_step(api, opt_config, mesh, rules, accum_steps=accum_steps, cast_params=cast_params)
    step, b_specs = compile_for(shape)
    st = shd.empty_placed(shd.abstract_with_sharding(abstract_state(api, opt_config), state_logical(api, opt_config),
                                                     mesh, rules))
    state = TrainState(params=ParamTree(st.params, trainable=True),
                       opt=st.opt._replace(count=torch.zeros((), dtype=torch.int32, device=dev)))
    batch = shd.empty_placed(_with_sharding(abstract_batch(b_specs), mesh, rules))
    return step, (state, batch)


def _serve_program(api, shape, mesh, dev):
    rules = shd.SERVE_RULES
    logical = logical_axes(api.params_def)
    split = split_mask(logical)
    p_specs = _serve_param_specs(api)
    params = ParamTree(shd.empty_placed(shd.abstract_with_sharding(p_specs, logical, mesh, rules)))
    ep = api.cfg.family == "moe" and api.cfg.router_impl != "ragged"

    if shape.kind == "prefill":
        specs = api.prefill_inputs(shape)
        batch = shd.empty_placed(_with_sharding(specs, mesh, rules))

        def prefill(params, batch):
            with torch.no_grad(), shd.use_rules(mesh, rules):
                local = shd.local_view(params, logical, mesh, ep=ep, split=split)
                return api.prefill(local, shd.local_view(batch, {k: s.axes for k, s in specs.items()}, mesh))

        return prefill, (params, batch)
    c_specs = api.cache_spec(shape)
    t_spec = api.decode_inputs(shape)["token"]
    c_axes = {k: s.axes for k, s in c_specs.items()}
    cache = shd.empty_placed(_with_sharding(c_specs, mesh, rules))
    token = shd.empty_placed(_with_sharding({"token": t_spec}, mesh, rules))
    pos = shape.seq_len - 1  # the last slot of a cache of seq_len

    def decode(params, cache, token):
        with torch.no_grad(), shd.use_rules(mesh, rules):
            local = shd.local_view(params, logical, mesh, ep=ep, split=split)
            c = shd.local_view(cache, c_axes, mesh, split=split_mask(c_axes))
            t = shd.local_view(token, {"token": t_spec.axes}, mesh)["token"]
            return api.decode(local, c, t, pos)

    return decode, (params, cache, token)


def lower_cell(
    arch: str, shape_name, *, multi_pod: bool = False, opt_config=None, accum_steps: int = 1,
    cast_params: bool = False, rules_name: str = "train", cfg_overrides: dict | None = None,
    mesh: str = "production",
) -> dict:
    """Trace one cell on fake tensors.  Returns the record dict.

    ``shape_name`` is a registered shape's name or a ``ShapeConfig``;
    ``mesh`` is "production" (the (16, 16) pod, or with ``multi_pod`` the
    (2, 16, 16) multipod), "local" (the (1, 1) mesh of one card) or a
    ("data", "model") shape such as (2, 1) over a fake world of its size."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = get_shape(shape_name) if isinstance(shape_name, str) else shape_name
    api = build(cfg)
    opt_config = opt_config or opt.OptimizerConfig()
    dims = None if mesh == "production" else ((1, 1) if mesh == "local" else tuple(mesh))
    n_dev = math.prod(dims) if dims else (512 if multi_pod else 256)
    mesh_name = "x".join(map(str, dims)) if dims else ("2x16x16" if multi_pod else "16x16")
    dev = trace_device()

    with meshlib.fake_process_group(n_dev):
        dmesh = (init_device_mesh(dev, dims, mesh_dim_names=("data", "model")) if dims
                 else meshlib.make_production_mesh(multi_pod=multi_pod, device_type=dev))
        with FakeTensorMode():
            t0 = time.perf_counter()
            if shape.kind == "train":
                program, args = _train_program(api, shape, dmesh, rules_name, opt_config, accum_steps, cast_params,
                                               dev)
            else:
                program, args = _serve_program(api, shape, dmesh, dev)
            t_lower = time.perf_counter() - t0

            arg_leaves = _leaves(args)
            arg_keys = {_key(t) for t in arg_leaves}
            t0 = time.perf_counter()
            with CommDebugMode() as comm, FlopCounterMode(display=False) as flops, \
                    _TraceStats(dmesh, arg_keys) as stats:
                out = program(*args)
            t_trace = time.perf_counter() - t0
            out_leaves = _leaves(out)
            argument = sum(_nbytes(t) for t in arg_leaves)
            output = sum(_nbytes(t) for t in out_leaves)
            alias = sum(_nbytes(t) for t in out_leaves if _key(t) in arg_keys)
            del out
    _check_counts(stats, comm)

    temp = max(stats.peak - (output - alias), 0)
    return {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh_name,
        "devices": n_dev,
        "accum_steps": accum_steps,
        "cast_params": cast_params,
        "rules": rules_name if shape.kind == "train" else "serve",
        "cfg_overrides": cfg_overrides or {},
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_trace, 2),
        "flops_per_device": float(flops.get_total_flops()),
        "bytes_per_device": float(stats.traffic),
        "collective_bytes": stats.collective_bytes(),
        "collective_bytes_structured": stats.collective_bytes_structured(),
        "collective_bytes_by_axis": dict(stats.by_axis),
        "memory": {
            "argument_bytes": argument,
            "output_bytes": output,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_bytes_est": argument + output + temp - alias,
        },
        "model_flops": model_flops(cfg, shape),
        "param_count": cfg.param_count(),
        "kernels": dict(stats.kernels),
        "device": dev,
    }


def _leaves(tree) -> list:
    """Tensor leaves of nested ParamTrees, NamedTuples, dicts and lists."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


#: ``CommDebugMode``'s op names -> the counter's kinds.
_COMM_KINDS = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
}


def _check_counts(coll: CollectiveCounter, comm: CommDebugMode) -> None:
    """Raise unless ``CommDebugMode`` saw as many collectives of each kind
    as the counter did."""
    seen: Counter = Counter()
    for op, n in comm.get_comm_counts().items():
        seen[_COMM_KINDS.get(op.__name__.split(".")[-1], op.__name__)] += n
    if +seen != +coll.calls:
        raise RuntimeError(f"collective counts disagree: CommDebugMode {dict(seen)}, counter {dict(coll.calls)}")


def _cell_job(arch: str, shape: str, kwargs: dict) -> tuple[dict | None, str]:
    """One cell for a worker process: (record, "") or (None, traceback)."""
    try:
        t0 = time.perf_counter()
        rec = lower_cell(arch, shape, **kwargs)
        rec["wall_s"] = round(time.perf_counter() - t0, 2)
        return rec, ""
    except Exception:
        return None, traceback.format_exc()


def main(argv: list[str] | None = None) -> None:
    """CLI: trace (arch, shape) cells on fake tensors and dump their records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--rules", default="train", choices=["train", "zero3", "ep"])
    ap.add_argument("--override", default="", help="k=v,... ArchConfig overrides")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--jobs", type=int, default=1, help="cells traced at once, each in a process of its own")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.override.split(","):
        if kv:
            k, v = kv.split("=")
            for cast in (int, float, str):
                try:
                    overrides[k] = cast(v)
                    break
                except ValueError:
                    continue

    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    kwargs = dict(multi_pod=args.multi_pod, accum_steps=args.accum, cast_params=args.bf16_params,
                  rules_name=args.rules, cfg_overrides=overrides)
    if args.jobs > 1:  # the longest traces first: the xLSTM's per-token loops, then the train steps
        cells = sorted(cells, key=lambda c: (get_config(c[0]).family != "ssm", get_shape(c[1]).kind != "train"))
        pool = ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn"))
        futures = {pool.submit(_cell_job, arch, shape, kwargs): (arch, shape) for arch, shape in cells}
        results = ((futures[f], f.result()) for f in as_completed(futures))
    else:
        pool = None
        results = (((arch, shape), _cell_job(arch, shape, kwargs)) for arch, shape in cells)
    failures = 0
    try:
        for (arch, shape), (rec, error) in results:
            tag = f"{arch}_{shape}_{'2x16x16' if args.multi_pod else '16x16'}{args.tag}"
            if rec is None:
                failures += 1
                print(f"FAIL {tag}\n{error}", flush=True)
                continue
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            print(
                f"OK  {tag:60s} trace={rec['compile_s']:7.1f}s "
                f"flops/dev={rec['flops_per_device']:.3e} "
                f"peak_mem/dev={rec['memory']['peak_bytes_est']/2**30:.2f}GiB "
                f"coll={rec['collective_bytes'].get('total', 0)/2**20:.1f}MiB",
                flush=True,
            )
    finally:
        if pool is not None:
            pool.shutdown()
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
