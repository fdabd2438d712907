"""What the benchmark takes from the program: its model API for a
configuration file, and the way weights are handed to it.  Also the
weights themselves, which the benchmark draws from the seed, in the layout
and with the spreads the configuration's family gives, and hands to both
the program and the reference.
"""

from __future__ import annotations

import sys
import time

import torch


def note(t_start: float, what: str) -> None:
    """A line on standard error: seconds since the run started, and what
    was just done (where set-up goes)."""
    print(f"[bench] {time.perf_counter() - t_start:9.3f} s  {what}", file=sys.stderr, flush=True)


def port_model(model: dict, family):
    """The port's ``ModelApi`` and ``ArchConfig`` for a configuration file,
    after checking that the port's configuration has the fields the file
    and its family fix (``family.port_fields``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build

    port = model["port"]
    cfg = get_config(port["arch"], reduced=port.get("reduced", False))
    want = family.port_fields(model)
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise ValueError(f"the port's {cfg.name} differs from {model['name']}.json (port, file): {diff}")
    return build(cfg), cfg


def _leaf_shapes(node, prefix=""):
    for key in sorted(node):
        val = node[key]
        if isinstance(val, dict):
            yield from _leaf_shapes(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", tuple(val.shape)


def draw_weights(api, family, model: dict, generator: torch.Generator, dtype: torch.dtype) -> dict:
    """Every weight drawn on the generator's device in ``dtype``, one call
    a stacked leaf, in sorted-path order: a nested dict in the port's input
    layout, which has to be the family's (``family.expected_shapes``), each
    leaf N(0, ``family.std``) or ones.  The same seed on the same device
    gives the same weights."""
    shapes = dict(_leaf_shapes(api.params_def))
    want = family.expected_shapes(model, api.cfg.padded_vocab)
    if shapes != want:
        raise ValueError(f"the port's parameter layout differs from the benchmark's: {shapes} against {want}")
    dev = generator.device
    tree: dict = {}
    for path, shape in shapes.items():
        t = torch.empty(shape, dtype=dtype, device=dev)
        std = family.std(path, shape)
        if std is None:
            t.fill_(1.0)
        else:
            t.normal_(0.0, std, generator=generator)
        node = tree
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return tree


def port_params(tree: dict, dtype: torch.dtype):
    """The port's parameters over the benchmark's tensors (no copy)."""
    from repro_torch.models.common import load_params

    return load_params(tree, dtype)


def flat_state(node, prefix: str = "") -> dict:
    """{path: tensor} of a port parameter, gradient or moment tree
    (``ParamTree``, or nested dicts and per-layer lists), under the paths of
    the reference's ``leaf_paths``."""
    from torch import nn

    if isinstance(node, nn.Module) and not isinstance(node, nn.ModuleList):
        return {f"{prefix}.{name}" if prefix else name: p for name, p in node.named_parameters()}
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple, nn.ModuleList)):
        items = ((str(i), v) for i, v in enumerate(node))
    else:
        return {prefix: node}
    out = {}
    for key, val in items:
        out.update(flat_state(val, f"{prefix}.{key}" if prefix else str(key)))
    return out
