"""Carry inputs, filter state, configs and model weights over from the
reference package.

What crosses from ``repro`` is the metering path's engine inputs, Kalman
and streaming state, telemetry and configs, and the model zoo's parameter
trees.  Every
function here takes plain numpy arrays (``np.asarray(jax_array)``) or plain
fields, never a reference object, so this module imports nothing of the
reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.disaggregation import DisaggregationConfig
from repro_torch.core.engine.types import EngineConfig, FleetInputs, FleetStep, FleetStreamState
from repro_torch.core.kalman import KalmanConfig, KalmanState
from repro_torch.core.profiler import ProfilerConfig, Telemetry
from repro_torch.device import DEFAULT_DEVICE, resolve_device

#: The reference's gram backends and their twins here.
_BACKENDS = {"auto": "auto", "xla": "einsum", "pallas": "kernel"}


def _f32(x, dev):
    return None if x is None else torch.tensor(np.asarray(x, np.float32), device=dev)


def fleet_inputs_from_numpy(
    c, w, a, lat_sum, lat_sumsq, mask=None, fn_mask=None,
    *, device: str | torch.device = DEFAULT_DEVICE,
) -> FleetInputs:
    """``FleetInputs`` on ``device`` from the reference's numpy arrays."""
    dev = resolve_device(device)
    return FleetInputs(*(_f32(x, dev) for x in (c, w, a, lat_sum, lat_sumsq, mask, fn_mask)))


def kalman_state_from_numpy(
    x, p, seen, lat_mean, lat_m2, lat_count,
    *, device: str | torch.device = DEFAULT_DEVICE,
) -> KalmanState:
    """``KalmanState`` on ``device`` (``seen`` as bool, the rest float32),
    every leaf a copy: the streaming engine updates the state in place."""
    dev = resolve_device(device)
    return KalmanState(
        x=_f32(x, dev), p=_f32(p, dev),
        seen=torch.tensor(np.asarray(seen, bool), device=dev),
        lat_mean=_f32(lat_mean, dev), lat_m2=_f32(lat_m2, dev),
        lat_count=_f32(lat_count, dev),
    )


def stream_state_from_numpy(
    kalman, c_buf, w_buf, a, lat_sum, lat_sumsq, tick_in_step, step_idx,
    *, device: str | torch.device = DEFAULT_DEVICE,
) -> FleetStreamState:
    """``FleetStreamState`` on ``device`` from the reference's stream state
    as numpy: ``kalman`` is the six ``KalmanState`` leaves in order, the
    counters (device scalars there) become host ints."""
    dev = resolve_device(device)
    return FleetStreamState(
        kalman=kalman_state_from_numpy(*kalman, device=dev),
        c_buf=_f32(c_buf, dev), w_buf=_f32(w_buf, dev), a=_f32(a, dev),
        lat_sum=_f32(lat_sum, dev), lat_sumsq=_f32(lat_sumsq, dev),
        tick_in_step=int(np.asarray(tick_in_step)),
        step_idx=int(np.asarray(step_idx)),
    )


def fleet_step_from_numpy(
    c, w, a, lat_sum, lat_sumsq, valid=None,
    *, device: str | torch.device = DEFAULT_DEVICE,
) -> FleetStep:
    """One streaming tick (``FleetStep``) on ``device`` from numpy."""
    dev = resolve_device(device)
    return FleetStep(*(_f32(x, dev) for x in (c, w, a, lat_sum, lat_sumsq, valid)))


def telemetry_from_numpy(
    system_power, chip_power, idle_watts: float, cp_cpu_frac, sys_cpu_frac,
    *, device: str | torch.device = DEFAULT_DEVICE,
) -> Telemetry:
    """``Telemetry`` on ``device``; ``None`` series stay ``None``."""
    dev = resolve_device(device)
    return Telemetry(
        system_power=_f32(system_power, dev),
        chip_power=_f32(chip_power, dev),
        idle_watts=float(idle_watts),
        cp_cpu_frac=_f32(cp_cpu_frac, dev),
        sys_cpu_frac=_f32(sys_cpu_frac, dev),
    )


def config_from_reference_fields(cls: type, fields: dict):
    """Rebuild a config of this package from the reference's fields.

    ``cls`` is ``KalmanConfig``, ``DisaggregationConfig``, ``EngineConfig``
    or ``ProfilerConfig``; ``fields`` is ``dataclasses.asdict`` of the
    reference's config of the same name (nested configs as nested dicts).
    ``EngineConfig.backend`` maps ``xla`` to ``einsum`` and ``pallas`` to
    ``kernel``.
    """
    if cls not in (KalmanConfig, DisaggregationConfig, EngineConfig, ProfilerConfig):
        raise ValueError(f"no reference twin for {cls!r}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = dict(fields)
    if "kalman" in kw and isinstance(kw["kalman"], dict):
        kw["kalman"] = config_from_reference_fields(KalmanConfig, kw["kalman"])
    if "disagg" in kw and isinstance(kw["disagg"], dict):
        kw["disagg"] = config_from_reference_fields(DisaggregationConfig, kw["disagg"])
    if cls is EngineConfig and "backend" in kw:
        if kw["backend"] not in _BACKENDS:
            raise ValueError(f"unknown reference backend {kw['backend']!r}")
        kw["backend"] = _BACKENDS[kw["backend"]]
    return cls(**kw)


def params_from_numpy(
    tree: dict,
    cfg,
    *,
    device: str | torch.device = DEFAULT_DEVICE,
    dtype: torch.dtype | None = None,
):
    """The port's model parameters from the reference's parameter tree.

    ``tree`` is the reference's ``materialize(api.params_def, key)`` as
    nested dicts of numpy arrays (``np.asarray`` of each leaf), per-layer
    leaves stacked along a leading (L, ...) axis ("layers", or the xLSTM
    stack's "pairs"; deepseek's "dense0" and the VLM's "proj" unstacked).
    Every leaf is checked against the port's own declaration of ``cfg``'s
    parameters, moved to ``device`` and cast to ``dtype`` (default:
    ``cfg.compute_dtype``; the leaves the reference reads in fp32 stay
    fp32), and the stacked subtrees become the per-layer ``ParamTree``
    lists the port's forward pass loops over.
    """
    from repro_torch.models.common import load_params
    from repro_torch.models.model_zoo import build
    from repro_torch.models.transformer import compute_dtype

    dev = resolve_device(device)
    spec = build(cfg).params_def

    def check(spec_node, node, path):
        if isinstance(spec_node, dict):
            if not isinstance(node, dict) or set(node) != set(spec_node):
                raise ValueError(f"{path or 'params'}: keys {sorted(node) if isinstance(node, dict) else node!r} "
                                 f"!= the declaration's {sorted(spec_node)}")
            return {k: check(spec_node[k], node[k], f"{path}/{k}") for k in spec_node}
        arr = np.asarray(node, np.float32)
        if arr.shape != tuple(spec_node.shape):
            raise ValueError(f"{path}: shape {arr.shape} != the declaration's {spec_node.shape}")
        return torch.tensor(arr, device=dev)

    return load_params(check(spec, tree, ""), dtype or compute_dtype(cfg))
