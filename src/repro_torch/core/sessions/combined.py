"""Combined-mode (§4.3) chip-side helpers shared by every fleet path.

``X = X_CPU + X_Rest``: the engines disaggregate the chip-subtracted
'rest' power (``core.engine.targets``); the chip side comes from the
per-node counter models through the helpers here.  They live in the
session layer so both the live sessions and the ``core.profiler``
orchestration above consume the *same* split — the chip accounting cannot
drift between paths.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import contribution as contrib
from repro_torch.core import cpu_model as cpumod
from repro_torch.core.engine.plan import segment_plan
from repro_torch.core.sessions.report import _node_durations, _trace_tensors
from repro_torch.device import DEFAULT_DEVICE, resolve_device

Tensor = torch.Tensor


def combined_chip_power(
    counter_model: cpumod.LinearPowerModel,
    fn_counters: Tensor,   # (..., M, F) normalized per-function counters
    busy_seconds: Tensor,  # (..., M) per-function runtime over the segment
    duration,              # scalar or (...,) segment seconds
) -> tuple[Tensor, Tensor]:
    """Per-function X_CPU + un-attributed static bias for a segment (§4.3).

    The single place the combined mode turns counters into chip-side power
    — the per-node ``profile``, ``fleet_profile_batched`` and
    ``StreamingFleetSession`` all call it (per node or fleet-batched), so
    the chip split cannot drift between paths.  The second element is the
    static bias left un-attributed on idle intervals; callers route it into
    the report's idle term (``_finalize_report(idle_extra_watts=)``).
    """
    dur = torch.as_tensor(duration, dtype=torch.float32, device=busy_seconds.device)
    if dur.ndim:
        dur = dur[..., None]
    return cpumod.predict_function_power_split(counter_model, fn_counters, busy_seconds / dur)


def _as_fleet_model(counter_model, b: int, device: torch.device) -> cpumod.LinearPowerModel:
    """Normalize ``counter_model`` to a fleet-batched ``LinearPowerModel``
    on ``device``: a sequence of per-node models (stacked), an already
    batched model with ``(B, F)``/``(B,)`` leaves (validated), or one shared
    model (broadcast to every node).  The result owns its storage."""
    if not isinstance(counter_model, cpumod.LinearPowerModel) and isinstance(counter_model, (list, tuple)):
        if len(counter_model) != b:
            raise ValueError(f"got {len(counter_model)} counter model(s) for {b} node(s)")
        counter_model = cpumod.stack_models(counter_model)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
    w, bias = f32(counter_model.weights), f32(counter_model.bias)
    if w.ndim == 1:
        return cpumod.LinearPowerModel(
            weights=w.expand((b,) + tuple(w.shape)).clone(),
            bias=bias.reshape(()).expand(b).clone(),
        )
    if w.shape[0] != b:
        raise ValueError(f"batched counter model covers {w.shape[0]} node(s), fleet has {b}")
    return cpumod.LinearPowerModel(weights=w.clone(), bias=bias.clone())


def _as_fleet_counters(fn_counters, b: int, num_fns: int, device: torch.device) -> Tensor:
    """Normalize per-function counters to one (B, M, F) tensor on ``device``."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
    arr = (
        torch.stack([f32(f) for f in fn_counters])
        if isinstance(fn_counters, (list, tuple))
        else f32(fn_counters)
    )
    if arr.ndim == 2:
        arr = arr.expand((b,) + tuple(arr.shape))
    if arr.shape[0] != b or arr.shape[1] != num_fns:
        raise ValueError(
            f"fn_counters shape {tuple(arr.shape)} does not match fleet (B={b}, M={num_fns})"
        )
    return arr


def prepare_combined_fleet(
    config,
    traces: list[tuple],
    telemetries: list,
    *,
    num_fns: int,
    duration,
    gflops,
    hbm_gb,
    mean_latency,
    device: str | torch.device = DEFAULT_DEVICE,
):
    """Build everything combined-mode (§4.3) fleet profiling needs.

    Per node: assemble the contribution matrix over that node's own window
    count, derive its system-interval counter features
    (``telemetry.counters.window_counters``) and normalized per-function
    counters (``function_counters``) — on the host, from the host trace,
    like every trace statistic — and fit every node's ``LinearPowerModel``
    on the **N_init block** of chip-power observations in one batched
    ``fit_ridge`` on ``device``.  Fitting on the init block keeps the model
    causal on the streaming path, so the batch and streaming engines
    consume identical models; the continuous-retraining loop then monitors
    drift past it (``cpu_model.retrain_flags`` at Kalman-step boundaries).

    Args:
      config: profiler configuration (delta + segment plan come from here).
      traces: per-node (fn_id, start, end) invocation arrays.
      telemetries: per-node ``Telemetry`` — at least one node needs chip
        power.  Chipless nodes (``chip_power is None``, e.g. the edge
        platform in a mixed fleet) contribute all-masked fit rows and come
        out with the zero counter model: their chip-side split is exactly
        zero, the combined engines' pure-mode fallback.
      num_fns: number of unique functions M.
      duration: segment seconds — one float or a per-node sequence.
      gflops/hbm_gb/mean_latency: (M,) per-function step-counter specs.
      device: where the counters and models are returned (default the card).

    Returns:
      ``(fn_counters, window_features, models)`` — (B, M, F) normalized
      per-function counters and the fleet-batched ``LinearPowerModel`` on
      ``device``, and the (B, N_max, F) per-window features on the host
      (zero-padded past each node's span; the streaming session's retrain
      checks read them there).
    """
    from repro_torch.telemetry import counters as cntr

    dev = resolve_device(device)
    host = torch.device("cpu")
    b = len(traces)
    durations, _ = _node_durations(duration, b)
    plans = [segment_plan(config, d) for d in durations]
    init_n = plans[0][1]
    if any(p[1] != init_n for p in plans):
        raise ValueError(
            "combined fleet: every node must cover the common N_init window "
            f"({config.init_windows} windows); got per-node init blocks "
            f"{[p[1] for p in plans]}"
        )
    n_max = max(p[0] for p in plans)
    gf, hb, lat = (torch.as_tensor(np.asarray(v, np.float32)) for v in (gflops, hbm_gb, mean_latency))
    has_chip = [tel.chip_power is not None for tel in telemetries]
    if not any(has_chip):
        raise ValueError("combined mode needs chip_power on at least one node")
    fn_list, wf_list, feats_init, chip_init = [], [], [], []
    for (fn_id, start, end), tel, (n_i, _, _, _) in zip(traces, telemetries, plans):
        fn_id, start, end = _trace_tensors(fn_id, start, end, host)
        c = contrib.contribution_matrix(
            fn_id, start, end, num_fns=num_fns, num_windows=n_i, delta=config.delta
        )
        wf = cntr.window_counters(c, gf, hb, lat, config.delta)
        fn_list.append(cntr.function_counters(c, gf, hb, lat))
        if n_i < n_max:
            wf = torch.cat([wf, wf.new_zeros((n_max - n_i, cntr.NUM_FEATURES))])
        wf_list.append(wf)
        if tel.chip_power is None:
            # Chipless: all-masked fit rows -> the zero counter model.
            feats_init.append(torch.zeros((init_n, cntr.NUM_FEATURES)))
            chip_init.append(torch.zeros((init_n,)))
        else:
            feats_init.append(wf[:init_n])
            chip_init.append(torch.as_tensor(tel.chip_power, dtype=torch.float32).cpu()[:init_n])
    feats = torch.stack(feats_init).to(dev)
    chip = torch.stack(chip_init).to(dev)
    if all(has_chip):
        models = cpumod.fit_ridge(feats, chip)
    else:
        fit_mask = np.repeat(np.asarray(has_chip, np.float32)[:, None], init_n, axis=1)
        models = cpumod.fit_ridge(feats, chip, mask=torch.from_numpy(fit_mask).to(dev))
    return torch.stack(fn_list).to(dev), torch.stack(wf_list), models
