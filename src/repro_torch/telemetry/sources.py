"""Simulated power-sensor front-ends with each source's pathology (paper §3.1,
§5, Fig. 2a/Fig. 5).

Degradation chain applied to the true power series, in measurement order:

  true power -> sensor smoothing (1st-order IIR, time constant tau_s)
             -> decimation to the sensor rate
             -> reporting lag (shift by lag_s)
             -> additive Gaussian noise
             -> quantization (watt resolution)

Presets:

- ``ipmi_like``:  1 Hz, tau 2 s, lag 3 s, 4 W quantization, 2 W noise —
  the paper's server BMC: "poor resolution and large jumps", "significant lag".
- ``plug_like``:  4 Hz, tau 0.2 s, lag 0.5 s, 0.1 W quantization — the
  GPM-8310-style external meter (0.25 s sampling in the paper).
- ``rapl_like``: 10 Hz, tau ~0, no lag, jitter noise — fast but chip-only.
- ``battery_like``: 0.5 Hz ACPI discharge counter (edge devices).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def trapezoid(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """numpy-version-portable trapezoidal integration.

    ``np.trapezoid`` only exists on numpy >= 2.0 (where ``np.trapz`` was
    removed); older numpys have only ``np.trapz``.  Resolved at call time so
    the fallback is testable by masking the attribute."""
    fn = getattr(np, "trapezoid", None)
    if fn is None:  # numpy < 2.0
        fn = np.trapz
    return fn(y, x)


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    rate_hz: float
    tau_s: float = 0.0       # sensor smoothing time constant
    lag_s: float = 0.0       # reporting-path delay
    noise_w: float = 0.0     # additive Gaussian sigma
    quant_w: float = 0.0     # quantization step (0 = none)


IPMI_LIKE = SensorConfig(rate_hz=1.0, tau_s=2.0, lag_s=3.0, noise_w=2.0, quant_w=4.0)
PLUG_LIKE = SensorConfig(rate_hz=4.0, tau_s=0.2, lag_s=0.5, noise_w=0.3, quant_w=0.1)
RAPL_LIKE = SensorConfig(rate_hz=10.0, tau_s=0.05, lag_s=0.0, noise_w=0.8, quant_w=0.0)
BATTERY_LIKE = SensorConfig(rate_hz=0.5, tau_s=5.0, lag_s=2.0, noise_w=1.0, quant_w=0.5)

PRESETS = {
    "ipmi": IPMI_LIKE,
    "plug": PLUG_LIKE,
    "rapl": RAPL_LIKE,
    "battery": BATTERY_LIKE,
}


@dataclasses.dataclass
class PowerSignal:
    times: np.ndarray   # (n,) sample timestamps (s)
    watts: np.ndarray   # (n,)
    rate_hz: float

    def energy_j(self) -> float:
        """Trapezoidal integral — what 'total energy from coarse measurements'
        means for the marginal-energy protocol (Eq. 6)."""
        return float(trapezoid(self.watts, self.times))


def sense(
    true_power: np.ndarray,
    dt: float,
    config: SensorConfig,
    rng: np.random.Generator,
) -> PowerSignal:
    """Apply the degradation chain of ``config`` to a fine-grid true series."""
    t = true_power.astype(np.float64)

    # 1. sensor smoothing: first-order IIR on the fine grid.
    if config.tau_s > 0:
        from scipy.signal import lfilter, lfiltic

        a = dt / (config.tau_s + dt)
        # y[i] = (1-a) y[i-1] + a x[i], seeded at the first true value.
        zi = lfiltic([a], [1.0, -(1.0 - a)], y=[t[0]])
        t, _ = lfilter([a], [1.0, -(1.0 - a)], t, zi=zi)

    # 2. decimate to the sensor rate (sample-and-hold at sample instants).
    period = 1.0 / config.rate_hz
    n = int(np.floor(len(t) * dt / period))
    idx = np.minimum((np.arange(1, n + 1) * period / dt).astype(np.int64) - 1, len(t) - 1)
    samples = t[idx]
    times = (np.arange(1, n + 1)) * period

    # 3. reporting lag: the value reported at time t was measured at t - lag.
    # A segment shorter than one sensor period decimates to zero samples;
    # there is nothing to shift (and samples[0] would raise), so the lag
    # stage only applies to a non-empty stream — matching StreamingSensor,
    # whose delay line simply stays empty until a first sample exists.  The
    # shift is clamped to the stream length: a lag longer than the segment
    # repeats the first measurement for every report (a plain
    # ``samples[:-lag]`` would go negative and corrupt the output length).
    lag_samples = int(round(config.lag_s / period))
    if lag_samples > 0 and samples.size:
        k = min(lag_samples, samples.size)
        samples = np.concatenate([np.full(k, samples[0]), samples[: samples.size - k]])

    # 4. noise, 5. quantization.
    if config.noise_w > 0:
        samples = samples + rng.normal(0.0, config.noise_w, size=samples.shape)
    if config.quant_w > 0:
        samples = np.round(samples / config.quant_w) * config.quant_w

    return PowerSignal(times=times, watts=samples.astype(np.float64), rate_hz=config.rate_hz)


@dataclasses.dataclass
class FleetPowerSignal:
    """One sensor kind's samples for a whole fleet, sensed in lockstep.

    The fleet shares one sample clock (``times``), so per-node signals are
    rows of one ``(B, n)`` array; on a ragged fleet (nodes with different
    segment lengths) ``n_samples[i]`` bounds node ``i``'s real samples and
    the columns past it are padding (causal garbage, never read downstream).
    """

    times: np.ndarray       # (n,) shared sample timestamps (s)
    watts: np.ndarray       # (B, n)
    rate_hz: float
    n_samples: np.ndarray   # (B,) per-node valid sample counts (<= n)

    def node(self, i: int) -> PowerSignal:
        """Node ``i``'s own signal (its valid prefix) as a ``PowerSignal``."""
        n_i = int(self.n_samples[i])
        return PowerSignal(
            times=self.times[:n_i], watts=self.watts[i, :n_i], rate_hz=self.rate_hz
        )

    def energy_j(self) -> np.ndarray:
        """(B,) per-node trapezoidal energy over each node's valid prefix."""
        if self.times.size < 2:
            return np.zeros(self.watts.shape[0])
        seg = 0.5 * (self.watts[:, 1:] + self.watts[:, :-1]) * np.diff(self.times)[None, :]
        valid = np.arange(1, self.times.size)[None, :] < self.n_samples[:, None]
        return (seg * valid).sum(axis=1)


def sense_fleet(
    true_power: np.ndarray,
    dt: float,
    config: SensorConfig,
    rngs: "Sequence[np.random.Generator] | None" = None,
    lengths: np.ndarray | None = None,
) -> FleetPowerSignal:
    """Fleet-batched ``sense``: one degradation chain over a (B, T) stack.

    Every stage of the chain is vectorized over the fleet axis — the IIR
    smoothing is a single ``lfilter`` call over all B rows, decimation is a
    shared-index gather, the lag is one array shift — and each stage is
    elementwise-identical to running ``sense`` per node (pinned bitwise in
    tests/test_telemetry_frontend.py).  Noise draws come from ``rngs[i]``,
    one block draw per node per call, so node ``i``'s realization equals a
    per-node ``sense`` given the same generator (numpy draws are
    stream-stable under blocking).

    Args:
      true_power: (B, T) fine-grid true series, one row per node.
      dt: fine simulation grid step (s).
      config: shared sensor pathology.
      rngs: per-node generators (required when ``config.noise_w > 0``).
      lengths: optional (B,) per-node fine-grid lengths for a ragged fleet;
        node ``i`` is sensed exactly as if its row were ``true_power[i, :L]``
        (the chain is causal, so the shared pass plus per-node clamping is
        bitwise equal to per-node sensing of the truncated row).

    Returns:
      ``FleetPowerSignal`` on the shared sample clock; ``n_samples`` carries
      each node's real sample count.
    """
    t = np.asarray(true_power, np.float64)
    b, t_len = t.shape
    lens = (
        np.full(b, t_len, np.int64)
        if lengths is None
        else np.asarray(lengths, np.int64)
    )
    if config.noise_w > 0 and rngs is None:
        raise ValueError("sense_fleet needs per-node rngs when noise_w > 0")
    if rngs is not None and len(rngs) != b:
        raise ValueError(f"got {len(rngs)} rng(s) for {b} node(s)")

    # 1. sensor smoothing: one IIR pass over all rows.
    if config.tau_s > 0 and t_len:
        from scipy.signal import lfilter

        a = dt / (config.tau_s + dt)
        zi = (1.0 - a) * t[:, :1]
        t, _ = lfilter([a], [1.0, -(1.0 - a)], t, axis=1, zi=zi)

    # 2. decimate on the shared clock; per-node gather indices clamped to
    #    each node's own length (exactly `sense`'s end-of-segment clamp).
    period = 1.0 / config.rate_hz
    n_nodes = np.floor(lens * dt / period).astype(np.int64)
    n = int(n_nodes.max()) if b else 0
    if n == 0:
        return FleetPowerSignal(
            times=np.zeros(0), watts=np.zeros((b, 0)), rate_hz=config.rate_hz,
            n_samples=n_nodes,
        )
    idx = np.minimum(
        ((np.arange(1, n + 1) * period / dt).astype(np.int64) - 1)[None, :],
        lens[:, None] - 1,
    )
    samples = np.take_along_axis(t, idx, axis=1)
    times = np.arange(1, n + 1) * period

    # 3. reporting lag: shared shift (every node lags identically), clamped
    # to the stream length exactly as in ``sense`` — a lag longer than the
    # segment repeats each node's first measurement for every report.
    lag_samples = int(round(config.lag_s / period))
    if lag_samples > 0:
        k = min(lag_samples, n)
        samples = np.concatenate(
            [np.repeat(samples[:, :1], k, axis=1), samples[:, : n - k]],
            axis=1,
        )

    # 4. noise (one block draw per node), 5. quantization.
    if config.noise_w > 0:
        samples = samples + np.stack(
            [r.normal(0.0, config.noise_w, size=n) for r in rngs]
        )
    if config.quant_w > 0:
        samples = np.round(samples / config.quant_w) * config.quant_w
    return FleetPowerSignal(
        times=times, watts=samples.astype(np.float64), rate_hz=config.rate_hz,
        n_samples=n_nodes,
    )


def resample_fleet(
    signal: FleetPowerSignal, num_windows: int, delta: float
) -> np.ndarray:
    """(B, N) fleet-batched ``resample_to_windows`` on the shared clock.

    One ``searchsorted`` over the shared sample times serves every node;
    per-node clamping at ``signal.n_samples`` reproduces each node's own
    resampling bitwise (a window past a node's last sample forward-fills,
    exactly as the per-node path does on its truncated signal).  Windows at
    or past a ragged node's own window count are padding for that node —
    slice them off with the node's window count.
    """
    b = signal.watts.shape[0]
    edges = np.arange(num_windows + 1) * delta
    idx = np.minimum(
        np.searchsorted(signal.times, edges)[None, :], signal.n_samples[:, None]
    )
    counts = idx[:, 1:] - idx[:, :-1]
    csum = np.concatenate(
        [np.zeros((b, 1)), np.cumsum(signal.watts, axis=1, dtype=np.float64)], axis=1
    )
    means = (
        np.take_along_axis(csum, idx[:, 1:], axis=1)
        - np.take_along_axis(csum, idx[:, :-1], axis=1)
    ) / np.maximum(counts, 1)
    seed = (
        np.where(signal.n_samples > 0, signal.watts[:, 0], 0.0)
        if signal.watts.shape[1]
        else np.zeros(b)
    )
    filled = counts > 0
    src = np.maximum.accumulate(
        np.where(filled, np.arange(num_windows)[None, :], -1), axis=1
    )
    out = np.where(
        src >= 0, np.take_along_axis(means, np.maximum(src, 0), axis=1), seed[:, None]
    )
    return out.astype(np.float64)


class StreamingSensor:
    """Incremental ``sense``: the same degradation chain, fed chunk by chunk.

    Carries the chain's state across ``push`` calls — IIR filter memory,
    decimation phase, the lag delay-line, and the noise RNG position — so

        ``concat(push(x[:k]), push(x[k:])) == sense(x).watts``

    exactly, for any chunking (pinned in tests/test_streaming_engine.py).
    This is what lets the simulator emit telemetry tick-by-tick for the
    streaming fleet engine instead of sensing a finished segment.

    Both the batch and streaming simulators give every sensor its own spawned
    child RNG (``np.random.default_rng(seed).spawn(2)``: system first, chip
    second), so with matched seeds the two paths emit bitwise-identical
    telemetry (pinned exactly in tests/test_streaming_engine.py).
    """

    def __init__(self, config: SensorConfig, dt: float, rng: np.random.Generator):
        self.config = config
        self.dt = dt
        self.rng = rng
        self._iir_y: float | None = None     # IIR memory (last smoothed value)
        self._n_fine = 0                     # fine-grid samples consumed
        self._n_sampled = 0                  # sensor samples decimated so far
        self._smoothed_tail: np.ndarray = np.empty(0)  # fine samples not yet decimated
        self._tail_offset = 0                # absolute index of _smoothed_tail[0]
        self._lag_line: list[float] = []     # samples inside the reporting delay
        self._lag_left = int(round(config.lag_s * config.rate_hz))
        self._first_sample: float | None = None

    def push(self, true_chunk: np.ndarray) -> PowerSignal:
        """Sense one chunk of the fine-grid true series.

        Args:
          true_chunk: (k,) watts on the simulation grid (k >= 0).

        Returns:
          ``PowerSignal`` holding the (possibly empty) newly emitted sensor
          samples; timestamps continue the global stream.
        """
        cfg = self.config
        t = np.asarray(true_chunk, np.float64)

        # 1. IIR smoothing with carried state.
        if cfg.tau_s > 0 and t.size:
            from scipy.signal import lfilter, lfiltic

            a = self.dt / (cfg.tau_s + self.dt)
            y_prev = t[0] if self._iir_y is None else self._iir_y
            zi = lfiltic([a], [1.0, -(1.0 - a)], y=[y_prev])
            t, zf = lfilter([a], [1.0, -(1.0 - a)], t, zi=zi)
            self._iir_y = float(t[-1])
        self._n_fine += t.size

        # 2. decimation: emit sample k (1-based) once fine index
        #    idx_k = min(floor(k * period / dt) - 1, ...) is available.
        period = 1.0 / cfg.rate_hz
        self._smoothed_tail = np.concatenate([self._smoothed_tail, t])
        n_total = int(np.floor(self._n_fine * self.dt / period))
        out = []
        while self._n_sampled < n_total:
            k = self._n_sampled + 1
            idx = min(int(k * period / self.dt) - 1, self._n_fine - 1)
            sample = float(self._smoothed_tail[idx - self._tail_offset])
            self._n_sampled += 1
            if self._first_sample is None:
                self._first_sample = sample
            # 3. lag: the first lag_samples reports repeat the first value.
            if self._lag_left > 0:
                self._lag_line.append(sample)
                self._lag_left -= 1
                out.append(self._first_sample)
            elif self._lag_line:
                self._lag_line.append(sample)
                out.append(self._lag_line.pop(0))
            else:
                out.append(sample)
        # Drop fine samples older than any future decimation index can need.
        keep_from = max(self._n_fine - max(int(period / self.dt) + 2, 2), self._tail_offset)
        self._smoothed_tail = self._smoothed_tail[keep_from - self._tail_offset:]
        self._tail_offset = keep_from

        samples = np.asarray(out, np.float64)
        # 4. noise, 5. quantization — in emission order, so the RNG stream
        # matches a single batch draw.
        if cfg.noise_w > 0 and samples.size:
            samples = samples + self.rng.normal(0.0, cfg.noise_w, size=samples.shape)
        if cfg.quant_w > 0:
            samples = np.round(samples / cfg.quant_w) * cfg.quant_w
        times = (np.arange(self._n_sampled - len(out), self._n_sampled) + 1) * period
        return PowerSignal(times=times, watts=samples, rate_hz=cfg.rate_hz)


class StreamingWindowResampler:
    """Incremental ``resample_to_windows``: window means from a live stream.

    Push sensor samples as they arrive; completed delta-windows are emitted
    with exactly the batch semantics — per-window sample means, empty
    windows forward-filled with the last emitted mean (seeded at the first
    sample ever seen).  A window closes when a sample at or past its right
    edge arrives, or on ``flush``.
    """

    def __init__(self, delta: float):
        self.delta = delta
        self._next_window = 0
        self._sum = 0.0
        self._count = 0
        self._last_mean: float | None = None
        self._seed: float | None = None

    def _close_window(self) -> float:
        if self._count > 0:
            mean = self._sum / self._count
            self._last_mean = mean
        elif self._last_mean is not None:
            mean = self._last_mean
        else:
            mean = self._seed if self._seed is not None else 0.0
        self._next_window += 1
        self._sum = 0.0
        self._count = 0
        return mean

    def push(self, times: np.ndarray, watts: np.ndarray) -> np.ndarray:
        """Fold new samples in; return the means of any windows they close.

        Args:
          times/watts: (k,) monotonically increasing sample stream chunk.

        Returns:
          (j,) means of the windows completed by this chunk (j >= 0).
        """
        out = []
        for t, w in zip(np.asarray(times, float), np.asarray(watts, float)):
            if self._seed is None:
                self._seed = float(w)
            while t >= (self._next_window + 1) * self.delta:
                out.append(self._close_window())
            self._sum += float(w)
            self._count += 1
        return np.asarray(out, np.float64)

    def flush(self, num_windows: int) -> np.ndarray:
        """Close every window up to ``num_windows`` (end of segment)."""
        out = []
        while self._next_window < num_windows:
            out.append(self._close_window())
        return np.asarray(out, np.float64)


def resample_to_windows(signal: PowerSignal, num_windows: int, delta: float) -> np.ndarray:
    """(N,) mean power per delta window (energy-preserving resampling).

    Vectorized: per-window means come from a cumulative sum over the sample
    stream; empty windows (sensor slower than the window) hold the previous
    window's value via an index-forward-fill, seeded at the first sample.
    """
    edges = np.arange(num_windows + 1) * delta
    idx = np.searchsorted(signal.times, edges)
    counts = idx[1:] - idx[:-1]
    csum = np.concatenate([[0.0], np.cumsum(signal.watts, dtype=np.float64)])
    means = (csum[idx[1:]] - csum[idx[:-1]]) / np.maximum(counts, 1)
    seed = signal.watts[0] if len(signal.watts) else 0.0
    filled = counts > 0
    # forward-fill empty windows with the last filled window's mean
    src = np.maximum.accumulate(np.where(filled, np.arange(num_windows), -1))
    out = np.where(src >= 0, means[np.maximum(src, 0)], seed)
    return out.astype(np.float64)


class FleetStreamingSensor:
    """Fleet-batched ``StreamingSensor``: one chunked chain over (B, k) pushes.

    Carries every node's chain state as stacked arrays — the IIR memory is
    the (B, 1) ``lfilter`` final condition, the lag delay-line is a (B, lag)
    ring of the most recent pre-lag samples, the decimation phase is shared
    (one sample clock for the fleet) — so each node's emitted stream is
    bitwise what its own ``StreamingSensor`` would emit under the same
    chunking, and (by the same state-carrying argument as the per-node
    twin) bitwise what one ``sense_fleet`` call over the concatenated pushes
    would emit.  Noise draws block per push from each node's own generator,
    which numpy keeps stream-stable under any blocking.
    """

    def __init__(
        self,
        config: SensorConfig,
        dt: float,
        rngs: Sequence[np.random.Generator],
    ):
        self.config = config
        self.dt = dt
        self.rngs = list(rngs)
        self.b = len(self.rngs)
        self._iir_zi: np.ndarray | None = None   # (B, 1) lfilter carry state
        self._n_fine = 0                         # fine-grid columns consumed
        self._n_sampled = 0                      # sensor samples decimated so far
        self._smoothed_tail = np.empty((self.b, 0))  # fine columns not yet decimated
        self._tail_offset = 0                    # absolute index of tail column 0
        self._lag_buf = np.empty((self.b, 0))    # newest pre-lag samples, <= lag wide
        self._lag = int(round(config.lag_s * config.rate_hz))
        self._first_sample: np.ndarray | None = None  # (B,) first decimated sample

    def push(self, true_chunk: np.ndarray) -> FleetPowerSignal:
        """Sense one (B, k) chunk of the fleet's fine-grid true series.

        Returns the newly emitted sensor samples for every node as a
        ``FleetPowerSignal`` (possibly zero columns); timestamps continue the
        shared global clock.
        """
        cfg = self.config
        t = np.asarray(true_chunk, np.float64)

        # 1. IIR smoothing, all rows in one lfilter call with carried state.
        if cfg.tau_s > 0 and t.shape[1]:
            from scipy.signal import lfilter

            a = self.dt / (cfg.tau_s + self.dt)
            zi = (1.0 - a) * t[:, :1] if self._iir_zi is None else self._iir_zi
            t, self._iir_zi = lfilter([a], [1.0, -(1.0 - a)], t, axis=1, zi=zi)
        self._n_fine += t.shape[1]

        # 2. decimation: one gather for every sample the fleet clock owes.
        period = 1.0 / cfg.rate_hz
        tail = np.concatenate([self._smoothed_tail, t], axis=1)
        n_total = int(np.floor(self._n_fine * self.dt / period))
        m = n_total - self._n_sampled
        if m > 0:
            ks = np.arange(self._n_sampled + 1, n_total + 1)
            idxs = np.minimum(
                (ks * period / self.dt).astype(np.int64) - 1, self._n_fine - 1
            )
            cols = tail[:, idxs - self._tail_offset]       # (B, m) measured
            if self._first_sample is None:
                self._first_sample = cols[:, 0].copy()
            # 3. lag: report g is first_sample while g < lag, else measured
            #    sample g - lag — pulled from the carried pre-lag ring when it
            #    predates this push.
            if self._lag > 0:
                g0 = self._n_sampled
                pool = np.concatenate([self._lag_buf, cols], axis=1)
                g = np.arange(g0, g0 + m)
                pos = g - self._lag - (g0 - self._lag_buf.shape[1])
                samples = np.where(
                    (g < self._lag)[None, :],
                    self._first_sample[:, None],
                    pool[:, np.maximum(pos, 0)],
                )
                self._lag_buf = pool[:, max(0, pool.shape[1] - self._lag):]
            else:
                samples = cols
            self._n_sampled = n_total
        else:
            samples = np.empty((self.b, 0))
        # Drop fine columns older than any future decimation index can need.
        keep_from = max(
            self._n_fine - max(int(period / self.dt) + 2, 2), self._tail_offset
        )
        self._smoothed_tail = tail[:, keep_from - self._tail_offset:]
        self._tail_offset = keep_from

        # 4. noise (one block draw per node per push), 5. quantization.
        if cfg.noise_w > 0 and m > 0:
            samples = samples + np.stack(
                [r.normal(0.0, cfg.noise_w, size=m) for r in self.rngs]
            )
        if cfg.quant_w > 0:
            samples = np.round(samples / cfg.quant_w) * cfg.quant_w
        times = (np.arange(self._n_sampled - max(m, 0), self._n_sampled) + 1) * period
        return FleetPowerSignal(
            times=times,
            watts=samples.astype(np.float64),
            rate_hz=cfg.rate_hz,
            n_samples=np.full(self.b, max(m, 0), np.int64),
        )


class FleetWindowResampler:
    """Fleet-batched ``StreamingWindowResampler``, bitwise equal to the batch.

    Window sums are differences of one running cumulative sum per node,
    carried across pushes by seeding each chunk's ``cumsum`` with the carry
    (``cumsum(concat([carry, chunk]))`` continues the full-stream chain
    bitwise, unlike ``carry + cumsum(chunk)`` which reassociates), so every
    emitted mean is the exact float the batch ``resample_fleet`` csum-diff
    computes — this is what lets ``stream_fleet`` match ``simulate_fleet``
    telemetry bitwise rather than to rounding error.

    The fleet shares one sample clock, so the open-window bookkeeping
    (window index, sample count) is scalar; per-node state is the (B,)
    carry, open-window boundary, last emitted mean, and fill seed.  On a
    ragged fleet a node's padding samples land strictly after its own last
    window edge, so they only ever contaminate windows the caller already
    treats as invalid; a node must see at least one real sample before its
    first window closes for its fill seed to be meaningful.
    """

    def __init__(self, delta: float, b: int):
        self.delta = delta
        self.b = b
        self._next_window = 0
        self._count = 0                      # samples in the open window (shared)
        self._carry = np.zeros(b)            # running csum through consumed samples
        self._boundary = np.zeros(b)         # csum at the open window's left edge
        self._last_mean = np.zeros(b)
        self._has_mean = False
        self._seed: np.ndarray | None = None  # first sample ever seen, per node

    def _close(self, end_csum: np.ndarray, count: int) -> np.ndarray:
        if count > 0:
            mean = (end_csum - self._boundary) / np.maximum(count, 1)
            self._last_mean = mean
            self._has_mean = True
        elif self._has_mean:
            mean = self._last_mean
        else:
            mean = self._seed if self._seed is not None else np.zeros(self.b)
        self._next_window += 1
        self._boundary = end_csum
        self._count = 0
        return mean

    def push(self, times: np.ndarray, watts: np.ndarray) -> np.ndarray:
        """Fold a (k,)/(B, k) sample chunk in; return (B, j) closed means."""
        times = np.asarray(times, np.float64)
        watts = np.asarray(watts, np.float64)
        k = times.size
        if k == 0:
            return np.empty((self.b, 0))
        if self._seed is None:
            self._seed = watts[:, 0].copy()
        totals = np.cumsum(
            np.concatenate([self._carry[:, None], watts], axis=1), axis=1
        )[:, 1:]
        out = []
        p = 0
        while True:
            edge = (self._next_window + 1) * self.delta
            q = int(np.searchsorted(times, edge, side="left"))
            if q >= k:
                break
            end_csum = totals[:, q - 1] if q > 0 else self._carry
            out.append(self._close(end_csum, self._count + (q - p)))
            p = q
        self._count += k - p
        self._carry = totals[:, -1]
        if not out:
            return np.empty((self.b, 0))
        return np.stack(out, axis=1)

    def flush(self, num_windows: int) -> np.ndarray:
        """Close every window up to ``num_windows`` (end of segment)."""
        out = []
        while self._next_window < num_windows:
            out.append(self._close(self._carry, self._count))
        if not out:
            return np.empty((self.b, 0))
        return np.stack(out, axis=1)

    def flush_row(self, i: int, num_windows: int) -> np.ndarray:
        """Node ``i``'s remaining window means, without mutating fleet state.

        Used when one ragged node's segment ends while the rest of the fleet
        streams on: the node's tail windows close exactly as its own flush
        would, but the shared clock keeps running for the others.
        """
        out = []
        nxt, cnt = self._next_window, self._count
        carry, boundary = float(self._carry[i]), float(self._boundary[i])
        last = float(self._last_mean[i]) if self._has_mean else None
        seed = float(self._seed[i]) if self._seed is not None else 0.0
        while nxt < num_windows:
            if cnt > 0:
                mean = (carry - boundary) / max(cnt, 1)
                last = mean
            elif last is not None:
                mean = last
            else:
                mean = seed
            out.append(mean)
            boundary = carry
            cnt = 0
            nxt += 1
        return np.asarray(out, np.float64)
