"""Serving engine (``serving/engine.py``): the host's milliseconds an
invocation, the untraced window's wall time an invocation (one client in a
closed loop: one call after another) less the device's busy time an
invocation in the traced slice."""


def read(window):
    if not window.device:
        return None
    return 1e3 * (1.0 / window.rate - window.busy_per_unit)
