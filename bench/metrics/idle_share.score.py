"""Device: the percent of the untraced scoring window with no device
operation running (``readers.idle``)."""

from bench import readers


def read(window):
    return readers.idle(window)
