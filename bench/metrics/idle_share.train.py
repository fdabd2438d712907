"""Device: the percent of the untraced training window with no device
operation running (``readers.idle``)."""

from bench import readers


def read(window):
    return readers.idle(window)
