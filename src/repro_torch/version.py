"""The port's version, the same as the reference package's."""

__version__ = "1.0.0"
