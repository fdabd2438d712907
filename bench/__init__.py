"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One run measures one cell of ``BENCHMARK.json``; ``bench/run.py`` is the
command.  Everything that belongs to one configuration, traffic mix,
per-layer metric or cell sits in a file of its own, found by the name in
the manifest (``bench/README.md``).
"""
