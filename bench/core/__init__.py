"""The benchmark's harness: resolves a cell of ``BENCHMARK.json`` to its
configuration, traffic and metric files, and runs it."""
