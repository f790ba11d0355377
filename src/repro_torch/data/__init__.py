"""Synthetic datasets and the split/binning pipeline (numpy only; copies of
``repro.data.synth`` and ``repro.data.pipeline``)."""
