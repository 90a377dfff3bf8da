"""Data-series generation (port of ``repro.data``)."""
