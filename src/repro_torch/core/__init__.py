"""Index construction, device layout and search (port of ``repro.core``)."""
