"""Device meshes for the sharded index (port of the parts of
``repro.distributed`` that ``core.distributed`` uses)."""
