"""The paper's competitor indexes (port of ``repro.core.baselines``): the
brute-force ground truth, iSAX2+ and TARDIS, whose builders return a
:class:`~repro_torch.core.index.DumpyIndex` so every search path, host and
device, runs on them unchanged, and DSTree with its own host search."""
