"""The LM substrate's models (port of ``repro.models``): the shared blocks
(``common``), MoE, Griffin and xLSTM blocks, the block-pattern stack
(``transformer``), the registry and the carrying-across of the
reference's parameters and caches (``weights``)."""
