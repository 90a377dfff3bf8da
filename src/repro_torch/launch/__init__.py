"""Entry points of the LM substrate (port of ``repro.launch``): the
training driver (``train``), the serving driver with the kNN-softmax head
(``serve``), device meshes (``mesh``) and the dry-run table printer
(``summarize``)."""
