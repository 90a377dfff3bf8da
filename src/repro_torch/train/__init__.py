"""Training (port of ``repro.train``): AdamW (``optimizer``), the train
steps (``train_step``), atomic checkpoints in the reference's on-disk
format (``checkpoint``), the fault-tolerant loop (``trainer``) and int8
gradient compression (``grad_compress``)."""
