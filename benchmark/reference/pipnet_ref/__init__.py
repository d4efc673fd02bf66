"""A frozen copy of the PyTorch port's plain path, cut to what the
benchmark's cells run: the eager ConvNeXt-tiny-26, the prototype head's
plain composition, the loss catalog, clipping and AdamW, the train step's
glue and the device augmentation, as the port held them when the benchmark
was written.  It imports nothing of the port and runs no hand-written
kernel, so later changes to the port are judged against it.  An option that
no cell uses (another backbone, a head variant, the fused kernels, the
mesh, BYOL, the OOD losses, the CARS augmentation) raises instead of
running."""
