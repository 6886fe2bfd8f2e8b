"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``moments`` (CMF masked moments), ``loo`` (CMF LOOCV alpha
sweep), ``eigh`` (the CMF's batched symmetric eigensolve),
``trunk_fuse`` (GoogLeNet trunk segments of the exact dense CNN) and
``morph`` (the spectrometer masks' disk and diamond dilations).
Sources are in ``csrc/``; ``build`` compiles and binds them."""
