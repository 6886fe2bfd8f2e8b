"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``moments`` (CMF masked moments), ``loo`` (CMF LOOCV alpha
sweep) and ``trunk_fuse`` (GoogLeNet trunk segments of the exact dense
CNN). Sources are in ``csrc/``; ``build`` compiles and binds them."""
