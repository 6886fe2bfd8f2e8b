"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``moments`` (CMF masked moments) and ``loo`` (CMF LOOCV alpha
sweep). Sources are in ``csrc/``; ``build`` compiles and binds them."""
