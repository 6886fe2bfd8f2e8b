"""Device milliseconds per flightline of the CMF's eigensolves: the
cuSOLVER kernels ``torch.linalg.eigh`` runs for a batch of 72 x 72
matrices (batched Jacobi sweeps, their rotations and ordering), over the
flightlines of the window."""

EIGH_KERNELS = r"syev|rotate_batch|offA_stage|syevj_parallel_order"


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.matching_s(EIGH_KERNELS)
    return s * 1e3 / run.units if s > 0 else None
