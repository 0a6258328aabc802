"""Device milliseconds a guided sampling step spends in matrix products
(cuBLAS and CUTLASS kernels, by name). A pattern that matches no kernel raises: the
names have changed, and the metric would read a false 0."""

GEMM = r"gemm|nvjet|xmma|cutlass|gemv|splitKreduce|cublas"


def read(w):
    if not w.kernels:
        return None
    if w.kernel_count(GEMM) == 0:
        names = sorted({n for n, *_ in w.kernels})[:20]
        raise RuntimeError(f"no kernel matches {GEMM!r}; kernel names: {names}")
    return w.kernel_s(GEMM) * 1e3 / w.steps
