"""Device kernels a train step launches: all kernels of the traced window
over the steps it completed. A CUDA graph or a fusion moves it."""


def read(w):
    return len(w.kernels) / w.steps if w.steps and w.kernels else None
