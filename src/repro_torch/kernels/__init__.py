"""Kernels of the port: a hand-written CUDA kernel and its plain PyTorch
version for every TPU kernel on the serving path. ``ops`` routes by the
device of the tensors it is given."""
