"""PyTorch/CUDA port of the ``repro`` serving path for one NVIDIA H100.

The JAX package (``src/repro``) is the reference and stays untouched; this
package imports neither it nor JAX. Module names follow ``src/repro`` so each
module's counterpart is easy to find. Entry points run on ``"cuda"`` unless a
caller passes ``device="cpu"``; the hand-written kernels run on CUDA tensors
and their plain PyTorch versions on CPU tensors (``kernels/ops.py``).
"""
