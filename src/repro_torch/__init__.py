"""PyTorch/CUDA port of the FourierPIM transform service.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``kernels``, ``core.fft``, ``launch``) so each module's counterpart is
easy to find. It never imports ``jax`` or ``repro``. Every kernel on the
serve path is a hand-written CUDA C++ kernel for Hopper
(``kernels/csrc/stockham.cu``) with a plain PyTorch version beside it; the
plain version runs only for tensors that lie on the CPU.
"""
