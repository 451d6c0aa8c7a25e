"""PyTorch + CUDA port of the llm-d serving engine, for one NVIDIA H100.

The package mirrors ``llm_d_tpu``'s module names so each counterpart is
easy to find, but shares no code with it: it imports ``torch`` and never
``jax``.  Every TPU Pallas kernel on the ported path is a CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` on first use (``ops/_build.py``);
each kernel's module also holds a plain PyTorch version of the same
function, which runs for CPU tensors and is what the kernels are held to.
"""

__version__ = "0.1.0"
