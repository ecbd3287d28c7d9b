"""repro_torch: the Compute RAM block simulator on PyTorch and CUDA.

The counterpart of the ``repro`` (JAX) package, module for module under
the same paths.  Entry points run on the GPU unless the caller passes
``device="cpu"``; the packed compiled executor's lane fold is a CUDA
kernel (``kernels/csrc/lane_fold.cu``).
"""
