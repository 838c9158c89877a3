"""Kernels of the port (counterpart of ``repro.kernels``): hand-written
CUDA kernels for Hopper (``csrc/``, bound in ``aip_step.py``), their
plain PyTorch versions (``ref.py``) and the dispatch (``ops.py``)."""
