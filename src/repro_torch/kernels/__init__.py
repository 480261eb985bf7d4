"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its plain
PyTorch version (``ref.py``) and a dispatching entry (``ops.py``): CPU
tensors take the plain version, CUDA tensors the kernel."""
