"""The fused eq. (1) value-and-gradient kernel (CUDA C++ for sm_90a), its
plain PyTorch version (``ref``) and its wrappers (``ops``)."""
