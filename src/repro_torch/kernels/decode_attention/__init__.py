"""One-token decode attention over a KV cache (CUDA C++ for sm_90a), its
plain PyTorch version (``ref``) and its wrapper (``ops``)."""
