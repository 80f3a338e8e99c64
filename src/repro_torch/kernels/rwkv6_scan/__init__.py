"""The RWKV6 WKV chunked scan (CUDA C++ for sm_90a), its plain PyTorch
versions (``ref``) and its wrapper (``ops``)."""
