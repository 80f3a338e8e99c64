"""Causal grouped-query flash attention (CUDA C++ for sm_90a), its plain
PyTorch version (``ref``) and its wrapper (``ops``)."""
