"""10-architecture model zoo (dense / GQA / SWA / MoE / Mamba /
RG-LRU / enc-dec) with storage-mode quantization, on PyTorch."""
