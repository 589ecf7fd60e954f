"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``flash_attention`` (online-softmax attention forward) and
``similarity_topk`` (fused similarity→top-k over a class matrix)."""
