"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``flash_attention`` (online-softmax attention forward and its
blockwise backward), ``similarity_topk`` (fused similarity→top-k over a
class matrix), ``contrastive_loss`` (row/column LSE of X·Yᵀ/τ and the
loss's dX, dY, dlog_tau, fused and as the legacy 4-pass pair),
``decode_attention`` (split-K single-token GQA attention over a KV cache)
and ``ssd_scan`` (the Mamba-2 SSD chunked scan)."""
