"""PyTorch/CUDA port of the BASIC reproduction (the JAX package ``repro``
is the reference).

The package mirrors ``repro``'s layout module for module, so each port
module sits at the same relative path as its counterpart. It imports
``torch`` and never ``jax``, and nothing from ``repro``: what it needs from
the reference's framework-free modules (configs, tokenizer, synthetic data,
metrics, tracing) it keeps as its own copy.

Three paths are ported: zero-shot serving of the BASIC dual encoders
(``launch/serve_zeroshot.py``), single-device contrastive training
(``launch/train.py --mode contrastive``) and text-decode serving of the
dense LMs, lockstep and continuous batching (``launch/serve.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve_device``). The hand-written Hopper kernels
live under ``repro_torch.kernels``; on CPU tensors their wrappers run the
plain PyTorch version beside each kernel.
"""
