"""PyTorch/CUDA port of ``tensorflow_distributed_tpu`` for NVIDIA Hopper
GPUs.

The JAX package stays the reference this port is held against; nothing
here imports JAX or the JAX package. It covers GPT-2-style causal-LM
training on one GPU (``python -m tensorflow_distributed_tpu_torch.cli
--mode train --model gpt_lm``), with attention on hand-written CUDA
flash-attention kernels (``ops/csrc/flash_attention.cu``) and, with
``--ce-chunk``, the head and loss fused into hand-written CUDA kernels
(``ops/csrc/fused_ce.cu``).
"""
