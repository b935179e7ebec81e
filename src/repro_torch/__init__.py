"""repro_torch — the GEE embed -> delta -> top-k path and the LM serve
path (prefill + greedy decode, dense decoder) in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `repro`, module for module and name for name
(`repro_torch.encoder.Embedder` is `repro.encoder.Embedder`'s
counterpart).  It imports torch and numpy only, never jax and nothing
of `repro`: what it needs from there it keeps as its own copy.

Entry points take an explicit `device` and default to "cuda"; asking
for the default without a card raises instead of quietly running on
the CPU.  On CPU tensors every kernel wrapper runs its plain PyTorch
version; on CUDA tensors it launches its kernel or raises.

    from repro_torch.encoder import Embedder, EncoderConfig
    emb = Embedder(EncoderConfig(K=16), backend="cuda").fit(graph, Y)

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    cfg = get_config("yi-6b")
    tokens = generate(cfg, M.init_params(cfg, 0), prompts, 16)
"""
