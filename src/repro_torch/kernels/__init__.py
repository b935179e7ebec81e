"""Hand-written CUDA kernels for Hopper, each beside its plain version.

  gee_scatter        csrc/gee_scatter.cu   (fit / refit / refine)
  topk_fused         csrc/query_fused.cu   (shard top-k)
  gee_delta_renorm   csrc/query_fused.cu   (shard delta + Zn refresh)
  flash_attention    csrc/flash_attention.cu  (LM prefill; training forward)
  flash_attention_bwd  csrc/flash_attention.cu  (training backward)

`_build` compiles ``csrc/*.cu`` with nvcc at first use and counts each
wrapper's launches (`_build.launches`).
"""
