"""Launch drivers: `serve` (LM prefill + greedy decode), `train` (the LM
training loop), and the kernel tuning tools: `roofline` (the H100's
hardware model), `autotune` and `hillclimb` (its CLI)."""
