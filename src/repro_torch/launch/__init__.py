"""Launch drivers: `serve` (LM prefill + greedy decode)."""
