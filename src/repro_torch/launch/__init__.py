"""Launch drivers: `serve` (LM prefill + greedy decode) and `train`
(the LM training loop)."""
