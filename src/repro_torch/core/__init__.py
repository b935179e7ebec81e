"""GEE math in PyTorch (`gee`) and its host oracles (`ref_python`)."""
