"""Training substrate: optimizer, loop, checkpoints, fault tolerance
(the port of `repro.training`, on one device: no mesh, no shardings)."""
