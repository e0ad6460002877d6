"""Plain references of the benchmark's configurations, in torch and
numpy alone. They import neither JAX, nor the JAX package, nor anything
of the program (`repro_torch`), and take nothing the program made: each
works out from the benchmark's inputs what the program derives (the hot
set, the routing, the owners' shards do not exist here: one whole table
and one plain step)."""
