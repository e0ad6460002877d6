"""The benchmark's own code: cells, traffic, trace reduction, the
yardstick's arithmetic and the comparison that decides `correct`.

Nothing here imports the JAX package or JAX; the program under test is
`repro_torch`, reached only from the runners (`perfbench/runners/`).
"""
