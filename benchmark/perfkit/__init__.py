"""The benchmark's own library: finding a cell's files by name, the
seeded traffic generator, the weights, the operation and byte counts,
the trace reader and the drivers that run a cell.

Nothing here imports JAX or the JAX package; the port
(``nbdistributed_tpu_torch``) is imported only inside the drivers, as
the system under test.
"""
