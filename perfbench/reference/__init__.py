"""The plain reference: what a quantification of the benchmark's inputs
must give, worked out again from the generated records and the seed.

NumPy and plain PyTorch only. Nothing here imports `jax`, the JAX package
or anything of the program under test, and nothing here reads what the
program made: the records come from the generator (`<bam>.npz`), the
filters, the EM, each bootstrap replicate's multinomial draw and the
per-cell EMs are computed here.
"""
