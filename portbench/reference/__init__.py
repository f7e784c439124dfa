"""The plain reference of the benchmark's cells: DCGAN-64's G and D, the
non-saturating BCE losses, Adam and the step's draws, in plain PyTorch and
numpy at fp32.  It imports nothing of ``tpugan_torch`` (nor JAX, nor the
JAX package) and takes nothing the program made: the benchmark hands it
the weights and the dataset it made itself, and it works the step's draws
out again from the seed."""
