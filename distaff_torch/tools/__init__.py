"""Measurement tools of the port: kernel timing on the card and the kernel
microbenchmark (`python -m distaff_torch.tools.kernel_bench`)."""
