"""The plain reference the benchmark judges the port by.

Plain PyTorch in float64, written from Gadget-2's equations.  It imports
nothing of the port (`ngravs_tpu_torch`), nothing of the JAX package and
no kernel: it works the forces, the SPH sums and the integrator's factors
out again from the inputs and the state the benchmark hands it.
"""
