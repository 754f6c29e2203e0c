"""PyTorch/CUDA port of the HiNM sparsity + serving package (`repro`).

Module paths mirror `src/repro/` one to one, so each port module names the
reference it answers to.  The port imports neither `jax` nor `repro`;
weights cross between the two packages as numpy arrays
(`repro_torch.convert.params_from_numpy`).
"""
