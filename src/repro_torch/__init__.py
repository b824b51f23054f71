"""PyTorch/CUDA port of the pattern-decomposition counting system.

A second package beside ``repro`` (the JAX reference).  It imports
``torch`` and never ``jax`` or anything of ``repro``: backend-neutral
modules are carried over as copies, so the port stands alone.  Modules
mirror the reference's directory and module names.

Entry point: ``repro_torch.compiler.compile(patterns, graph)`` ->
``CompiledPlan.count(p)``.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"`` (see ``repro_torch.device``).
"""
