"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute layers.

A package of its own beside ``ray_tpu``, which stays the reference: it
imports torch and numpy, never jax and nothing of ``ray_tpu``.  Models live
in ``ray_tpu_torch.models``, attention ops and their CUDA kernels in
``ray_tpu_torch.ops`` (sources under ``csrc/``, built with nvcc on first use,
never at import), the training step in ``ray_tpu_torch.parallel``, the
continuous-batching LLM engine in ``ray_tpu_torch.serve``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
