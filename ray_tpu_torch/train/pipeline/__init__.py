"""ray_tpu_torch.train.pipeline: MPMD pipeline-parallel training (port of
``ray_tpu/train/pipeline``).

Stages of a model (cut by ``models.pp``) run as long-lived actor gangs; a
1F1B microbatch schedule hands activations and gradients between them over
persistent channels or through the object store; stage actors carry their
parameters and optimizer state through the drain's ``__rt_checkpoint__``/
``__rt_restore__`` hooks, so a preempted stage host costs one pipeline
bubble, not a restart (JaxPP's shape, arxiv 2412.14374; survival per arxiv
2510.20171).

The names below load on first use: ``schedule`` is pure Python, and
importing this package loads no torch until a name that needs it is read.
"""

_EXPORTS = {
    "LocalPipelineRunner": "driver",
    "PipelineConfig": "driver",
    "PipelineTrainer": "driver",
    "init_pp_params": "driver",
    "synthetic_batches": "driver",
    "StagePrograms": "partition",
    "make_optimizer": "partition",
    "bubble_micro_ops": "schedule",
    "stage_ops": "schedule",
    "submission_order": "schedule",
    "PipelineStageActor": "stage",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
