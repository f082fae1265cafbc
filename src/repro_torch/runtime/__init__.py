"""repro_torch.runtime — the runtime helpers of the port's server and
trainer: ``straggler.StepWatchdog`` and ``compression`` (int8 gradient
all-reduce with error feedback) — and ``op_cost``, the dry-run's
loop-aware op counter."""
