"""repro_torch.runtime — the runtime helpers of the port's server and
trainer: ``straggler.StepWatchdog`` and ``compression`` (int8 gradient
all-reduce with error feedback)."""
