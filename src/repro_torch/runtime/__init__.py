"""repro_torch.runtime — the runtime helpers of the port's server and
trainer: ``straggler.StepWatchdog``, ``compression`` (int8 gradient
all-reduce with error feedback) and ``sharding`` (the mesh rules:
``param_specs``, ``batch_specs``, ``shard_act``) — and ``op_cost``, the
dry-run's loop-aware op counter."""
