"""repro_torch.runtime — the runtime helpers the port's server uses
(``straggler.StepWatchdog``)."""
