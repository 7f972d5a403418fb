"""Runtime helpers of the port: offline analysis of exported engine traces
(:mod:`.trace_analysis`) and the train-loop fault primitives' shim
(:mod:`.fault`, over :mod:`repro_torch.reliability`)."""
