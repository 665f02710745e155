"""The sort library: planner, the sim backend and the paper's six steps
(the stream backend is ``repro_torch.stream``)."""
