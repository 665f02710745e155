"""The sort library: planner, sim backend and the paper's six steps."""
