"""The plain references the cells' outputs are checked against: PyTorch
or NumPy only, importing nothing of ``repro_torch``, ``repro`` or JAX,
and taking nothing the program made (each works its inputs out again
from the run's seed)."""
