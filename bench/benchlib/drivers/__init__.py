"""One driver a kind of configuration (``"kind"`` in its file): it builds
the system under test from the benchmark's inputs, warms up, runs the
measured window, and checks the sampled outputs against the plain
reference once the window has closed."""
