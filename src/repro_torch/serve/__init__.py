"""Serving of the port's models: prefill, decode and generation
(``repro_torch.serve.engine``)."""
