"""repro_torch.launch — entry points (``serve``)."""
