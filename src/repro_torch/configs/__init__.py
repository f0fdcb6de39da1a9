"""repro_torch.configs — environment switches (``flags``)."""
