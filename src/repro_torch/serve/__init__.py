"""repro_torch.serve — the LM serving loop (``serving``: fixed slots,
continuous batching).  The aggregate-serving layer waits for ROADMAP A9."""
