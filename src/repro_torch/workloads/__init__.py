"""repro_torch.workloads — the TPC-H cursor loops the port runs end to end."""
