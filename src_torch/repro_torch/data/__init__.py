"""Datasets: the paper's §5 simulation (:mod:`repro_torch.data.synthetic`)."""
