"""Datasets: the paper's §5 simulation (:mod:`repro_torch.data.synthetic`)
and the App. H real-data surrogates (:mod:`repro_torch.data.realworld`)."""
