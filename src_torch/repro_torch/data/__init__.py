"""Datasets: the paper's §5 simulation (:mod:`repro_torch.data.synthetic`),
the App. H real-data surrogates (:mod:`repro_torch.data.realworld`) and
the synthetic LM token stream (:mod:`repro_torch.data.tokens`)."""
