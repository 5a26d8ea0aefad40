"""Launchers and the machine model: the training launcher
(``python -m repro_torch.launch.train``) and the model-level roofline
(:mod:`.roofline`) on an H100.

Port of ``repro.launch`` where it applies to one card.  The reference's
``dryrun``, ``lowering``, ``roofline_sweep`` and ``mesh`` modules lower
and sweep XLA programs over TPU pod meshes and have no counterpart here
(ROADMAP Queue 1 items 10 and 11d)."""
