"""The paper's own experiments on the port.

``paper_figs``: the figure runs of ``benchmarks/paper_figs.py`` (figs
2-7 and ``beyond_yogi``) through the per-round API, on the card unless
the caller passes ``device="cpu"``. ``examples/paper_experiment_torch.py``
drives them and checks the paper's orderings.
"""
