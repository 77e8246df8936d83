"""Cost analysis of the port's steps: the torch counterpart of
``repro/analysis`` (``op_cost`` for ``hlo_cost``, ``roofline``,
``reanalyze``, ``report``)."""
