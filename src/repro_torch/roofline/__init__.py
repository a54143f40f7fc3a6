"""Roofline analysis of the LM's mesh steps and SOCCER's round on the
H100 (``hw``, ``op_stats``, ``analysis``)."""
