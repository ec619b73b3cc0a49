"""Measurement probes of the card: the launch floor and the scatter floor.

Counterparts of the JAX package's TPU probes under ``benchmarks/``
(``pallas_histogram.py``, ``probe_pallas_floor.py``,
``probe_pallas_floor2.py``, ``probe_fused_hist.py``,
``probe_fused_hist2.py``): ``kernels`` holds the four CUDA kernels beside
their plain versions, ``floor`` asks what one launch costs (eager against
a CUDA graph), ``hist`` what a scatter costs at the stat-landing shape.
Run ``python3 -m sentinel_tpu_torch.probes.floor`` or ``...probes.hist``
on a machine with a CUDA card.
"""
