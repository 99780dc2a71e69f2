"""kbench: the benchmark of kaarme_tpu_torch (``python3 kbench/run.py``)."""
